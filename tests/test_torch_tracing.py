"""The program's spans and counters (glz_tpu_torch/utils/timer.py) on the
front door's paths, on the CPU: which spans a call records, under which
parent and root, what host_copy_bytes counts, and that recording changes
no output."""

import struct

import numpy as np
import pytest

import glz_tpu_torch as gt
from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import api, container
from glz_tpu_torch.utils import timer
from tests.torch_threads import one_torch_thread  # noqa: F401

# 64-symbol streams in 8-row groups: 65,536 symbols a group
LOCKSTEP = cfg.GlzConfig(stream_symbols=64, layout=cfg.LAYOUT_LOCKSTEP, group_rows=8)
GROUP = 8 * 128 * 64
COMPRESS_STEPS = {"histogram", "codebook", "tables", "pad", "h2d", "encode", "sync.layout",
                  "sync.cursor", "d2h", "container.write"}
DECOMPRESS_STEPS = {"container.read", "codebook", "tables", "serialize", "h2d", "decode",
                    "d2h"}


def corpus(n: int, seed: int = 7) -> bytes:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, n, dtype=np.uint8) & rng.integers(0, 256, n, dtype=np.uint8)
            ).tobytes()


def tree(spans):
    """{name: [records]} and {id: record}."""
    by_name: dict = {}
    for r in spans:
        by_name.setdefault(r.name, []).append(r)
    return by_name, {r.id: r for r in spans}


def copied(spans) -> int:
    return sum(r.counts.get(timer.HOST_COPY_BYTES, 0) for r in spans)


@pytest.fixture(scope="module")
def round_trip():
    data = corpus(3 * GROUP - 999)  # three groups, the last one short
    with timer.recording() as spans:
        blob = gt.compress(data, conf=LOCKSTEP, device="cpu")
        out = gt.decompress(blob, device="cpu")
    return data, blob, out, spans


def test_a_lockstep_round_trip_records_each_step_under_its_root(round_trip):
    data, blob, out, spans = round_trip
    assert out == data
    by_name, by_id = tree(spans)
    roots = {name: by_name[name] for name in ("compress", "decompress")}
    assert all(len(r) == 1 and r[0].parent is None for r in roots.values())
    for direction, steps in (("compress", COMPRESS_STEPS), ("decompress", DECOMPRESS_STEPS)):
        root = roots[direction][0]
        mine = [r for r in spans if r.root == root.id and r is not root]
        assert {r.name for r in mine} == steps
        for r in mine:
            want = "encode" if r.name.startswith("sync.") else direction
            assert by_id[r.parent].name == want, r
            assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
    # the decompress reads the container once, at the front door
    assert len(by_name["container.read"]) == 1
    assert len({r.thread for r in spans}) == 1


def test_host_copy_bytes_is_what_the_sizes_give(round_trip):
    data, blob, _, spans = round_trip
    n_groups, _, cb_size = struct.unpack_from("<III", blob, 16)
    start = container.HEADER_SIZE + cb_size + 4 * n_groups
    payload = len(blob) - start
    assert cb_size == 129 and start % 4  # the payload's words lie unaligned in the blob
    roots = {r.name: r.id for r in spans if r.parent is None}
    mine = {d: [r for r in spans if r.root == roots[d]] for d in roots}
    # compress: the input's copy into the (CPU) device buffer, the container
    assert copied(mine["compress"]) == len(data) + len(blob)
    # decompress: one read of the codebook alone, the payload's copy into
    # the (CPU) device buffer, the output's bytes
    assert copied(mine["decompress"]) == cb_size + payload + len(data)
    by_name, _ = tree(spans)
    h2d = {d: [r.counts for r in by_name["h2d"] if r.root == roots[d]] for d in roots}
    assert h2d["compress"] == [{timer.HOST_COPY_BYTES: len(data)}]
    assert h2d["decompress"] == [{timer.HOST_COPY_BYTES: payload}]
    # on the card the h2d spans copy nothing on the host: each byte once a call
    assert copied([r for r in mine["compress"] if r.name != "h2d"]) == len(blob)
    assert copied([r for r in mine["decompress"] if r.name != "h2d"]) == cb_size + len(data)
    assert all(r.counts == {} for r in by_name["pad"] + by_name["encode"] + by_name["decode"])
    # the parse's payload is a view of the blob, not a copy
    f = container.read_container(blob)
    assert np.shares_memory(np.frombuffer(f.payload, np.uint8), np.frombuffer(blob, np.uint8))
    assert f.payload.readonly and len(f.payload) == payload


def test_a_checksum_is_a_verify_span_each_way():
    data = corpus(GROUP // 2, seed=3)
    conf = cfg.GlzConfig(stream_symbols=64, layout=cfg.LAYOUT_LOCKSTEP, group_rows=8,
                         checksum=True)
    with timer.recording() as spans:
        assert gt.decompress(gt.compress(data, conf=conf, device="cpu"), device="cpu") == data
    verify = [r for r in spans if r.name == "verify"]
    roots = {r.id: r.name for r in spans if r.parent is None}
    assert sorted(roots[r.root] for r in verify) == ["compress", "decompress"]
    assert sorted(copied([r]) for r in verify) == [0, 0]  # the crc, on the caller's buffer


def test_the_batch_spans_take_the_batch_as_parent_across_threads():
    datas = [corpus(5000 + 1000 * k, seed=k) for k in range(4)]
    with timer.recording() as spans:
        blobs = api.compress_batch(datas, conf=LOCKSTEP, pipeline=True, device="cpu")
        outs = api.decompress_batch(blobs, pipeline=True, device="cpu")
    assert outs == datas
    by_name, by_id = tree(spans)
    for direction in ("compress", "decompress"):
        batch, = by_name[direction + "_batch"]
        assert batch.parent is None
        for name in ("batch.wait", "batch.file"):
            mine = [r for r in by_name[name] if r.root == batch.id]
            assert len(mine) == len(datas) and {r.parent for r in mine} == {batch.id}
            assert all(r.thread != batch.thread for r in mine)
        files = [r for r in by_name["batch.file"] if r.root == batch.id]
        calls = [r for r in by_name[direction] if r.root == batch.id]
        assert len(calls) == len(datas)
        assert {by_id[r.parent].name for r in calls} == {"batch.file"}
        assert all(batch.start_ns <= r.start_ns <= r.end_ns <= batch.end_ns for r in files)
        waits = [r for r in by_name["batch.wait"] if r.root == batch.id]
        assert len({r.start_ns for r in waits}) == 1  # every file submitted at once


def test_the_serial_batch_has_a_file_span_a_file():
    datas = [corpus(3000, seed=k) for k in range(2)]
    with timer.recording() as spans:
        api.compress_batch(datas, conf=LOCKSTEP, pipeline=False, device="cpu")
    by_name, _ = tree(spans)
    batch, = by_name["compress_batch"]
    assert [r.parent for r in by_name["batch.file"]] == [batch.id, batch.id]
    assert "batch.wait" not in by_name


def test_a_huffword_round_trip_records_the_host_library_under_its_root():
    text = b"the cat-sat on its mat. " * 2000
    with timer.recording() as spans:
        blob = gt.compress(text, mode=cfg.MODE_HUFFWORD, conf=LOCKSTEP, device="cpu")
        assert gt.decompress(blob, device="cpu") == text
    by_name, by_id = tree(spans)
    roots = {r.name: r for r in spans if r.parent is None}
    assert set(roots) == {"compress", "decompress"}
    vocab = [r for r in by_name["vocab"] if by_id[r.parent].name == "compress"]
    assert len(vocab) == 1
    classes = [r for r in by_name["vocab"] if r.parent == vocab[0].id]
    assert len(classes) == 2 and all(r.thread != vocab[0].thread for r in classes)
    assert {by_id[r.parent].name for r in by_name["native.build_vocab"]} == {"vocab"}
    assert by_id[by_name["native.tokenize"][0].parent].name == "vocab"
    detok, = by_name["native.detokenize"]
    assert by_id[detok.parent].name == "detokenize"
    assert {r.root for r in by_name["detokenize"]} == {roots["decompress"].id}
    assert copied([detok]) == len(text)  # the output's copy, counted on the library's span
    assert not [r for r in spans if r.parent == detok.id]


@pytest.mark.parametrize("mode, conf", [(cfg.MODE_BYTE, LOCKSTEP), (cfg.MODE_BYTE, cfg.DEFAULT),
                                        (cfg.MODE_HUFFWORD, LOCKSTEP),
                                        (cfg.MODE_HUFFWORD, cfg.DEFAULT)],
                         ids=["byte-lockstep", "byte-bitstream", "huffword-lockstep",
                              "huffword-bitstream"])
def test_recording_changes_no_output(mode, conf):
    data = (b"the cat-sat on its mat. " * 999) if mode == cfg.MODE_HUFFWORD else corpus(70000)
    off = gt.compress(data, mode=mode, conf=conf, device="cpu")
    with timer.recording() as spans:
        on = gt.compress(data, mode=mode, conf=conf, device="cpu")
        back = gt.decompress(on, device="cpu")
    assert on == off and back == data == gt.decompress(off, device="cpu")
    assert {"compress", "decompress", "serialize", "d2h"} <= {r.name for r in spans}


@pytest.fixture(scope="module")
def default_round_trip():
    data = corpus(70001, seed=1)
    with timer.recording() as spans:
        blob = gt.compress(data, device="cpu")  # the DEFAULT preset: bitstream layout
        out = gt.decompress(blob, device="cpu")
    return data, blob, out, spans


def test_a_default_round_trip_records_bitio_inside_serialize(default_round_trip):
    data, blob, out, spans = default_round_trip
    assert out == data
    by_name, by_id = tree(spans)
    roots = {r.name: r for r in spans if r.parent is None}
    assert set(roots) == {"compress", "decompress"}
    for name, direction in (("bitio.words_to_bytes", "compress"),
                            ("bitio.bytes_to_words", "decompress")):
        r, = by_name[name]
        parent = by_id[r.parent]
        assert parent.name == "serialize" and r.root == roots[direction].id
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    bitio = {r.id for r in spans if r.name.startswith("bitio.")}
    assert not [r for r in spans if r.parent in bitio]  # innermost: they hold their counts


def test_bitio_counts_every_payload_sized_buffer_it_writes(default_round_trip):
    data, blob, _, spans = default_round_trip
    n_streams, S, cb_size = struct.unpack_from("<III", blob, 16)
    payload = len(blob) - container.HEADER_SIZE - cb_size - 4 * n_streams
    words = -(-payload // 4)  # the stream's u32 words
    assert (n_streams, S) == (1, cfg.DEFAULT.stream_symbols) and payload % 4
    by_name, _ = tree(spans)
    # compress: the D2H'd words become the payload where they lie (no copy);
    # decompress: the payload converted into whole words, one buffer
    to_words = 4 * words
    assert [r.counts for r in by_name["bitio.words_to_bytes"]] == [{}]
    assert [r.counts for r in by_name["bitio.bytes_to_words"]] == [
        {timer.HOST_COPY_BYTES: to_words}]
    roots = {r.name: r.id for r in spans if r.parent is None}
    mine = {d: [r for r in spans if r.root == roots[d]] for d in roots}
    # compress: the input into the (CPU) device buffer, the container
    assert copied(mine["compress"]) == len(data) + len(blob)
    # decompress: one read of the codebook alone, bitio's copy, the words
    # into the (CPU) device buffer, the output's bytes
    assert copied(mine["decompress"]) == cb_size + to_words + 4 * words + len(data)
    serialize = [r for r in by_name["serialize"] if r.root == roots["compress"]]
    assert [r.counts for r in serialize] == [{}]  # one dispatch: no words joined


@pytest.mark.parametrize("mode, conf, backend", [
    (cfg.MODE_BYTE, LOCKSTEP, "host"), (cfg.MODE_BYTE, cfg.DEFAULT, "host"),
    (cfg.MODE_BYTE, cfg.DEFAULT, "device"), (cfg.MODE_HUFFWORD, LOCKSTEP, "host"),
    (cfg.MODE_HUFFWORD, cfg.DEFAULT, "host"), (cfg.MODE_NORMAL_TREE, cfg.DEFAULT, "host")],
    ids=["byte-lockstep", "byte-bitstream-host", "byte-bitstream-device", "huffword-lockstep",
         "huffword-bitstream", "normal-tree"])
def test_a_decompress_parses_its_container_once(monkeypatch, mode, conf, backend):
    """The front door parses the container and hands the models the
    GlzFile: one parse a call, whatever imports the parser."""
    data = (b"the cat-sat on its mat. " * 999) if mode == cfg.MODE_HUFFWORD else corpus(70000)
    blob = gt.compress(data, mode=mode, conf=conf, backend=backend, device="cpu")
    parsed = []
    parse = container._read_container

    def counted(b):
        parsed.append(len(b))
        return parse(b)

    monkeypatch.setattr(container, "_read_container", counted)
    with timer.recording() as spans:
        assert gt.decompress(blob, device="cpu") == data
    assert parsed == [len(blob)]
    reads = [r for r in spans if r.name == "container.read"]
    # HuffWord's codebook section is a second `container.read`: its dictionaries
    assert len(reads) == (2 if mode == cfg.MODE_HUFFWORD else 1)
