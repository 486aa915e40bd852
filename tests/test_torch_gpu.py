"""glz_tpu_torch's CUDA kernels against their plain PyTorch versions, and its
entry points, on the card.  Skipped where torch.cuda.is_available() is false; run on a machine
with a card (no JAX needed there) with

    GLZ_TEST_TPU=1 python -m pytest -m gpu tests/test_torch_gpu.py

(GLZ_TEST_TPU=1 keeps tests/conftest.py from importing JAX.)
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
import glz_tpu_torch
from glz_tpu_torch.core import container
from glz_tpu_torch.models import canonical_byte as port_model
from glz_tpu_torch.models import huffword as port_huffword
from glz_tpu_torch.models import transfer
from glz_tpu_torch.ops import _kernels
from glz_tpu_torch.utils import fill, timer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("case", list(chip_smoke.CASES))
def test_kernels_match_plain_versions(cuda, case):
    """K1, K2, K3 bit-exact against lane_totals_ref, encode_groups_ref and
    decode_groups_ref on the same inputs, and the decode round-trips."""
    chip_smoke.check_case(case, cuda)
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", list(chip_smoke.HUFFWORD_CASES))
def test_huffword_kernels_match_plain_versions(cuda, case):
    """K6 (both call sites), the entry-word lane totals, K4 and K5 bit-exact
    against their plain versions on the same inputs, and the tokens
    round-trip."""
    chip_smoke.check_huffword_case(case, cuda)
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", list(chip_smoke.K5_RANDOM_CASES))
def test_k5_on_random_words(cuda, case):
    """K5 against its plain version on random payload words at even S that
    is not a power of two, rows 8 and 64."""
    chip_smoke.check_k5_random(case, cuda)
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", list(chip_smoke.K4_CASES))
def test_k4_matches_plain_version(cuda, case):
    """K4 bit-exact against encode_entries_ref at rows 8, 16, 32 and 64 (each
    geometry its entry launches), on word text with a ragged token count and
    on single-symbol dictionaries."""
    chip_smoke.check_k4_case(case, cuda)
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", list(chip_smoke.K1_CASES))
def test_k1_matches_plain_version(cuda, case):
    """K1 bit-exact against lane_totals_ref at every S from 64 to 8192 with
    a ragged n_valid (garbage bytes past it), and with a depth-26 codebook."""
    chip_smoke.check_k1_case(case, cuda)
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", list(chip_smoke.BITSTREAM_CASES))
def test_bitstream_kernels_match_plain_versions(cuda, case):
    """K7, the pack (pack_scan, pack_tiles, from bit 0 and from a bit that
    is not a word boundary) and decode_streams bit-exact against their
    plain versions on the same inputs, two dispatches of either container,
    and the decode gives back the input."""
    chip_smoke.check_bitstream_case(case, cuda)
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", list(chip_smoke.HUFFWORD_BITSTREAM_CASES))
def test_huffword_bitstream_kernels_match_plain_versions(cuda, case):
    """K6 with the lj and the length tables, the pack and
    decode_streams_dual bit-exact against their plain versions, and the
    tokens round-trip."""
    chip_smoke.check_huffword_bitstream_case(case, cuda)
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", [*chip_smoke.BITSTREAM_CASES,
                                  *chip_smoke.HUFFWORD_BITSTREAM_CASES])
def test_strategy_kernels_match_plain_versions(cuda, case):
    """The bit-walk and fast kernels of the byte and dual stream decodes
    bit-exact against their plain versions, and the input (tokens) back."""
    chip_smoke.check_strategy_case(case, cuda)
    torch.cuda.synchronize()


def test_strategy_kernels_on_corrupt_streams(cuda):
    """Past the payload they read what their plain versions read; a code
    that matches nothing raises."""
    chip_smoke.check_corrupt_streams(cuda)


@pytest.mark.parametrize("variant", ["table", "fast", "bitwalk"])
def test_decompress_launches_the_routed_strategy(cuda, variant):
    """decompress(variant=v) of a byte and a HuffWord bitstream container
    launches v's stream decode and no other."""
    data = chip_smoke.make_corpus(3 << 20)
    text = chip_smoke.make_word_corpus(1 << 20)
    for blob, want, dual in (
            (glz_tpu_torch.compress(data), data.tobytes(), False),
            (glz_tpu_torch.compress(text, mode=glz_tpu_torch.config.MODE_HUFFWORD), text, True)):
        _kernels.reset_launch_counts()
        assert glz_tpu_torch.decompress(blob, variant=variant) == want
        counts = _kernels.launch_counts()
        decodes = {k: counts[k] for k in chip_smoke.STREAM_DECODES.values()}
        assert decodes == {**{k: 0 for k in decodes},
                           chip_smoke.STREAM_DECODES[(dual, variant)]: 1}


def test_entry_points_launch_each_kernel_once(cuda):
    data = chip_smoke.make_corpus(3 << 20)
    _kernels.reset_launch_counts()
    blob = glz_tpu_torch.compress(data, conf=glz_tpu_torch.config.THROUGHPUT)
    assert glz_tpu_torch.decompress(blob) == data.tobytes()
    counts = _kernels.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "lane_totals": 1, "encode_groups": 1,
                      "decode_groups": 1}


def test_huffword_entry_points_launch_each_kernel(cuda):
    text = chip_smoke.make_word_corpus(3 << 20)
    _kernels.reset_launch_counts()
    conf = chip_smoke.huffword_conf()
    blob = glz_tpu_torch.compress(text, mode=glz_tpu_torch.config.MODE_HUFFWORD, conf=conf)
    assert glz_tpu_torch.decompress(blob) == text
    counts = _kernels.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "lut_gather": 2, "lane_totals_entries": 1,
                      "encode_entries": 1, "decode_dual": 1}


def test_bitstream_entry_points_launch_each_kernel(cuda):
    """DEFAULT, either backend: one dispatch of K7 and the pack (its scan
    and its pack), one stream decode; HuffWord DEFAULT: K6 for the codes and
    the lengths, the pack, the dual decode and K6 for the ids."""
    conf = glz_tpu_torch.config.DEFAULT
    data = chip_smoke.make_corpus(3 << 20)
    for backend in ("host", "device"):
        _kernels.reset_launch_counts()
        blob = glz_tpu_torch.compress(data, backend=backend, conf=conf)
        assert glz_tpu_torch.decompress(blob) == data.tobytes()
        counts = _kernels.launch_counts()
        assert counts == {**{k: 0 for k in counts}, "lookup_lj_lens": 1, "pack_scan": 1,
                          "pack_tiles": 1, "decode_streams": 1}
    text = chip_smoke.make_word_corpus(3 << 20)
    _kernels.reset_launch_counts()
    blob = glz_tpu_torch.compress(text, mode=glz_tpu_torch.config.MODE_HUFFWORD, conf=conf)
    assert glz_tpu_torch.decompress(blob) == text
    counts = _kernels.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "lut_gather": 3, "pack_scan": 1, "pack_tiles": 1,
                      "decode_streams_dual": 1}


def test_device_trace_counts_port_kernels(cuda, tmp_path):
    """A traced byte lockstep round trip of 8 MiB: the trace holds as many
    events of each port kernel as its wrapper counted launches, and both
    idle shares lie in [0, 1]."""
    import json

    from glz_tpu_torch.utils.timer import device_trace

    data = chip_smoke.make_corpus(8 << 20)
    conf = glz_tpu_torch.config.THROUGHPUT
    glz_tpu_torch.decompress(glz_tpu_torch.compress(data[: 1 << 20], conf=conf))  # warm-up
    _kernels.reset_launch_counts()
    with device_trace(tmp_path) as trace:
        with torch.profiler.record_function("round_trip"):
            blob = glz_tpu_torch.compress(data, conf=conf)
            out = glz_tpu_torch.decompress(blob)
            torch.cuda.synchronize()
    assert out == data.tobytes()
    launches = {k: v for k, v in _kernels.launch_counts().items() if v}
    assert launches == {"lane_totals": 1, "encode_groups": 1, "decode_groups": 1}
    s = chip_smoke.trace_summary(json.loads(trace.file.read_text()), "round_trip")
    assert s["port_kernels"] == launches
    assert 0 <= s["device_idle"] <= s["kernel_idle"] <= 1
    assert 0 < s["kernel_ms"] <= s["device_ms"] <= s["window_ms"]


def test_pinned_digests_on_the_card(cuda, realtext):
    text = realtext[: 1 << 20]
    for key, conf in chip_smoke.pinned_configs().items():
        blob = glz_tpu_torch.compress(text, conf=conf)
        assert hashlib.sha256(blob).hexdigest() == chip_smoke.PINNED[key]
        assert glz_tpu_torch.decompress(blob) == text
    for key, conf in chip_smoke.huffword_pinned_configs().items():
        blob = glz_tpu_torch.compress(text, mode=glz_tpu_torch.config.MODE_HUFFWORD, conf=conf)
        assert hashlib.sha256(blob).hexdigest() == chip_smoke.HUFFWORD_PINNED[key]
        assert glz_tpu_torch.decompress(blob) == text
    for key, (conf, mode, backend) in chip_smoke.bitstream_pinned_configs().items():
        blob = glz_tpu_torch.compress(text, mode=mode, backend=backend, conf=conf)
        assert hashlib.sha256(blob).hexdigest() == chip_smoke.BITSTREAM_PINNED[key]
        assert glz_tpu_torch.decompress(blob) == text


def test_cpu_and_card_write_the_same_bytes(cuda, text_100kb):
    conf = dataclasses.replace(glz_tpu_torch.config.THROUGHPUT, group_rows=16,
                               stream_symbols=128, checksum=True)
    assert (glz_tpu_torch.compress(text_100kb, conf=conf)
            == glz_tpu_torch.compress(text_100kb, conf=conf, device="cpu"))
    hw = glz_tpu_torch.config.MODE_HUFFWORD
    assert (glz_tpu_torch.compress(text_100kb, mode=hw, conf=conf)
            == glz_tpu_torch.compress(text_100kb, mode=hw, conf=conf, device="cpu"))
    conf = dataclasses.replace(glz_tpu_torch.config.DEFAULT, stream_symbols=1001, checksum=True)
    for mode, backend in ((glz_tpu_torch.config.MODE_BYTE, "host"),
                          (glz_tpu_torch.config.MODE_BYTE, "device"), (hw, "host")):
        blob = glz_tpu_torch.compress(text_100kb, mode=mode, backend=backend, conf=conf)
        assert blob == glz_tpu_torch.compress(text_100kb, mode=mode, backend=backend,
                                              conf=conf, device="cpu")
        assert glz_tpu_torch.decompress(blob) == text_100kb


def test_host_layout_dispatches_on_the_card(cuda, text_1mb, monkeypatch):
    """The host container across dispatches of 2^17 symbols (each packed on
    the card from the bits before it) equals the one-dispatch container and
    the CPU's."""
    conf = dataclasses.replace(glz_tpu_torch.config.DEFAULT, stream_symbols=1 << 14)
    whole = glz_tpu_torch.compress(text_1mb, conf=conf)
    monkeypatch.setattr(port_model, "MAX_DISPATCH_SYMBOLS", 1 << 17)
    assert glz_tpu_torch.compress(text_1mb, conf=conf) == whole
    assert glz_tpu_torch.compress(text_1mb, conf=conf, device="cpu") == whole
    assert glz_tpu_torch.decompress(whole) == text_1mb


def test_huffword_shared_on_the_card(cuda, text_100kb, realtext):
    conf = chip_smoke.huffword_conf(64, 8)
    files = [text_100kb, realtext[:200_000], b""]
    blobs = glz_tpu_torch.compress_huffword_shared(files, conf)
    assert blobs == glz_tpu_torch.compress_huffword_shared(files, conf, device="cpu")
    assert [glz_tpu_torch.decompress(b) for b in blobs] == files
    conf = glz_tpu_torch.config.DEFAULT
    blobs = glz_tpu_torch.compress_huffword_shared(files, conf)
    assert blobs == glz_tpu_torch.compress_huffword_shared(files, conf, device="cpu")
    assert [glz_tpu_torch.decompress(b) for b in blobs] == files


@pytest.mark.parametrize("preset", ["THROUGHPUT", "DEFAULT"])
def test_pipelined_batch_on_the_card(cuda, text_100kb, realtext, preset):
    """Two files in flight on two threads write the serial loop's
    containers and the CPU's, and decode on the card either way."""
    conf = getattr(glz_tpu_torch.config, preset)
    files = [chip_smoke.make_corpus(3 << 20).tobytes(), text_100kb, b"",
             realtext[:300_000], chip_smoke.make_word_corpus(1 << 20)]
    blobs = glz_tpu_torch.compress_batch(files, conf=conf)
    assert blobs == glz_tpu_torch.compress_batch(files, conf=conf, pipeline=False)
    assert blobs == glz_tpu_torch.compress_batch(files, conf=conf, device="cpu")
    assert glz_tpu_torch.decompress_batch(blobs) == files
    assert glz_tpu_torch.decompress_batch(blobs, pipeline=False) == files


def test_lockstep_archive_on_the_card(cuda, text_100kb, realtext):
    """Byte and HuffWord lockstep archives round-trip on the card and equal
    the CPU's; the pinned archive and normal-tree digests hold."""
    files = [realtext[:200_000], text_100kb, realtext[200_000:260_000]]
    hw = glz_tpu_torch.config.MODE_HUFFWORD
    for mode, conf in ((glz_tpu_torch.config.MODE_BYTE, glz_tpu_torch.config.THROUGHPUT),
                       (hw, chip_smoke.huffword_conf(64, 8))):
        arc = glz_tpu_torch.compress_archive(files, mode=mode, conf=conf)
        assert arc == glz_tpu_torch.compress_archive(files, mode=mode, conf=conf, device="cpu")
        assert glz_tpu_torch.decompress_archive(arc) == files
    text = realtext[: 1 << 20]
    for key, (mode, conf) in chip_smoke.archive_pinned_configs().items():
        blob = (glz_tpu_torch.compress(text, mode=mode, conf=conf)
                if mode == glz_tpu_torch.config.MODE_NORMAL_TREE
                else glz_tpu_torch.compress_archive(chip_smoke.quarters(text), mode=mode,
                                                    conf=conf))
        assert hashlib.sha256(blob).hexdigest() == chip_smoke.ARCHIVE_PINNED[key], key


def test_cli_round_trips_on_the_card(cuda, tmp_path, monkeypatch):
    """The command line on the card (GLZ_PLATFORM unset): each of
    chip_smoke's phase 4f runs, on 3 MiB, writes the API's container for
    the same call, round-trips and launches its path's kernels."""
    monkeypatch.delenv("GLZ_PLATFORM", raising=False)
    arr = chip_smoke.make_corpus(3 << 20)
    text = chip_smoke.make_word_corpus(3 << 20)
    arr.tofile(tmp_path / "corpus.bin")
    (tmp_path / "text.txt").write_bytes(text)
    for name, (opts, (mode, backend, conf), kernels) in chip_smoke.cli_runs().items():
        hw = mode == glz_tpu_torch.config.MODE_HUFFWORD
        chip_smoke.cli_round_trip(
            tmp_path, name, tmp_path / ("text.txt" if hw else "corpus.bin"), opts,
            lambda: glz_tpu_torch.compress(text if hw else arr, mode=mode, backend=backend,
                                           conf=conf),
            kernels, torch.cuda.get_device_name(0))


@pytest.mark.parametrize("case", list(chip_smoke.HIST_CASES))
def test_histogram_matches_plain_version(cuda, case):
    """The histogram kernel against histogram_ref, torch.bincount and
    np.bincount on ragged lengths, an unaligned start, one byte value and
    uniform bytes."""
    chip_smoke.check_histogram_case(case, cuda)
    torch.cuda.synchronize()


def test_mesh_at_world_size_1(cuda):
    """A process group of one (NCCL): sharded_histogram, lockstep_codec_step
    (rows 8, S 64, a ragged second group) against lane_totals_ref's group
    table and the input, and codec_step, each launching its kernels."""
    import numpy as np
    import torch.distributed as dist

    from glz_tpu_torch.core.codebook import build_codebook
    from glz_tpu_torch.models.canonical_byte import decode_tables, entry_table
    from glz_tpu_torch.ops import lockstep_encode as ke
    from glz_tpu_torch.parallel import mesh as pmesh
    from glz_tpu_torch.parallel import ranks

    arr = chip_smoke.make_corpus(2 * 1024 * 64, seed=0x3E5)
    n_valid = arr.size - 4321
    cb = build_codebook(np.bincount(arr[:n_valid], minlength=256), ke.MAX_FUSED_LEN)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{ranks.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = pmesh.make_mesh(1)
        sym = torch.from_numpy(arr).to(cuda)
        _kernels.reset_launch_counts()
        h = pmesh.sharded_histogram(mesh, sym)
        assert np.array_equal(h.cpu().numpy(), np.bincount(arr, minlength=256))
        _, gw_all, out = pmesh.lockstep_codec_step(
            mesh, sym, n_valid, entry_table(cb, cuda), *decode_tables(cb, cuda), 64,
            cb.min_len, cb.max_len)
        assert np.array_equal(out.cpu().numpy(), arr[:n_valid])
        _, gw = ke.lane_totals_ref(sym.cpu(), entry_table(cb, torch.device("cpu")), n_valid,
                                   64, 8)
        assert torch.equal(gw_all.cpu(), gw)
        *_, out = pmesh.codec_step(mesh, sym, n_valid,
                                   transfer.i32_tensor(cb.left_justified_codes(), cuda),
                                   transfer.i32_tensor(cb.lengths, cuda), *decode_tables(cb, cuda),
                                   cb.min_len, cb.max_len, 4096)
        assert np.array_equal(out.cpu().numpy(), arr[:n_valid])
        counts = _kernels.launch_counts()
        assert all(counts[k] == 1 for k in ("histogram", "lane_totals", "encode_groups",
                                            "decode_groups", "lookup_lj_lens", "pack_tiles",
                                            "decode_streams"))
    finally:
        dist.destroy_process_group()


def _two_rank_lockstep(path: str):
    """A rank of test_two_process_lockstep_multihost: its half of the file
    under a lockstep conf, then its groups of the container."""
    import pathlib

    from glz_tpu_torch.parallel import multihost

    data = pathlib.Path(path).read_bytes()
    half = len(data) // 2 // (8 * 128 * 64) * (8 * 128 * 64)
    pid = multihost.process_index()
    conf = glz_tpu_torch.GlzConfig(stream_symbols=64, layout=glz_tpu_torch.config.LAYOUT_LOCKSTEP,
                                   checksum=True)
    blob = multihost.compress_bytes_multihost(data[:half] if pid == 0 else data[half:], conf)
    shared = pathlib.Path(path + ".glz")
    if pid == 0:
        shared.write_bytes(blob)
    multihost._allgather([0])
    local, off = multihost.decompress_bytes_multihost(shared.read_bytes())
    return blob, off, local, _kernels.launch_counts()


def test_two_process_lockstep_multihost(cuda, tmp_path):
    """Two processes sharing the card: the stitched lockstep container is
    compress_bytes_lockstep's with an exact histogram, decodes on the card,
    and the two processes' decoded slices reassemble the file."""
    from glz_tpu_torch.parallel import ranks

    arr = chip_smoke.make_corpus(3 * 8 * 128 * 64 + 999, seed=0x3E6)
    path = tmp_path / "in.bin"
    arr.tofile(path)
    got = ranks.run(f"{__file__}:_two_rank_lockstep", 2, str(path), timeout=300)
    blob = got[0][0]
    assert got[1][0] is None
    conf = glz_tpu_torch.GlzConfig(stream_symbols=64, layout=glz_tpu_torch.config.LAYOUT_LOCKSTEP,
                                   checksum=True, histogram_budget=None)
    assert blob == port_model.compress_bytes_lockstep(arr, conf)
    assert glz_tpu_torch.decompress(blob) == arr.tobytes()
    parts = sorted((off, local) for _, off, local, _ in got)
    assert parts[0][0] == 0 and parts[1][0] == len(parts[0][1])
    assert b"".join(p[1] for p in parts) == arr.tobytes()
    for *_, counts in got:
        assert counts["encode_groups"] and counts["decode_groups"]


def test_bench_on_the_card(cuda):
    """bench_torch.py at 16 MiB on the card (chip_smoke.py's phase 10 at a
    smaller size): exit 0, bench.py's keys, every value > 0, and each part's
    launch counts exactly its encodes and decodes times its kernels."""
    result, stderr, _ = chip_smoke.run_bench("bench_torch.py", GLZ_BENCH_MB="16")
    assert sorted(result) == sorted(chip_smoke.BENCH_KEYS)
    assert "device: " + torch.cuda.get_device_name(0) in stderr


# ---- payload-sized D2H into page-locked staging (transfer.host_array) ----

# name: (mode, conf, backend)
STAGED_PATHS = {
    "byte-lockstep": (glz_tpu_torch.config.MODE_BYTE, glz_tpu_torch.config.THROUGHPUT, "host"),
    "byte-bitstream-host": (glz_tpu_torch.config.MODE_BYTE, glz_tpu_torch.config.DEFAULT,
                            "host"),
    "byte-bitstream-device": (glz_tpu_torch.config.MODE_BYTE, glz_tpu_torch.config.DEFAULT,
                              "device"),
    "huffword-lockstep": (glz_tpu_torch.config.MODE_HUFFWORD, chip_smoke.huffword_conf(64, 8),
                          "host"),
    "huffword-bitstream": (glz_tpu_torch.config.MODE_HUFFWORD, glz_tpu_torch.config.DEFAULT,
                           "host"),
}


def _staged_input(mode, n: int = 3 << 20, seed: int = 0xE58) -> bytes:
    if mode == glz_tpu_torch.config.MODE_HUFFWORD:
        return chip_smoke.make_word_corpus(n, seed=seed)
    return chip_smoke.make_corpus(n, seed=seed).tobytes()


def _pageable(t):
    return t.cpu().numpy()


@pytest.fixture
def pageable_d2h(monkeypatch):
    """Turns every payload-sized D2H back into the pageable `.cpu()`."""
    def on():
        monkeypatch.setattr(transfer, "host_array", _pageable)
    return on


@pytest.mark.parametrize("path", list(STAGED_PATHS))
def test_pinned_staging_writes_the_pageable_bytes(cuda, pageable_d2h, path):
    """Containers and outputs byte-identical to the `.cpu()` path, and every
    payload-sized byte from the card through page-locked memory: the
    payload's words, then the output (the token ids in HuffWord mode)."""
    mode, conf, backend = STAGED_PATHS[path]
    data = _staged_input(mode)
    timer.reset_totals("d2h")
    blob = glz_tpu_torch.compress(data, mode=mode, conf=conf, backend=backend)
    assert glz_tpu_torch.decompress(blob) == data
    f = container.read_container(blob)
    if mode == glz_tpu_torch.config.MODE_BYTE:
        out_bytes = len(data)
    else:
        _, _, _, wv, nv = port_huffword.huffword_state_from_blob(f.codebook_blob)
        out_bytes = (2 if max(wv.n, nv.n) <= 0xFFFF else 4) * f.n_symbols
    want = -(-len(f.payload) // 4) * 4 + out_bytes
    assert timer.totals("d2h") == {timer.D2H_BYTES: want, timer.D2H_PINNED_BYTES: want}
    pageable_d2h()
    assert glz_tpu_torch.compress(data, mode=mode, conf=conf, backend=backend) == blob
    assert glz_tpu_torch.decompress(blob) == data


def test_pinned_staging_allocates_nothing_after_a_warm_call(cuda):
    """After one warm call of each path, 20 more of the same sizes take
    every page-locked block from the caching host allocator."""
    calls = [(_staged_input(mode), mode, conf, backend)
             for mode, conf, backend in STAGED_PATHS.values()]

    def run():
        for data, mode, conf, backend in calls:
            blob = glz_tpu_torch.compress(data, mode=mode, conf=conf, backend=backend)
            assert glz_tpu_torch.decompress(blob) == data

    run()
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    timer.reset_totals("d2h")
    for _ in range(20):
        run()
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before
    totals = timer.totals("d2h")
    assert totals[timer.D2H_PINNED_BYTES] == totals[timer.D2H_BYTES] > 0


@pytest.mark.parametrize("path", ["byte-lockstep", "byte-bitstream-host", "huffword-lockstep"])
def test_a_reused_block_leaves_what_an_earlier_call_returned(cuda, path):
    """Call A's container and output stay as they were after call B, on
    other data of the same size, reuses A's page-locked blocks."""
    mode, conf, backend = STAGED_PATHS[path]
    a, b = _staged_input(mode, seed=1), _staged_input(mode, seed=2)
    blob_a = glz_tpu_torch.compress(a, mode=mode, conf=conf, backend=backend)
    out_a = glz_tpu_torch.decompress(blob_a)
    digests = hashlib.sha256(blob_a).digest(), hashlib.sha256(out_a).digest()
    blob_b = glz_tpu_torch.compress(b, mode=mode, conf=conf, backend=backend)
    assert glz_tpu_torch.decompress(blob_b) == b and blob_b != blob_a
    assert (hashlib.sha256(blob_a).digest(), hashlib.sha256(out_a).digest()) == digests
    assert out_a == a and glz_tpu_torch.decompress(blob_a) == a


def test_host_array_stages_in_page_locked_memory(cuda, monkeypatch):
    """From the card the array lies in page-locked memory and is counted
    so; when none can be allocated, the pageable copy, counted as such."""
    t = torch.arange(1 << 20, dtype=torch.int32, device=cuda)
    timer.reset_totals("d2h")
    got = transfer.host_array(t)
    assert torch.from_numpy(got).is_pinned() and np.array_equal(got, t.cpu().numpy())
    assert timer.totals("d2h") == {timer.D2H_BYTES: 4 << 20, timer.D2H_PINNED_BYTES: 4 << 20}
    empty = torch.empty

    def no_page_locked_memory(*args, **kwargs):
        if kwargs.get("pin_memory"):
            raise RuntimeError("CUDA error: out of memory")
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", no_page_locked_memory)
    got = transfer.host_array(t)
    monkeypatch.undo()
    assert not torch.from_numpy(got).is_pinned() and np.array_equal(got, t.cpu().numpy())
    assert timer.totals("d2h") == {timer.D2H_BYTES: 8 << 20, timer.D2H_PINNED_BYTES: 4 << 20}


@pytest.fixture(scope="module")
def silesia_members():
    return list(chip_smoke.silesia_members().values())


@pytest.mark.parametrize("preset", ["THROUGHPUT", "DEFAULT"])
def test_silesia_batch_through_pinned_staging(cuda, silesia_members, pageable_d2h, preset):
    """compress_batch / decompress_batch of the twelve Silesia-sized draws,
    two files in flight on the pool's threads: exact, and the containers
    the serial `.cpu()` path writes."""
    conf = getattr(glz_tpu_torch.config, preset)
    blobs = glz_tpu_torch.compress_batch(silesia_members, conf=conf)
    assert glz_tpu_torch.decompress_batch(blobs) == silesia_members
    pageable_d2h()
    assert glz_tpu_torch.compress_batch(silesia_members, conf=conf, pipeline=False) == blobs


# name: (input bytes, conf, backend)
FRESH_PATHS = {
    "byte-lockstep-1e8": (100_000_000, glz_tpu_torch.config.THROUGHPUT, "host"),
    "byte-bitstream-51MB": (51_220_480, glz_tpu_torch.config.DEFAULT, "host"),
}


@pytest.mark.parametrize("path", list(FRESH_PATHS))
def test_fresh_pages_write_the_plain_bytes(cuda, monkeypatch, path):
    """A 10^8-B lockstep and a 51 MB bitstream round trip on the card: the
    container and the output are the bytes the plain join and tobytes
    write, and each was populated in bulk, whole (`populated_bytes` on
    `container.write` and `serialize`)."""
    n, conf, backend = FRESH_PATHS[path]
    data = chip_smoke.make_corpus(n, seed=0xF1).tobytes()
    with timer.recording() as spans:
        blob = glz_tpu_torch.compress(data, conf=conf, backend=backend)
        out = glz_tpu_torch.decompress(blob)
    assert out == data
    populated = {}
    for r in spans:
        if timer.POPULATED_BYTES in r.counts:
            populated[r.name] = populated.get(r.name, 0) + r.counts[timer.POPULATED_BYTES]
    assert populated == {"container.write": len(blob), "serialize": n}
    del out
    monkeypatch.setattr(fill, "BULK_FLOOR", 1 << 62)
    timer.reset_totals(timer.POPULATED_BYTES)
    assert glz_tpu_torch.compress(data, conf=conf, backend=backend) == blob
    assert glz_tpu_torch.decompress(blob) == data
    assert timer.totals(timer.POPULATED_BYTES).get(timer.POPULATED_BYTES, 0) == 0
