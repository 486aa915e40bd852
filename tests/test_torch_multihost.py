"""glz_tpu_torch.parallel.multihost in several processes:
tests/test_multihost.py's cases on the port, with containers byte-identical
to glz_tpu's.

The port's processes are gloo ranks (parallel/ranks.py) on one torch
thread each, spawned three times for the module: two ranks run every
two-process job of JOBS (_rank_jobs; a job whose shards are rejected
records each rank's error), three ranks the three-process job, and two
ranks a rejected shard left uncaught.  glz_tpu's containers come from the
unchanged tests/multihost_driver.py (JAX processes on the CPU), six runs
cached for the module while the port's ranks run.  Every process has a
timeout.

This file is also the ranks' module: keep its top-level imports free of
glz_tpu (JAX), which the ranks do not need.
"""

import concurrent.futures
import dataclasses
import os
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest

import glz_tpu_torch as gt
from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import container
from glz_tpu_torch.models.canonical_byte import compress_bytes_lockstep
from glz_tpu_torch.parallel import multihost, ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
DRIVER = REPO / "tests" / "multihost_driver.py"
TIMEOUT = 240


def make_corpus() -> bytes:
    rng = np.random.default_rng(0x3C0)
    p = rng.dirichlet(np.ones(256) * 0.08)
    return rng.choice(256, size=100_000, p=p).astype(np.uint8).tobytes()


def word_corpus(n_words: int, seed: int = 0x3C1) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"alpha", b"bravo12", b"x", b"compress", b"tpu9", b"glz",
             b"lockstep", b"mesh", b"q", b"dictionary"]
    picks = rng.choice(len(words), size=n_words)
    return b" ".join(words[i] for i in picks) + b" "


def disjoint_corpus() -> bytes:
    """Shard 0 only a-words with spaces, shard 1 only b-words with tabs:
    one full group of tokens (S 64, rows 8) each."""
    rng = np.random.default_rng(0x3C2)
    A = [b"alphaonly", b"aardvark", b"a1z", b"aq"]
    B = [b"bravoonly", b"balloon", b"b2y", b"bx"]
    half = 8 * 128 * 64 // 2
    return (b"".join(A[int(i)] + b" " for i in rng.choice(4, half))
            + b"".join(B[int(i)] + b"\t" for i in rng.choice(4, half)))


def inputs() -> dict[str, bytes]:
    corpus = make_corpus()
    words = word_corpus(80_000)
    from glz_tpu_torch.utils import tokenizer as tok

    starts = tok.tokenize(words)[0]
    return {"corpus": corpus, "corpus_24": corpus[: 24 * 4096], "corpus_60k": corpus[:60_000],
            "ls": (corpus * 2)[:180_000], "ls_swap": (corpus * 2)[: 2 * 1024 * 64],
            "ls16": (corpus * 3)[:290_000], "words": words,
            "words_2g": words[: int(starts[2 * 1024 * 64])], "disjoint": disjoint_corpus()}


def _lockstep_conf(S, rows=8, checksum=False):
    return cfg.GlzConfig(stream_symbols=S, layout=cfg.LAYOUT_LOCKSTEP, group_rows=rows,
                         checksum=checksum)


# name -> (input, kind, S, rows, mode, checksum); tests/multihost_driver.py's
# kinds and modes ("swap" exchanges shards 0 and 1, "misalign" cuts equal
# byte shards, "empty" gives the last rank nothing); "dec"/"dec_hw" decode
# the port's single-process container of the input
JOBS = {
    "byte": ("corpus", "byte", 4096, 8, "normal", False),
    "byte_crc": ("corpus", "byte", 4096, 8, "normal", True),
    "byte_swap": ("corpus_24", "byte", 4096, 8, "swap", False),
    "byte_misalign": ("corpus", "byte", 4096, 8, "misalign", False),
    "byte_empty": ("corpus", "byte", 4096, 8, "empty", False),
    "ls": ("ls", "lockstep", 64, 8, "normal", False),
    "ls_crc": ("ls", "lockstep", 64, 8, "normal", True),
    "ls_swap": ("ls_swap", "lockstep", 64, 8, "swap", False),
    "ls_misalign": ("corpus", "lockstep", 64, 8, "misalign", False),
    "ls16": ("ls16", "lockstep", 64, 16, "normal", False),
    "hw": ("words", "huffword", 64, 8, "normal", False),
    "hw_swap": ("words_2g", "huffword", 64, 8, "swap", False),
    "hw_misalign": ("words", "huffword", 64, 8, "misalign", False),
    "hw_empty": ("words", "huffword", 64, 8, "empty", False),
    "hw_disjoint": ("disjoint", "huffword", 64, 8, "normal", True),
    "dec": ("ls", "dec", 64, 8, "normal", False),
    "dec_hw": ("words", "dec_hw", 64, 8, "normal", False),
}
# glz_tpu's runs: name -> (input, nproc, S, kind, rows, checksum)
TPU_RUNS = {
    "byte_crc": ("corpus", 2, 4096, "byte", 8, True),
    "byte3": ("corpus_60k", 3, 2048, "byte", 8, False),
    "ls_crc": ("ls", 2, 64, "lockstep", 8, True),
    "ls16": ("ls16", 2, 64, "lockstep", 16, False),
    "hw": ("words", 2, 64, "huffword", 8, False),
    "hw_disjoint": ("disjoint", 2, 64, "huffword", 8, True),
}


def _bounds(data: bytes, kind: str, S: int, rows: int, mode: str, nproc: int) -> list[int]:
    """Shard offsets as tests/multihost_driver.py cuts them."""
    if mode == "misalign":
        return [len(data) * i // nproc for i in range(nproc + 1)]
    if mode == "empty":
        return [len(data) * i // (nproc - 1) for i in range(nproc)] + [len(data)]
    if kind == "huffword":
        return multihost.split_huffword_shards(data, nproc, _lockstep_conf(S, rows))
    align = rows * 128 * S if kind == "lockstep" else S
    return [min(len(data) * i // nproc // align * align, len(data))
            for i in range(nproc)] + [len(data)]


def _run_job(job, data: bytes):
    _, kind, S, rows, mode, checksum = job
    pid, nproc = multihost.process_index(), multihost.process_count()
    if kind in ("dec", "dec_hw"):
        mode_ = cfg.MODE_HUFFWORD if kind == "dec_hw" else cfg.MODE_BYTE
        blob = gt.compress(data, mode=mode_, backend="device", conf=_lockstep_conf(S),
                           device="cpu")
        fn = (multihost.decompress_huffword_multihost if kind == "dec_hw"
              else multihost.decompress_bytes_multihost)
        local, off = fn(blob, device="cpu")
        return off, local
    bounds = _bounds(data, kind, S, rows, mode, nproc)
    take = {0: 1, 1: 0}.get(pid, pid) if mode == "swap" else pid
    shard = data[bounds[take] : bounds[take + 1]]
    if kind == "huffword":
        return multihost.compress_huffword_multihost(shard, _lockstep_conf(S, rows, checksum),
                                                     device="cpu")
    conf = (_lockstep_conf(S, rows, checksum) if kind == "lockstep"
            else cfg.GlzConfig(stream_symbols=S, checksum=checksum))
    return multihost.compress_bytes_multihost(shard, conf, device="cpu")


def _gathers():
    """Values past 2^31 (and 2^62) across the ranks, each rank's own."""
    import torch

    pid = multihost.process_index()
    big = multihost._allgather([(1 << 33) + pid, 7, (1 << 40) + 123])
    parts = multihost._gather_ragged(np.array([1, (1 << 35) + pid, 2**62][: 2 + pid], np.int64))
    u32 = multihost._gather_ragged(np.arange(5 + pid, dtype=np.uint32) | np.uint32(1 << 31))
    u8 = multihost._gather_ragged(np.arange(13 + pid, dtype=np.uint8))
    none = multihost._gather_ragged(np.zeros(0, np.int64))
    assert len(none) == 2 and all(p.dtype == np.int64 and p.size == 0 for p in none)
    assert torch.get_num_threads() == 1
    return big, parts, u32, u8


def _rank_jobs(paths: dict[str, str], names: list[str]) -> dict:
    """Run the jobs `names` in order on this rank: the container (rank 0's;
    None elsewhere), ("error", message) where the shards were rejected, or
    (offset, bytes) of a decode."""
    out = {"gathers": _gathers()}
    for name in names:
        job = JOBS[name]
        data = pathlib.Path(paths[job[0]]).read_bytes()
        try:
            out[name] = _run_job(job, data)
        except ValueError as e:
            out[name] = ("error", str(e))
    return out


def _rank_three(path: str):
    data = pathlib.Path(path).read_bytes()
    bounds = _bounds(data, "byte", 2048, 8, "normal", 3)
    shard = data[bounds[multihost.process_index()] : bounds[multihost.process_index() + 1]]
    return multihost.compress_bytes_multihost(shard, cfg.GlzConfig(stream_symbols=2048),
                                              device="cpu")


def _rank_uncaught(path: str):
    data = pathlib.Path(path).read_bytes()
    return _run_job(("", "lockstep", 64, 8, "misalign", False), data)


def _tpu_run(tmp: pathlib.Path, name: str, path: str) -> bytes:
    """glz_tpu's container from tests/multihost_driver.py."""
    _, nproc, S, kind, rows, checksum = TPU_RUNS[name]
    outfile = tmp / f"tpu_{name}.glz"
    port = ranks.free_port()
    env = {**os.environ, "GLZ_MH_CHECKSUM": "1" if checksum else "0"}
    procs = [subprocess.Popen([sys.executable, str(DRIVER), str(i), str(nproc), str(port),
                               path, str(outfile), "0", str(S), kind, str(rows)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=env)
             for i in range(nproc)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, f"{name}: rc={p.returncode}\n{err.decode()[-2000:]}"
    return outfile.read_bytes()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, port results a rank, the three-process container, glz_tpu's
    containers): the port's two runs, one after the other, while glz_tpu's
    runs go one at a time beside them."""
    tmp = tmp_path_factory.mktemp("multihost")
    data = inputs()
    paths = {}
    for k, v in data.items():
        (tmp / k).write_bytes(v)
        paths[k] = str(tmp / k)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        tpu = ex.submit(lambda: {k: _tpu_run(tmp, k, paths[TPU_RUNS[k][0]]) for k in TPU_RUNS})
        port = ranks.run(f"{__file__}:_rank_jobs", 2, paths, list(JOBS), timeout=TIMEOUT,
                         threads=1)
        three = ranks.run(f"{__file__}:_rank_three", 3, paths["corpus_60k"], timeout=TIMEOUT,
                          threads=1)
        return data, port, three[0], tpu.result()


def _blob(runs, name):
    data, port, _, _ = runs
    assert port[1][name] is None  # only host 0 returns the container
    assert isinstance(port[0][name], bytes), port[0][name]
    return port[0][name]


def _decodes(blob: bytes, data: bytes) -> bool:
    from glz_tpu import decompress as tpu_decompress

    got = gt.decompress(blob, device="cpu")
    assert tpu_decompress(blob) == got
    return got == data


def _errors(runs, name) -> list[str]:
    """Every rank's error of a rejected job (each rank raises)."""
    _, port, _, _ = runs
    assert all(r[name][0] == "error" for r in port), [r[name] for r in port]
    return [r[name][1] for r in port]


def test_multihost_two_process_roundtrip(runs):
    assert _decodes(_blob(runs, "byte"), runs[0]["corpus"])


def test_multihost_matches_single_process_size(runs):
    """The shared codebook is the whole file's: the stitched payload equals
    one process's up to a byte of alignment a shard."""
    blob = _blob(runs, "byte")
    single = gt.compress(runs[0]["corpus"], conf=cfg.GlzConfig(stream_symbols=4096),
                         device="cpu")
    f_m, f_s = container.read_container(blob), container.read_container(single)
    assert f_m.codebook_blob == f_s.codebook_blob
    assert abs(len(f_m.payload) - len(f_s.payload)) <= 1
    assert f_m.n_symbols == f_s.n_symbols


def test_multihost_shard_swap_detected(runs):
    assert not _decodes(_blob(runs, "byte_swap"), runs[0]["corpus_24"])


def test_multihost_misaligned_shard_rejected(runs):
    for msg in _errors(runs, "byte_misalign"):
        assert "stream_symbols" in msg and "align shard boundaries" in msg


@pytest.mark.parametrize("name", ["byte_empty", "hw_empty"])
def test_multihost_empty_shard_rejected(runs, name):
    for msg in _errors(runs, name):
        assert "host 1 got an empty shard" in msg


def test_multihost_three_process(runs):
    data, _, blob, tpu = runs
    assert blob == tpu["byte3"]
    assert _decodes(blob, data["corpus_60k"])


def test_multihost_lockstep_roundtrip(runs):
    blob = _blob(runs, "ls")
    assert container.read_container(blob).layout == container.LAYOUT_LOCKSTEP
    assert _decodes(blob, runs[0]["ls"])


def test_multihost_lockstep_matches_single_process(runs):
    """Group segments are self-contained and the codebook is the exact
    histogram's, so the stitched container is one process's
    compress_bytes_lockstep with an exact histogram, byte for byte."""
    data = runs[0]["ls"]
    for name, checksum in (("ls", False), ("ls_crc", True)):
        conf = dataclasses.replace(_lockstep_conf(64, checksum=checksum), histogram_budget=None)
        assert _blob(runs, name) == compress_bytes_lockstep(data, conf, device="cpu")


def test_multihost_lockstep_swap_detected(runs):
    assert not _decodes(_blob(runs, "ls_swap"), runs[0]["ls_swap"])


def test_multihost_lockstep_misaligned_rejected(runs):
    for msg in _errors(runs, "ls_misalign"):
        assert "group" in msg and "align shard boundaries" in msg


def test_multihost_huffword_roundtrip(runs):
    blob = _blob(runs, "hw")
    f = container.read_container(blob)
    assert f.layout == container.LAYOUT_LOCKSTEP and f.mode == cfg.MODE_HUFFWORD
    assert blob == runs[3]["hw"]
    # the union of the shards' vocabularies is the file's, and the shards
    # are whole groups: one process's container, byte for byte
    assert blob == gt.compress(runs[0]["words"], mode=cfg.MODE_HUFFWORD, backend="device",
                               conf=_lockstep_conf(64), device="cpu")
    assert _decodes(blob, runs[0]["words"])


def test_multihost_huffword_swap_detected(runs):
    assert not _decodes(_blob(runs, "hw_swap"), runs[0]["words_2g"])


def test_multihost_huffword_misaligned_rejected(runs):
    for msg in _errors(runs, "hw_misalign"):
        assert "split_huffword_shards" in msg


def test_split_huffword_shards_contract(runs):
    """The planner's offsets are glz_tpu's and meet the contract: every
    non-last shard re-tokenizes to whole groups, all of one first class."""
    from glz_tpu.config import LAYOUT_LOCKSTEP, GlzConfig as TpuConfig
    from glz_tpu.parallel.multihost import split_huffword_shards as tpu_split

    from glz_tpu_torch.utils import tokenizer as tok

    for nproc in (2, 3):
        data = runs[0]["words"] * (nproc - 1)
        bounds = multihost.split_huffword_shards(data, nproc, _lockstep_conf(64))
        assert bounds == tpu_split(data, nproc, TpuConfig(stream_symbols=64,
                                                          layout=LAYOUT_LOCKSTEP))
        assert bounds[0] == 0 and bounds[-1] == len(data)
        classes = []
        for k in range(nproc):
            starts, _, word_first = tok.tokenize(data[bounds[k] : bounds[k + 1]])
            if k < nproc - 1:
                assert starts.size % (1024 * 64) == 0
            classes.append(word_first)
        assert len(set(classes)) == 1
    with pytest.raises(ValueError, match="cannot split"):
        multihost.split_huffword_shards(data[:5000], 2, _lockstep_conf(64))
    with pytest.raises(ValueError, match="cannot split"):
        multihost.split_huffword_shards(runs[0]["words"], 3, _lockstep_conf(64))


@pytest.mark.parametrize("name", ["dec", "dec_hw"])
def test_multihost_decompress(runs, name):
    """Shard-parallel decompress: each rank decodes a contiguous group range
    and returns (offset, bytes) slices that reassemble the file."""
    data, port, _, _ = runs
    want = data[JOBS[name][0]]
    parts = sorted(r[name] for r in port)
    assert all(len(p[1]) > 0 for p in parts)  # both ranks decoded a range
    assert parts[0][0] == 0 and parts[1][0] == len(parts[0][1])
    assert b"".join(p[1] for p in parts) == want


def test_multihost_decompress_single_process(runs):
    """One process: decompress_bytes_multihost decodes it all at offset 0."""
    data = runs[0]["ls"][:150_000]
    blob = gt.compress(data, conf=_lockstep_conf(64), device="cpu")
    local, off = multihost.decompress_bytes_multihost(blob, device="cpu")
    assert off == 0 and local == data
    hblob = gt.compress(runs[0]["words"], mode=cfg.MODE_HUFFWORD, backend="device",
                        conf=_lockstep_conf(64), device="cpu")
    assert multihost.decompress_huffword_multihost(hblob, device="cpu") == (runs[0]["words"], 0)


def test_multihost_decompress_rejects_bitstream(runs):
    blob = gt.compress(runs[0]["corpus"][:10_000], device="cpu")
    with pytest.raises(ValueError, match="lockstep"):
        multihost.decompress_bytes_multihost(blob, device="cpu")
    with pytest.raises(ValueError, match="lockstep huffword"):
        multihost.decompress_huffword_multihost(blob, device="cpu")


def test_multihost_lockstep_wide_groups(runs):
    blob = _blob(runs, "ls16")
    assert container.read_container(blob).group_rows == 16
    assert blob == runs[3]["ls16"]
    assert _decodes(blob, runs[0]["ls16"])


def test_huffword_multihost_rows_cap():
    """conf.group_rows, capped (with glz_tpu's warning) by the dual decode's
    non-pack2 bound, as glz_tpu caps it."""
    from glz_tpu.config import LAYOUT_LOCKSTEP, GlzConfig as TpuConfig
    from glz_tpu.parallel.multihost import huffword_multihost_rows as tpu_rows

    for S, rows, want in ((64, 64, 64), (512, 64, 16), (1024, 8, 8)):
        with pytest.warns(UserWarning) if want < rows else _no_warning():
            got = multihost.huffword_multihost_rows(_lockstep_conf(S, rows))
        assert got == want
        with pytest.warns(UserWarning) if want < rows else _no_warning():
            assert tpu_rows(TpuConfig(stream_symbols=S, layout=LAYOUT_LOCKSTEP,
                                      group_rows=rows)) == want


def _no_warning():
    import contextlib
    import warnings

    @contextlib.contextmanager
    def none():
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            yield

    return none()


def test_multihost_lockstep_checksum(runs):
    """conf.checksum: the shards' crc32s combine into the file's, and a
    flipped payload bit fails the check on decode."""
    data = runs[0]["ls"]
    blob = _blob(runs, "ls_crc")
    assert blob == runs[3]["ls_crc"]
    assert container.read_container(blob).checksum == zlib.crc32(data)
    assert _decodes(blob, data)
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x40
    with pytest.raises(ValueError, match="checksum mismatch"):
        gt.decompress(bytes(bad), device="cpu")


def test_multihost_bitstream_checksum(runs):
    data = runs[0]["corpus"]
    blob = _blob(runs, "byte_crc")
    assert blob == runs[3]["byte_crc"]
    assert container.read_container(blob).checksum == zlib.crc32(data)
    assert _decodes(blob, data)


def test_multihost_huffword_disjoint_vocabs(runs):
    """Shards with disjoint vocabularies: the stitched dictionaries are the
    true union, the remapped ids decode exactly, glz_tpu's bytes."""
    from glz_tpu_torch.models.huffword import decode_dict_blob as _decode_dict_blob

    data = runs[0]["disjoint"]
    blob = _blob(runs, "hw_disjoint")
    assert blob == runs[3]["hw_disjoint"]
    f = container.read_container(blob)
    assert f.checksum == zlib.crc32(data)
    assert _decodes(blob, data)
    mv = memoryview(f.codebook_blob)
    wl, woff, wblob, off = _decode_dict_blob(mv, 1)
    nl, noff, nblob, off = _decode_dict_blob(mv, off)
    words = {bytes(wblob[woff[i] : woff[i + 1]]) for i in range(wl.size)}
    nwords = {bytes(nblob[noff[i] : noff[i + 1]]) for i in range(nl.size)}
    assert words == {b"alphaonly", b"aardvark", b"a1z", b"aq",
                     b"bravoonly", b"balloon", b"b2y", b"bx"}
    assert nwords == {b" ", b"\t"}


def test_allgather_int64_exact(runs):
    """Values past 2^31 survive the gathers exactly, in one process and
    across two, and sizes must not be negative."""
    big = (1 << 33) + 5
    got = multihost._allgather([big, 7, (1 << 40) + 123])
    assert got.shape == (1, 3) and int(got[0, 0]) == big
    assert int(got[0, 2]) == (1 << 40) + 123
    arr = np.array([1, (1 << 35) + 9, 2**62], np.int64)
    parts = multihost._gather_ragged(arr)
    assert len(parts) == 1 and np.array_equal(parts[0], arr)
    u8 = np.arange(13, dtype=np.uint8)
    assert np.array_equal(multihost._gather_ragged(u8)[0], u8)
    with pytest.raises(ValueError, match="non-negative"):
        multihost._allgather([-1])

    for r in runs[1]:
        g_big, g_parts, g_u32, g_u8 = r["gathers"]
        assert g_big.dtype == np.int64
        assert g_big.tolist() == [[(1 << 33) + p, 7, (1 << 40) + 123] for p in (0, 1)]
        for p in (0, 1):
            assert np.array_equal(g_parts[p], np.array([1, (1 << 35) + p, 2**62][: 2 + p]))
            assert g_u32[p].dtype == np.uint32 and np.array_equal(
                g_u32[p], np.arange(5 + p, dtype=np.uint32) | np.uint32(1 << 31))
            assert np.array_equal(g_u8[p], np.arange(13 + p, dtype=np.uint8))


def test_rejected_shard_stops_every_rank(runs, tmp_path):
    """Left uncaught, a rejected shard fails every rank with glz_tpu's
    message, and no rank waits for the others."""
    path = tmp_path / "in.bin"
    path.write_bytes(runs[0]["corpus"])
    with pytest.raises(ranks.RankError) as e:
        ranks.run(f"{__file__}:_rank_uncaught", 2, str(path), timeout=TIMEOUT, threads=1)
    assert all(c not in (0, None) for c in e.value.returncodes)
    assert all("align shard boundaries" in s for s in e.value.stderrs)
    assert "ran out of time" not in str(e.value)
