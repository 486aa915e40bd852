"""glz_tpu_torch's batch, .glzb archive and normal-tree mode against glz_tpu's
on the CPU.

The cases of tests/test_api.py (the batch, the shared-codebook batch, the
archive, a corrupt archive, checksums, peek_layout, the rows-cap warning and
the normal-tree mode) and of tests/test_compat.py's .crs tests run the same
call through both packages: lists of containers and archives must be
byte-identical, each package must decode the other's, and both must raise
the same errors.  glz_tpu runs as its own tests run it (Pallas interpret
mode on the CPU); the port runs its kernels' plain PyTorch versions
(device='cpu').  Also: the archive's common-suffix scan against glz_tpu's
search, and the kernel library built once when two threads ask for it.
"""

import dataclasses
import hashlib
import threading
import time

import numpy as np
import pytest

import glz_tpu
from glz_tpu import config as tpu_cfg
from glz_tpu.compat import glzip_format as tpu_gz
from glz_tpu.core import api as tpu_api

import chip_smoke
import glz_tpu_torch
from glz_tpu_torch import config as cfg
from glz_tpu_torch import models as port_models
from glz_tpu_torch.compat import glzip_format as port_gz
from glz_tpu_torch.core import api as port_api
from glz_tpu_torch.core import container
from glz_tpu_torch.ops import _kernels
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOCKSTEP_S64 = dict(stream_symbols=64, layout=cfg.LAYOUT_LOCKSTEP)


def _confs(preset=None, **kw):
    """The same configuration in both packages: (glz_tpu's, the port's)."""
    if preset is None:
        return tpu_cfg.GlzConfig(**kw), cfg.GlzConfig(**kw)
    return tuple(dataclasses.replace(getattr(c, preset), **kw) for c in (tpu_cfg, cfg))


def _split(kw: dict, conf):
    """(glz_tpu's keywords, the port's) with conf = None or _confs(...)."""
    tpu_kw, port_kw = dict(kw), dict(kw, device="cpu")
    if conf is not None:
        tpu_kw["conf"], port_kw["conf"] = conf
    return tpu_kw, port_kw


def batch_same(files, conf=None, **kw) -> list[bytes]:
    """compress_batch with the same arguments writes the same containers in
    both packages, and each package's decompress_batch reads the other's."""
    tpu_kw, port_kw = _split(kw, conf)
    want = glz_tpu.compress_batch(files, **tpu_kw)
    got = glz_tpu_torch.compress_batch(files, **port_kw)
    assert got == want
    assert glz_tpu_torch.decompress_batch(want, device="cpu") == files
    assert glz_tpu.decompress_batch(got) == files
    return got


def archive_same(files, conf=None, **kw) -> bytes:
    """compress_archive with the same arguments writes the same archive in
    both packages, and each package's decompress_archive reads the other's."""
    tpu_kw, port_kw = _split(kw, conf)
    want = glz_tpu.compress_archive(files, **tpu_kw)
    got = glz_tpu_torch.compress_archive(files, **port_kw)
    assert got == want
    assert glz_tpu_torch.decompress_archive(want, device="cpu") == files
    assert glz_tpu.decompress_archive(got) == files
    return got


def same_error(tpu_call, port_call, exc=ValueError) -> str:
    """Both calls raise `exc` with the same message; returns it."""
    with pytest.raises(exc) as want:
        tpu_call()
    with pytest.raises(exc) as got:
        port_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


def skewed(rng, n: int, alpha: float = 0.1) -> bytes:
    return rng.choice(256, size=n, p=rng.dirichlet(np.ones(256) * alpha)).astype(np.uint8).tobytes()


# ---- the multi-file batch -----------------------------------------------------

def test_compress_batch_mixed_files(text_100kb):
    """Files with very different statistics (text, skewed, random,
    degenerate, empty), each with its own codebook, in both layouts."""
    rng = np.random.default_rng(56)
    files = [text_100kb, skewed(rng, 80_000, 0.02),
             rng.integers(0, 256, size=60_000, dtype=np.uint8).tobytes(),
             b"\x00" * 50_000, b""]
    batch_same(files)
    batch_same(files, _confs(stream_symbols=256, layout=cfg.LAYOUT_LOCKSTEP))


@pytest.mark.parametrize("conf", [{}, dict(stream_symbols=256, layout=cfg.LAYOUT_LOCKSTEP)],
                         ids=["default", "lockstep"])
def test_compress_batch_pipelined_matches_serial(text_100kb, conf):
    """Two files in flight on two threads write the serial loop's
    containers, in input order, and decode the same either way."""
    rng = np.random.default_rng(72)
    files = [text_100kb[:40_000], text_100kb[20_000:70_000],
             rng.integers(0, 256, size=30_000, dtype=np.uint8).tobytes(), text_100kb[::-1]]
    conf = _confs(**conf)
    blobs = batch_same(files, conf)
    assert glz_tpu_torch.compress_batch(files, conf=conf[1], pipeline=False,
                                        device="cpu") == blobs
    assert glz_tpu_torch.decompress_batch(blobs, pipeline=False, device="cpu") == files


def test_batch_normal_tree_and_huffword(text_100kb):
    """The per-file batch in the other modes is compress()'s per file."""
    files = [text_100kb[:20_000], b"", text_100kb[50_000:60_000]]
    batch_same(files, mode=cfg.MODE_NORMAL_TREE)
    batch_same(files, _confs(**LOCKSTEP_S64), mode=cfg.MODE_HUFFWORD)


# ---- the shared-codebook batch -------------------------------------------------

def test_batch_shared_codebook_byte():
    """One histogram summed over the files (sampled per file), one codebook
    blob in every container."""
    rng = np.random.default_rng(116)
    p = rng.dirichlet(np.ones(256) * 0.1)
    files = [rng.choice(256, size=n, p=p).astype(np.uint8).tobytes()
             for n in (30_000, 50_000, 10_000)]
    blobs = batch_same(files, shared_codebook=True)
    assert len({container.read_container(b).codebook_blob for b in blobs}) == 1


def test_batch_shared_codebook_byte_lockstep_cap():
    """A lockstep conf caps the shared code at 26 bits: Fibonacci counts
    over 28 bytes make a 27-bit code uncapped (the third file adds to the
    most frequent byte only)."""
    fib = [1, 1]
    while len(fib) < 28:
        fib.append(fib[-1] + fib[-2])
    rng = np.random.default_rng(117)
    deep = np.repeat(np.arange(28, dtype=np.uint8), fib)
    files = [deep[rng.permutation(deep.size)].tobytes(), b"", b"\x1b" * 500]
    blobs = batch_same(files, _confs(group_rows=8, **LOCKSTEP_S64), shared_codebook=True)
    lengths = container.decode_byte_codebook(container.read_container(blobs[0]).codebook_blob)
    assert lengths.max() == 26


def test_batch_shared_codebook_byte_budget(text_100kb):
    """The sampled histogram's budget applies to each file before the sum."""
    rng = np.random.default_rng(118)
    geo = np.repeat(np.arange(40, dtype=np.uint8), [1 << min(i, 12) for i in range(40)][::-1])
    files = [geo[rng.permutation(geo.size)].tobytes(), text_100kb, b""]
    batch_same(files, _confs(histogram_budget=16 << 10), shared_codebook=True)
    batch_same(files, _confs(histogram_budget=16 << 10), backend="device",
               shared_codebook=True)


def test_batch_shared_codebook_huffword(text_100kb):
    """Shared dictionaries: the containers differ at most in the
    word_first byte of the codebook."""
    files = [text_100kb[:40_000], text_100kb[40_000:75_000],
             b"completely different words here " * 300]
    blobs = batch_same(files, _confs(**LOCKSTEP_S64), mode=cfg.MODE_HUFFWORD,
                       shared_codebook=True)
    assert len({container.read_container(b).codebook_blob[1:] for b in blobs}) == 1


def test_batch_shared_huffword_bitstream_layout(text_100kb):
    """The shared HuffWord batch honours a bitstream conf (layout 0)."""
    files = [text_100kb[:20_000], text_100kb[20_000:35_000]]
    blobs = batch_same(files, _confs(), mode=cfg.MODE_HUFFWORD, shared_codebook=True)
    fs = [container.read_container(b) for b in blobs]
    assert {f.layout for f in fs} == {container.LAYOUT_BITSTREAM}
    assert len({f.codebook_blob[1:] for f in fs}) == 1


def test_batch_shared_byte_device_backend():
    """backend='device' is honoured by the shared byte batch (word-aligned
    dispatches), as in glz_tpu."""
    rng = np.random.default_rng(222)
    p = rng.dirichlet(np.ones(256) * 0.1)
    files = [rng.choice(256, size=70_000, p=p).astype(np.uint8).tobytes() for _ in range(2)]
    blobs = batch_same(files, backend="device", shared_codebook=True)
    assert len({container.read_container(b).codebook_blob for b in blobs}) == 1
    assert blobs != batch_same(files, shared_codebook=True)


def test_shared_huffword_rows_cap_warns(text_100kb):
    """Both packages warn (naming the VMEM budget) and lower group_rows the
    same way."""
    conf = _confs(stream_symbols=1024, layout=cfg.LAYOUT_LOCKSTEP, group_rows=64)
    files = [text_100kb[:20_000]]
    with pytest.warns(UserWarning, match="VMEM budget"):
        want = glz_tpu.compress_batch(files, mode=cfg.MODE_HUFFWORD, conf=conf[0],
                                      shared_codebook=True)
    with pytest.warns(UserWarning, match="VMEM budget"):
        got = glz_tpu_torch.compress_batch(files, mode=cfg.MODE_HUFFWORD, conf=conf[1],
                                           shared_codebook=True, device="cpu")
    assert got == want


def test_shared_normal_tree_rejected():
    same_error(lambda: glz_tpu.compress_batch([b"ab"], mode=cfg.MODE_NORMAL_TREE,
                                              shared_codebook=True),
               lambda: glz_tpu_torch.compress_batch([b"ab"], mode=cfg.MODE_NORMAL_TREE,
                                                    shared_codebook=True, device="cpu"))


# ---- the .glzb archive ---------------------------------------------------------

def test_archive_roundtrip_and_size_byte():
    rng = np.random.default_rng(157)
    p = rng.dirichlet(np.ones(256) * 0.1)
    files = [rng.choice(256, size=20_000, p=p).astype(np.uint8).tobytes() for _ in range(4)]
    arc = archive_same(files)
    assert len(arc) < sum(len(b) for b in batch_same(files))


def test_archive_roundtrip_and_size_huffword(realtext):
    """The shared vocabulary is stored once: smaller than the per-file
    containers in total."""
    n4 = 60_000
    files = [realtext[i * n4 : (i + 1) * n4] for i in range(4)]
    conf = _confs(**LOCKSTEP_S64)
    arc = archive_same(files, conf, mode=cfg.MODE_HUFFWORD)
    per_file = glz_tpu_torch.compress_batch(files, mode=cfg.MODE_HUFFWORD, conf=conf[1],
                                            device="cpu")
    assert len(arc) < sum(len(b) for b in per_file)


def test_pinned_archive_digests(realtext):
    """The digests chip_smoke.py checks on the card are glz_tpu's: archives
    of four equal slices of realtext.txt[:1 MiB] in byte DEFAULT, byte
    THROUGHPUT and HuffWord lockstep (S 64), and the normal-tree container
    of the whole 1 MiB."""
    text = realtext[: 1 << 20]
    for key, (mode, port_conf) in chip_smoke.archive_pinned_configs().items():
        tpu_conf = tpu_cfg.GlzConfig(**dataclasses.asdict(port_conf))
        if mode == cfg.MODE_NORMAL_TREE:
            want = glz_tpu.compress(text, mode=mode, conf=tpu_conf)
            got = glz_tpu_torch.compress(text, mode=mode, conf=port_conf, device="cpu")
        else:
            want = glz_tpu.compress_archive(chip_smoke.quarters(text), mode=mode, conf=tpu_conf)
            got = glz_tpu_torch.compress_archive(chip_smoke.quarters(text), mode=mode,
                                                 conf=port_conf, device="cpu")
        assert hashlib.sha256(want).hexdigest() == chip_smoke.ARCHIVE_PINNED[key], key
        assert got == want, key


def test_archive_empty_and_degenerate():
    archive_same([])
    archive_same([b""])
    archive_same([b"", b"\x07" * 1000, bytes(range(256)) * 3])


def test_archive_corrupt_rejected():
    arc = archive_same([b"abc" * 100, b"def" * 100])
    bad = {"truncated entry": arc[:20], "magic": b"NOPE" + arc[4:],
           "truncated body": arc[:-10], "short": arc[:12],
           "version": arc[:4] + b"\x02" + arc[5:],
           "truncated shared": arc[:16 + 100]}
    for name, blob in bad.items():
        msg = same_error(lambda: glz_tpu.decompress_archive(blob),
                         lambda: glz_tpu_torch.decompress_archive(blob, device="cpu"))
        assert msg, name


def test_archive_checksum():
    rng = np.random.default_rng(201)
    files = [rng.integers(0, 64, 9000, dtype=np.uint8).tobytes() for _ in range(2)]
    arc = archive_same(files, _confs(checksum=True))
    bad = bytearray(arc)
    bad[len(bad) - 100] ^= 0x04  # a bit inside the last payload
    msg = same_error(lambda: glz_tpu.decompress_archive(bytes(bad)),
                     lambda: glz_tpu_torch.decompress_archive(bytes(bad), device="cpu"))
    assert "checksum mismatch" in msg


def test_archive_peek_layout(text_100kb):
    files = [text_100kb[:10_000], text_100kb[10_000:25_000]]
    for conf, layout in ((None, container.LAYOUT_BITSTREAM),
                         (_confs(**LOCKSTEP_S64), container.LAYOUT_LOCKSTEP)):
        arc = archive_same(files, conf)
        assert port_api.archive_peek_layout(arc) == tpu_api.archive_peek_layout(arc) == layout
        assert port_api.archive_peek_layout(memoryview(arc)) == layout
    assert port_api.archive_peek_layout(glz_tpu_torch.compress_archive([], device="cpu")) \
        == container.LAYOUT_BITSTREAM
    for blob in (b"NOPE" + arc[4:], arc[:10], arc[:20]):
        same_error(lambda: tpu_api.archive_peek_layout(blob),
                   lambda: port_api.archive_peek_layout(blob))
    assert "truncated" in same_error(lambda: tpu_api.archive_peek_layout(arc[:20]),
                                     lambda: port_api.archive_peek_layout(arc[:20]))


def _old_suffix_len(blobs: list[bytes]) -> int:
    """glz_tpu's search (core/api.py compress_archive), as it is there."""
    shared_len = min(len(c) for c in blobs) if blobs else 0
    for c in blobs[1:]:
        while shared_len and c[-shared_len:] != blobs[0][-shared_len:]:
            shared_len -= 1
    return shared_len


def test_common_suffix_scan_matches_search():
    """One backward scan per blob gives glz_tpu's shared length: random
    blobs with a common tail, blobs that diverge at the last byte or at
    byte 0 only (HuffWord's word_first), equal, empty and unequal-length
    blobs."""
    rng = np.random.default_rng(0x5FF)
    cases = [[], [b""], [b"abc"], [b"abc", b"abc"], [b"abc", b""], [b"xabc", b"abc"],
             [b"abc", b"abd"], [b"\x00tail", b"\x01tail", b"\x00tail"]]
    for _ in range(60):
        tail = rng.integers(0, 4, rng.integers(0, 50), dtype=np.uint8).tobytes()
        cases.append([rng.integers(0, 4, rng.integers(0, 20), dtype=np.uint8).tobytes() + tail
                      for _ in range(rng.integers(1, 5))])
    body = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    cases.append([b"\x00" + body, b"\x01" + body, b"\x01" + body])
    cases.append([body, body[:2500] + b"\xff" + body[2501:]])
    for blobs in cases:
        assert port_api.common_suffix_len(blobs) == _old_suffix_len(blobs), blobs


# ---- the normal-tree mode --------------------------------------------------------

@pytest.mark.parametrize("checksum", [False, True])
def test_normal_tree_container(text_100kb, checksum):
    """compress(mode=MODE_NORMAL_TREE) writes glz_tpu's mode-2 container;
    each package decodes the other's."""
    data = text_100kb[:40_000]
    conf = _confs(checksum=checksum)
    want = glz_tpu.compress(data, mode=cfg.MODE_NORMAL_TREE, conf=conf[0])
    got = glz_tpu_torch.compress(data, mode=cfg.MODE_NORMAL_TREE, conf=conf[1], device="cpu")
    assert got == want
    assert container.read_container(got).mode == cfg.MODE_NORMAL_TREE
    assert glz_tpu_torch.decompress(want, device="cpu") == data
    assert glz_tpu.decompress(got) == data


def test_normal_tree_checksum_detects_corruption(text_100kb):
    data = text_100kb[:10_000]
    blob = bytearray(glz_tpu_torch.compress(data, mode=cfg.MODE_NORMAL_TREE,
                                            conf=cfg.GlzConfig(checksum=True), device="cpu"))
    blob[-20] ^= 0x40
    same_error(lambda: glz_tpu.decompress(bytes(blob)),
               lambda: glz_tpu_torch.decompress(bytes(blob), device="cpu"))


def test_normal_tree_realtext(realtext):
    """Real text: the whole fixture's container is glz_tpu's; its first 40
    KB round-trip (the tree walk decodes a bit at a time)."""
    want = glz_tpu.compress(realtext, mode=cfg.MODE_NORMAL_TREE)
    assert glz_tpu_torch.compress(realtext, mode=cfg.MODE_NORMAL_TREE, device="cpu") == want
    blob = glz_tpu_torch.compress(realtext[:40_000], mode=cfg.MODE_NORMAL_TREE, device="cpu")
    assert glz_tpu_torch.decompress(blob, device="cpu") == realtext[:40_000]
    assert len(blob) < 40_000


def test_crs_matches_reference(text_100kb):
    data = text_100kb[:20_000]
    blob = port_gz.write_crs(data)
    assert blob == tpu_gz.write_crs(data)
    assert port_gz.read_crs(blob) == data
    assert port_gz.crs_code_table(blob) == tpu_gz.crs_code_table(blob)
    assert port_gz.crs_tree_dot(blob) == tpu_gz.crs_tree_dot(blob)


@pytest.mark.parametrize("payload", [b"", b"a", b"ab" * 5, bytes(range(256))])
def test_crs_formats_edges(payload):
    blob = port_gz.write_crs(payload)
    assert blob == tpu_gz.write_crs(payload)
    assert port_gz.read_crs(blob) == payload == tpu_gz.read_crs(blob)


def test_crs_deep_codes():
    """Codes over 32 bits take the BitWriter path: Fibonacci frequencies
    make a tree 40 levels deep."""
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    data = b"".join(bytes([i]) * f for i, f in enumerate(fib[:30]))
    blob = port_gz.write_crs(data)
    assert max(len(v) for v in port_gz.crs_code_table(blob).values()) > 20
    assert blob == tpu_gz.write_crs(data)


def test_model_registry_matches_reference():
    from glz_tpu import models as tpu_models

    assert port_models.REGISTRY == tpu_models.REGISTRY
    for name in tpu_models.REGISTRY:
        assert port_models.by_name(name) == tpu_models.by_name(name)
    with pytest.raises(KeyError, match="unknown codec model"):
        port_models.by_name("lz77")


# ---- entry points: device, exports ----------------------------------------------

def test_entry_points_need_a_device_or_cpu():
    """device=None means the card: without one each new entry point raises
    (a dropped `device` in the batch's per-file calls would raise there
    too, so the device='cpu' tests above run through the plain versions)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    for call in (lambda: glz_tpu_torch.compress_batch([b"abc"]),
                 lambda: glz_tpu_torch.compress_batch([b"abc"], shared_codebook=True),
                 lambda: glz_tpu_torch.compress_archive([b"abc"]),
                 lambda: glz_tpu_torch.compress(b"abc", mode=cfg.MODE_NORMAL_TREE)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    arc = glz_tpu_torch.compress_archive([b"abc", b"abd"], device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        glz_tpu_torch.decompress_archive(arc)


def test_exports_match_reference():
    for name in ("compress_batch", "decompress_batch", "compress_archive",
                 "decompress_archive"):
        assert callable(getattr(glz_tpu_torch, name)), name
        assert callable(getattr(glz_tpu, name)), name
    assert port_api.ARCHIVE_MAGIC == tpu_api.ARCHIVE_MAGIC


# ---- the kernel library under two threads ----------------------------------------

def test_library_builds_once_under_two_threads(monkeypatch, tmp_path):
    """Two threads asking for the library at once (the pipelined batch's
    first files) build and load it once and get the same handle."""
    builds, loads = [], []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return tmp_path / "libfake.so"

    class FakeLib:
        def __init__(self, path):
            loads.append(path)
            for name in _kernels._SIGNATURES:
                setattr(self, name, type("Fn", (), {})())

    monkeypatch.setattr(_kernels, "_LIB", None)
    monkeypatch.setattr(_kernels, "build", slow_build)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", FakeLib)
    start = threading.Barrier(2)
    got = []

    def ask():
        start.wait(timeout=10)
        got.append(_kernels.library())

    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 2 and got[0] is got[1]
    assert got[0].glz_lane_totals.argtypes == _kernels._SIGNATURES["glz_lane_totals"]
