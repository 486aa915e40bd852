"""glz_tpu_torch's front door against glz_tpu's on the CPU.

The same call to compress() in both packages, defaults included, writes
the same bytes: byte and HuffWord mode, backend "host" (the default: the
host encoder's byte container, one bit stream with payload bytes up to the
last code bit) and "device" (word-aligned dispatches in byte mode, a
lockstep container in HuffWord mode), under DEFAULT, RATIO, THROUGHPUT and
a bitstream configuration with a histogram budget.  Each package decodes
the other's containers.  glz_tpu runs as its own tests run it (JAX on the
CPU, its host encoder native where that is built); the port runs its
kernels' plain PyTorch versions (device='cpu').
"""

import contextlib
import dataclasses
import hashlib

import numpy as np
import pytest

import glz_tpu
from glz_tpu import config as tpu_cfg
from glz_tpu.core import api as tpu_api
from glz_tpu.core import codebook as tpu_codebook
from glz_tpu.models import huffword as tpu_hw

import chip_smoke
import glz_tpu_torch
from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import container as port_container
from glz_tpu_torch.models import canonical_byte as port_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODES = {"byte": cfg.MODE_BYTE, "huffword": cfg.MODE_HUFFWORD}


def c1_input() -> bytes:
    """100,003 bytes, the AND of two uniform byte draws: the input on which
    the port's default container first differed from glz_tpu's."""
    rng = np.random.default_rng(0)
    n = 100_003
    return (rng.integers(0, 256, n, dtype=np.uint8) & rng.integers(0, 256, n, dtype=np.uint8)).tobytes()


def _confs(preset: str, **kw):
    """The same configuration in both packages."""
    return tuple(dataclasses.replace(getattr(c, preset), **kw) for c in (tpu_cfg, cfg))


def _same(data: bytes, mode=None, backend=None, confs=None) -> bytes:
    """Both packages' compress() with the same arguments (those left None
    are not passed: each package's defaults apply) write the same bytes,
    and each decodes the other's container."""
    kw = {} if mode is None else {"mode": mode}
    if backend is not None:
        kw["backend"] = backend
    tpu_kw, port_kw = dict(kw), dict(kw)
    if confs is not None:
        tpu_kw["conf"], port_kw["conf"] = confs
    want = glz_tpu.compress(data, **tpu_kw)
    got = glz_tpu_torch.compress(data, device="cpu", **port_kw)
    assert got == want
    assert glz_tpu_torch.decompress(want, device="cpu") == data
    assert glz_tpu.decompress(got) == data
    return got


def test_default_container_c1():
    """No arguments: glz_tpu's default container (DEFAULT, backend "host"),
    81,544 bytes; the port wrote 81,545 (a word-alignment pad) before."""
    blob = _same(c1_input())
    assert len(blob) == 81_544
    f = port_container.read_container(blob)
    assert (f.layout, f.stream_symbols) == (port_container.LAYOUT_BITSTREAM, 1 << 18)


# mode, backend, preset; None leaves the argument to its default.  A
# lockstep preset takes no backend but the default and "device" (both
# packages write the lockstep layout whatever the backend).
CALLS = [(mode, backend, preset) for mode in (None, "byte", "huffword")
         for backend in (None, "host", "device")
         for preset in (None, "DEFAULT", "RATIO", "THROUGHPUT")
         if not (preset == "THROUGHPUT" and backend == "host")]


@pytest.mark.parametrize("mode,backend,preset", CALLS)
def test_same_call_same_bytes(text_100kb, mode, backend, preset):
    """Every combination of mode, backend and preset, each also left to
    its default."""
    lockstep_hw = mode == "huffword" and (backend == "device" or preset == "THROUGHPUT")
    data = text_100kb[:20_000] if lockstep_hw else text_100kb
    confs = None if preset is None else _confs(preset, checksum=True)
    # THROUGHPUT's 64 rows exceed the HuffWord rows cap at 512 tokens a stream
    capped = lockstep_hw and preset == "THROUGHPUT"
    with pytest.warns(UserWarning, match="group_rows") if capped else contextlib.nullcontext():
        _same(data, None if mode is None else MODES[mode], backend, confs)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_histogram_budget(text_1mb, backend):
    """A bitstream configuration with a histogram budget: the host backend
    counts every byte, the device backend samples."""
    confs = _confs("DEFAULT", histogram_budget=1 << 14, stream_symbols=1 << 16)
    blob = _same(text_1mb, cfg.MODE_BYTE, backend, confs)
    exact = glz_tpu_torch.compress(text_1mb, backend=backend, device="cpu",
                                   conf=dataclasses.replace(confs[1], histogram_budget=None))
    assert (blob == exact) == (backend == "host")


@pytest.mark.parametrize("n", [1, 2, 999, 1001, 4096, 12_345])
@pytest.mark.parametrize("backend", ["host", "device"])
def test_ragged_sizes(binary_100kb, backend, n):
    """Sizes around the stream size (S = 1000, not a power of two), the
    last stream ragged, and one byte."""
    _same(binary_100kb[:n], cfg.MODE_BYTE, backend, _confs("DEFAULT", stream_symbols=1000))


@pytest.mark.parametrize("data", [b"", b"x"], ids=["empty", "one_byte"])
@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("mode", ["byte", "huffword"])
def test_empty_and_one_byte(data, backend, mode):
    _same(data, MODES[mode], backend)
    _same(data, MODES[mode], backend, _confs("DEFAULT", checksum=True))


def test_host_layout_across_dispatches(monkeypatch, text_1mb):
    """MAX_DISPATCH_SYMBOLS shrunk to 2^17 in the port: eight dispatches,
    each packed from the bits before it; the container is the host
    encoder's and does not depend on the split."""
    confs = _confs("DEFAULT", stream_symbols=1 << 14, checksum=True)
    data = text_1mb[: (1 << 20) - 777]
    whole = _same(data, cfg.MODE_BYTE, "host", confs)
    monkeypatch.setattr(port_model, "MAX_DISPATCH_SYMBOLS", 1 << 17)
    assert glz_tpu_torch.compress(data, conf=confs[1], device="cpu") == whole
    monkeypatch.setattr(port_model, "MAX_DISPATCH_SYMBOLS", 1000 * 77)  # dispatches of 77 streams
    ragged = _confs("DEFAULT", stream_symbols=1000)
    assert glz_tpu_torch.compress(data, conf=ragged[1], device="cpu") == \
        glz_tpu.compress(data, conf=ragged[0])


def test_host_shared_codebook(text_1mb, text_100kb):
    """compress_bytes_host with a codebook carried across by its lengths,
    and with an empty input (the codebook's lengths are still written)."""
    tpu_cb = tpu_codebook.build_codebook(
        tpu_codebook.histogram_bytes(np.frombuffer(text_1mb, np.uint8)), 32)
    port_cb = glz_tpu_torch.codebook_from_lengths(tpu_cb.lengths)
    tpu_conf, port_conf = _confs("DEFAULT", stream_symbols=1 << 13)
    for data in (text_100kb[:77_777], b""):
        want = tpu_api.compress_bytes_host(data, tpu_conf, codebook=tpu_cb)
        assert port_model.compress_bytes_host(data, port_conf, codebook=port_cb,
                                              device="cpu") == want


@pytest.mark.parametrize("backend", [None, "host", "device"])
def test_huffword_shared(text_100kb, realtext, backend):
    """compress_huffword_shared with each backend ("device" writes lockstep
    containers under DEFAULT)."""
    files = [text_100kb[:30_000], b"  ...  " + realtext[:20_000], b""]
    kw = {} if backend is None else {"backend": backend}
    want = tpu_hw.compress_huffword_shared(files, tpu_cfg.DEFAULT, **kw)
    got = glz_tpu_torch.compress_huffword_shared(files, cfg.DEFAULT, device="cpu", **kw)
    assert got == want
    assert [glz_tpu_torch.decompress(b, device="cpu") for b in want] == files
    layout = port_container.read_container(got[0]).layout
    assert (layout == port_container.LAYOUT_LOCKSTEP) == (backend == "device")


def test_decompress_takes_glz_tpu_arguments(text_100kb):
    """Every backend and decoder variant decodes (on the device given); an
    unknown variant raises; an unknown backend means "host" in both
    packages, for compress and decompress."""
    blob = glz_tpu.compress(text_100kb)
    for backend in ("host", "device"):
        for variant in (cfg.DECODER_BITWALK, cfg.DECODER_FAST, cfg.DECODER_TABLE,
                        cfg.DECODER_DEVICE):
            assert glz_tpu_torch.decompress(blob, backend, variant, device="cpu") == text_100kb
    assert glz_tpu_torch.decompress(blob, backend="tpu", device="cpu") \
        == glz_tpu.decompress(blob, backend="tpu") == text_100kb
    with pytest.raises(ValueError, match="variant"):
        glz_tpu_torch.decompress(blob, variant="fastest", device="cpu")
    assert glz_tpu_torch.compress(text_100kb, backend="tpu", device="cpu") \
        == glz_tpu.compress(text_100kb, backend="tpu") == blob


@pytest.mark.parametrize("mode", [cfg.MODE_BYTE, cfg.MODE_HUFFWORD, cfg.MODE_NORMAL_TREE],
                         ids=["byte", "huffword", "normal_tree"])
def test_unknown_backend_means_host(text_100kb, mode):
    """backend="cpu" (glz_tpu routes only "device"; any other backend is
    the host's): the same container as glz_tpu's for the same call, and as
    backend "host"'s, and it decodes under that backend."""
    data = text_100kb[:30_000]
    blob = _same(data, mode, "cpu")
    assert blob == glz_tpu_torch.compress(data, mode=mode, device="cpu")
    assert glz_tpu_torch.decompress(blob, backend="cpu", device="cpu") == data
    assert glz_tpu.decompress(blob, backend="cpu") == data


@pytest.mark.parametrize("mode", [cfg.MODE_BYTE, cfg.MODE_HUFFWORD], ids=["byte", "huffword"])
def test_unknown_backend_batch_and_archive(text_100kb, mode):
    """compress_batch and compress_archive with backend="cpu" write
    glz_tpu's bytes for the same call; decompress_batch and
    decompress_archive with it give the files back."""
    files = [text_100kb[:20_000], text_100kb[50_000:61_000], b""]
    blobs = glz_tpu_torch.compress_batch(files, mode=mode, backend="cpu", device="cpu")
    assert blobs == glz_tpu.compress_batch(files, mode=mode, backend="cpu")
    assert glz_tpu_torch.decompress_batch(blobs, backend="cpu", device="cpu") == files
    arc = glz_tpu_torch.compress_archive(files, mode=mode, backend="cpu", device="cpu")
    assert arc == glz_tpu.compress_archive(files, mode=mode, backend="cpu")
    assert glz_tpu_torch.decompress_archive(arc, backend="cpu", device="cpu") == files


def test_pinned_host_digests(realtext):
    """The host-container digests chip_smoke.py checks on the card are
    glz_tpu.compress's with its defaults."""
    text = realtext[: 1 << 20]
    pins = {k: v for k, v in chip_smoke.bitstream_pinned_configs().items()
            if v[1] == cfg.MODE_BYTE and v[2] == "host"}
    assert set(pins) == {"byte_default_host", "byte_ratio_host"}
    for key, (port_conf, mode, backend) in pins.items():
        tpu_conf = tpu_cfg.GlzConfig(**dataclasses.asdict(port_conf))
        assert hashlib.sha256(glz_tpu.compress(text, conf=tpu_conf)).hexdigest() \
            == chip_smoke.BITSTREAM_PINNED[key]
        blob = glz_tpu_torch.compress(text, mode=mode, backend=backend, conf=port_conf,
                                      device="cpu")
        assert hashlib.sha256(blob).hexdigest() == chip_smoke.BITSTREAM_PINNED[key]
