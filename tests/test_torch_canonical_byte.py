"""glz_tpu_torch's byte-mode lockstep codec against glz_tpu on the CPU.

The contract is the bytes: for the same input, configuration and
(stream_symbols, group_rows), the port writes a container byte-identical to
glz_tpu's, and each package decodes the other's.  glz_tpu runs as its own
tests run it (JAX on the CPU, Pallas in interpret mode); the port runs its
kernels' plain PyTorch versions (device='cpu').
"""

import dataclasses
import hashlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import glz_tpu
from glz_tpu import config as tpu_cfg
from glz_tpu.core import codebook as tpu_codebook
from glz_tpu.models import canonical_byte as tpu_cb_model

import chip_smoke
import glz_tpu_torch
from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import container as port_container
from glz_tpu_torch.models import canonical_byte as port_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _confs(S, **kw):
    """The same lockstep configuration in both packages."""
    return (tpu_cfg.GlzConfig(stream_symbols=S, layout=tpu_cfg.LAYOUT_LOCKSTEP, **kw),
            cfg.GlzConfig(stream_symbols=S, layout=cfg.LAYOUT_LOCKSTEP, **kw))


def _port_compress(data, conf, **kw):
    return glz_tpu_torch.compress(data, conf=conf, device="cpu", **kw)


def _port_decompress(blob):
    return glz_tpu_torch.decompress(blob, device="cpu")


def _same_bytes_and_cross_decode(data, tpu_conf, port_conf):
    """Both packages write the same container; each decodes it."""
    tpu_blob = tpu_cb_model.compress_bytes_lockstep(data, tpu_conf)
    port_blob = _port_compress(data, port_conf)
    assert port_blob == tpu_blob
    assert _port_decompress(tpu_blob) == data
    assert tpu_cb_model.decompress_bytes_lockstep(port_blob) == data
    return port_blob


# ---- the slice as a whole --------------------------------------------------

@pytest.mark.parametrize("n_off", [0, 1, 12345])
def test_containers_identical_ragged(text_1mb, n_off):
    data = text_1mb[: (1 << 19) - n_off]
    _same_bytes_and_cross_decode(data, *_confs(256))


@pytest.mark.parametrize("rows", [8, 16, 32, 64])
def test_containers_identical_rows(text_1mb, rows):
    data = text_1mb[: rows * 128 * 64 + 12345]
    blob = _same_bytes_and_cross_decode(data, *_confs(64, group_rows=rows))
    assert port_container.read_container(blob).group_rows == rows


def test_checksum_identical_and_detects_corruption(text_100kb):
    blob = _same_bytes_and_cross_decode(text_100kb, *_confs(128, checksum=True))
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x55  # mid-payload
    with pytest.raises(ValueError, match="checksum|corrupt"):
        _port_decompress(bytes(bad))


def test_rejects_bad_geometry(text_100kb):
    for S in (1 << 18, 100, 32):
        with pytest.raises(ValueError, match="stream_symbols"):
            _port_compress(text_100kb, _confs(S)[1])
    with pytest.raises(ValueError, match="group_rows"):
        _port_compress(text_100kb, _confs(64, group_rows=12)[1])


def test_caps_code_length(rng):
    """The reference's length-cap input (a skewed 40-symbol alphabet):
    both packages cap the lengths at 26 and write the same bytes."""
    reps = [1 << min(i, 22) for i in range(40)]
    arr = np.repeat(np.arange(40, dtype=np.uint8), reps[::-1])
    data = arr[rng.permutation(arr.size)][: 1 << 20].tobytes()
    blob = _same_bytes_and_cross_decode(data, *_confs(256))
    f = port_container.read_container(blob)
    assert int(port_container.decode_byte_codebook(f.codebook_blob).max()) <= 26


@pytest.mark.parametrize("checksum", [False, True])
def test_empty_input(checksum):
    tpu_conf, port_conf = _confs(512, checksum=checksum)
    blob = _port_compress(b"", port_conf)
    assert blob == tpu_cb_model.compress_bytes_lockstep(b"", tpu_conf)
    assert len(blob) == 165 + 4 * checksum
    assert _port_decompress(blob) == b""
    assert glz_tpu.decompress(blob) == b""


def test_shared_codebook(text_1mb, text_100kb):
    """A codebook carried across by its lengths encodes the same bytes."""
    tpu_cb = tpu_codebook.build_codebook(
        tpu_codebook.histogram_bytes(np.frombuffer(text_1mb, np.uint8)), 26)
    port_cb = glz_tpu_torch.codebook_from_lengths(tpu_cb.lengths)
    tpu_conf, port_conf = _confs(128, group_rows=16)
    data = text_100kb[:77777]
    blob = tpu_cb_model.compress_bytes_lockstep(data, tpu_conf, codebook=tpu_cb)
    assert port_model.compress_bytes_lockstep(data, port_conf, codebook=port_cb,
                                              device="cpu") == blob
    assert _port_decompress(blob) == data
    deep = glz_tpu_torch.codebook_from_lengths(np.minimum(np.arange(256), 27) + 1)
    with pytest.raises(ValueError, match="fused-entry limit"):
        port_model.compress_bytes_lockstep(data, port_conf, codebook=deep, device="cpu")


def test_multi_dispatch(monkeypatch, text_1mb):
    """glz_tpu encodes in dispatches of LOCKSTEP_DISPATCH symbols; shrunk to
    one group it splits this input into three launches, and the port's
    single launch writes the same bytes."""
    tpu_conf, port_conf = _confs(64)
    group = 8 * 128 * 64
    monkeypatch.setattr(tpu_cb_model, "LOCKSTEP_DISPATCH", group)
    data = text_1mb[: 3 * group - 5000]
    _same_bytes_and_cross_decode(data, tpu_conf, port_conf)


def test_pinned_digests(realtext):
    """The digests chip_smoke.py checks on the card are glz_tpu's."""
    text = realtext[: 1 << 20]
    tpu_confs = {"throughput": dataclasses.replace(tpu_cfg.THROUGHPUT, checksum=True)}
    tpu_confs["rows8_s256"] = dataclasses.replace(tpu_confs["throughput"], group_rows=8,
                                                  stream_symbols=256)
    for key, port_conf in chip_smoke.pinned_configs().items():
        tpu_blob = tpu_cb_model.compress_bytes_lockstep(text, tpu_confs[key])
        assert hashlib.sha256(tpu_blob).hexdigest() == chip_smoke.PINNED[key]
        assert hashlib.sha256(_port_compress(text, port_conf)).hexdigest() \
            == chip_smoke.PINNED[key]


# ---- imports and devices ---------------------------------------------------

def test_imports_nothing_of_jax_or_glz_tpu():
    code = (
        "import sys, glz_tpu_torch\n"
        "from glz_tpu_torch import config as cfg\n"
        "blob = glz_tpu_torch.compress(b'abracadabra' * 999, device='cpu')\n"
        "assert glz_tpu_torch.decompress(blob, device='cpu') == b'abracadabra' * 999\n"
        "text = b'the cat-sat on its mat, twice. ' * 999\n"
        "for conf in (cfg.GlzConfig(stream_symbols=64, layout=cfg.LAYOUT_LOCKSTEP), cfg.DEFAULT):\n"
        "    for mode in (cfg.MODE_BYTE, cfg.MODE_HUFFWORD):\n"
        "        blob = glz_tpu_torch.compress(text, mode=mode, conf=conf, device='cpu')\n"
        "        assert glz_tpu_torch.decompress(blob, device='cpu') == text\n"
        "blob = glz_tpu_torch.compress(text, mode=cfg.MODE_NORMAL_TREE, device='cpu')\n"
        "assert glz_tpu_torch.decompress(blob, device='cpu') == text\n"
        "for mode in (cfg.MODE_BYTE, cfg.MODE_HUFFWORD):\n"
        "    arc = glz_tpu_torch.compress_archive([text, text[:99]], mode=mode, device='cpu')\n"
        "    assert glz_tpu_torch.decompress_archive(arc, device='cpu') == [text, text[:99]]\n"
        "import chip_smoke, glz_tpu_torch.models\n"
        "bad = [m for m in sys.modules if m.startswith('jax') or m == 'glz_tpu'\n"
        "       or m.startswith('glz_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_default_device_needs_a_card(monkeypatch):
    """Without device=, entry points run on the card; with no card they
    raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        glz_tpu_torch.compress(b"abc" * 100)
    blob = _port_compress(b"abc" * 100, cfg.THROUGHPUT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        glz_tpu_torch.decompress(blob)


def test_other_modes_and_layouts_are_later_slices(text_100kb):
    """The bitstream layout round-trips in both modes and both packages read
    each other's default containers, and so does the normal-tree mode: no
    mode is left to a later slice."""
    for mode in (cfg.MODE_BYTE, cfg.MODE_HUFFWORD):
        blob = glz_tpu_torch.compress(text_100kb, mode=mode, conf=cfg.DEFAULT, device="cpu")
        assert port_container.read_container(blob).layout == port_container.LAYOUT_BITSTREAM
        assert _port_decompress(blob) == text_100kb
        assert glz_tpu.decompress(blob) == text_100kb
        assert _port_decompress(glz_tpu.compress(text_100kb[:5000], mode=mode)) \
            == text_100kb[:5000]
    data = text_100kb[:5000]
    blob = glz_tpu_torch.compress(data, mode=cfg.MODE_NORMAL_TREE, device="cpu")
    assert blob == glz_tpu.compress(data, mode=cfg.MODE_NORMAL_TREE)
    assert _port_decompress(blob) == data
    with pytest.raises(ValueError, match="unsupported mode"):
        glz_tpu_torch.compress(data, mode=7, device="cpu")
