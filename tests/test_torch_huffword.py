"""glz_tpu_torch's HuffWord lockstep codec against glz_tpu on the CPU.

The contract is the bytes: for the same input and configuration the port
writes a HuffWord container byte-identical to glz_tpu.compress(...,
mode=MODE_HUFFWORD), and each package decodes the other's.  glz_tpu runs as
its own tests run it (JAX on the CPU, Pallas in interpret mode); the port
runs its kernels' plain PyTorch versions (device='cpu').  The cases follow
tests/test_huffword_device.py.
"""

import dataclasses
import hashlib
import warnings

import numpy as np
import pytest

import glz_tpu
from glz_tpu import config as tpu_cfg
from glz_tpu.core import container as tpu_container
from glz_tpu.models import canonical_byte as tpu_cb_model
from glz_tpu.models import huffword as tpu_hw

import chip_smoke
import glz_tpu_torch
from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import container as port_container
from glz_tpu_torch.core import lockstep as port_lockstep
from glz_tpu_torch.core.codebook import codebook_from_lengths
from glz_tpu_torch.models import huffword as port_hw
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HW = cfg.MODE_HUFFWORD


def _confs(S, **kw):
    """The same HuffWord lockstep configuration in both packages."""
    return (tpu_cfg.GlzConfig(stream_symbols=S, layout=tpu_cfg.LAYOUT_LOCKSTEP, **kw),
            cfg.GlzConfig(stream_symbols=S, layout=cfg.LAYOUT_LOCKSTEP, **kw))


def _port_compress(data, conf):
    return glz_tpu_torch.compress(data, mode=HW, conf=conf, device="cpu")


def _port_decompress(blob):
    return glz_tpu_torch.decompress(blob, device="cpu")


def _same_bytes_and_cross_decode(data, tpu_conf, port_conf):
    """Both packages write the same container; each decodes it."""
    tpu_blob = glz_tpu.compress(data, mode=tpu_cfg.MODE_HUFFWORD, conf=tpu_conf)
    port_blob = _port_compress(data, port_conf)
    assert port_blob == tpu_blob
    assert _port_decompress(tpu_blob) == data
    assert glz_tpu.decompress(port_blob) == data
    return port_blob


def test_containers_identical_text_1mb(text_1mb):
    blob = _same_bytes_and_cross_decode(text_1mb, *_confs(64))
    f = port_container.read_container(blob)
    assert (f.mode, f.layout) == (HW, port_container.LAYOUT_LOCKSTEP)


@pytest.mark.parametrize("cut", [1, 7, 333])
def test_containers_identical_ragged(text_100kb, cut):
    _same_bytes_and_cross_decode(text_100kb[: 50_000 - cut], *_confs(64))


@pytest.mark.parametrize("rows", [8, 16, 32, 64])
def test_containers_identical_rows(realtext, rows):
    blob = _same_bytes_and_cross_decode(realtext[:150_000], *_confs(64, group_rows=rows))
    assert port_container.read_container(blob).group_rows == rows


def test_checksum_identical_and_detects_corruption(text_100kb):
    blob = _same_bytes_and_cross_decode(text_100kb, *_confs(64, checksum=True))
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x0F
    with pytest.raises(ValueError, match="checksum|corrupt"):
        _port_decompress(bytes(bad))


def test_nonword_first(text_100kb):
    data = b"  ...  " + text_100kb[:30_000]
    blob = _same_bytes_and_cross_decode(data, *_confs(64))
    word_first, *_ = port_hw.huffword_state_from_blob(
        port_container.read_container(blob).codebook_blob)
    assert not word_first


def test_binaryish():
    rng = np.random.default_rng(0x61F3)
    p = rng.dirichlet(np.ones(256) * 0.03)
    data = rng.choice(256, size=60_000, p=p).astype(np.uint8).tobytes()
    _same_bytes_and_cross_decode(data, *_confs(64))


def test_single_symbol_dictionaries():
    """One distinct word and one distinct separator: both dictionaries
    have a single 1-bit code."""
    _same_bytes_and_cross_decode(b"word " * 20_000, *_confs(64))


@pytest.mark.parametrize("data", [b"a", b" "])
def test_one_token(data):
    """T = 1: one dictionary is empty (min_len = max_len = 0)."""
    _same_bytes_and_cross_decode(data, *_confs(64, checksum=True))


def test_big_vocab_u32_ids():
    """More than 64K distinct words: u32 ids and ranks, and the rows cap of
    the u32 path (rows 32 at S 256, requested 64)."""
    data = chip_smoke.big_vocab_text()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        blob = _same_bytes_and_cross_decode(data, *_confs(256, group_rows=64))
    assert sum("group_rows=64" in str(w.message) for w in caught) == 2
    f = port_container.read_container(blob)
    _, cb_w, _, wv, _ = port_hw.huffword_state_from_blob(f.codebook_blob)
    assert wv.n > 0xFFFF and f.group_rows == 32


@pytest.mark.parametrize("checksum", [False, True])
def test_empty_input(checksum):
    tpu_conf, port_conf = _confs(64, checksum=checksum)
    blob = _same_bytes_and_cross_decode(b"", tpu_conf, port_conf)
    assert port_container.read_container(blob).n_symbols == 0


def test_rows_cap_warns_like_reference(text_100kb):
    """rows 64 at S 512 with small vocabularies is capped to 32, loudly, by
    both packages."""
    tpu_conf, port_conf = _confs(512, group_rows=64)
    with pytest.warns(UserWarning, match="group_rows=64"):
        want = glz_tpu.compress(text_100kb, mode=tpu_cfg.MODE_HUFFWORD, conf=tpu_conf)
    with pytest.warns(UserWarning, match="group_rows=64"):
        got = _port_compress(text_100kb, port_conf)
    assert got == want
    assert port_container.read_container(got).group_rows == 32
    assert port_lockstep.huffword_rows_cap(512, True) == tpu_hw.huffword_rows_cap(512, True) == 32
    assert port_lockstep.huffword_rows_cap(128, False) == tpu_hw.huffword_rows_cap(128, False) == 64


@pytest.mark.parametrize("preset", ["THROUGHPUT", "RATIO", "DEFAULT"])
def test_byte_preset_stream_sizes(text_100kb, preset):
    """A byte preset's stream size carries no HuffWord preference: both
    packages pick 512 tokens per stream (RATIO's 2^19 raised in the port
    before it had RATIO)."""
    confs = [dataclasses.replace(getattr(c, preset), layout=c.LAYOUT_LOCKSTEP, group_rows=8)
             for c in (tpu_cfg, cfg)]
    blob = _same_bytes_and_cross_decode(text_100kb, *confs)
    assert port_container.read_container(blob).stream_symbols == 512


def test_rejects_bad_stream_symbols(text_100kb):
    for S in (100, 2048, 32):
        with pytest.raises(ValueError, match="stream_symbols"):
            _port_compress(text_100kb, _confs(S)[1])
    with pytest.raises(ValueError, match="group_rows"):
        _port_compress(text_100kb, _confs(64, group_rows=12)[1])


def test_multi_dispatch(monkeypatch, realtext):
    """glz_tpu encodes in dispatches of LOCKSTEP_DISPATCH tokens; shrunk to
    one group it splits this input into three launches, and the port's
    single launch writes the same bytes."""
    group = 8 * 128 * 64
    monkeypatch.setattr(tpu_cb_model, "LOCKSTEP_DISPATCH", group)
    data = realtext[:580_000]  # ~3.5 bytes per token: 2.5 groups
    blob = _same_bytes_and_cross_decode(data, *_confs(64))
    assert port_container.read_container(blob).n_streams == 3


@pytest.mark.parametrize("pipeline", [False, True])
def test_shared_codebook_matches_reference(text_100kb, realtext, pipeline):
    """Two files and an empty one with one shared dual codebook."""
    files = [text_100kb, b"  ...  " + realtext[:150_000], b""]
    tpu_conf, port_conf = _confs(64, checksum=True)
    want = tpu_hw.compress_huffword_shared(files, tpu_conf, pipeline=pipeline)
    got = glz_tpu_torch.compress_huffword_shared(files, port_conf, pipeline=pipeline,
                                                 device="cpu")
    assert got == want
    assert [_port_decompress(b) for b in want] == files
    assert [glz_tpu.decompress(b) for b in got] == files
    # the bitstream layout: the same call under DEFAULT writes glz_tpu's bytes
    assert (glz_tpu_torch.compress_huffword_shared(files[1:], cfg.DEFAULT, device="cpu")
            == tpu_hw.compress_huffword_shared(files[1:], tpu_cfg.DEFAULT))


def test_state_from_blob_matches_reference(realtext):
    """The codec state a glz_tpu container carries: codebooks rebuilt from
    its code lengths and the vocabularies' token text."""
    conf = _confs(64)[0]
    blob = glz_tpu.compress(realtext[:200_000], mode=tpu_cfg.MODE_HUFFWORD, conf=conf)
    f = tpu_container.read_container(blob)
    word_first, cb_w, cb_n, wv, nv = port_hw.huffword_state_from_blob(f.codebook_blob)
    mv = memoryview(f.codebook_blob)
    assert word_first == bool(mv[0])
    wl, woff, wblob, off = tpu_hw._decode_dict_blob(mv, 1)
    nl, noff, nblob, _ = tpu_hw._decode_dict_blob(mv, off)
    for got, lengths, offsets, text in ((cb_w, wl, woff, wblob), (cb_n, nl, noff, nblob)):
        want = codebook_from_lengths(lengths)
        for field in ("lengths", "codewords", "symbols"):
            assert np.array_equal(getattr(got, field), getattr(want, field))
        assert (got.min_len, got.max_len) == (want.min_len, want.max_len)
    assert (wv.blob, nv.blob) == (wblob, nblob)
    assert np.array_equal(wv.offsets, woff) and np.array_equal(nv.offsets, noff)
    assert wv.counts is None
    for cut in (0, 1, 3, len(f.codebook_blob) // 2):
        with pytest.raises(ValueError, match="corrupt"):
            port_hw.huffword_state_from_blob(f.codebook_blob[:cut])


def test_pinned_digests(realtext):
    """The digests chip_smoke.py checks on the card are glz_tpu's."""
    text = realtext[: 1 << 20]
    tpu_confs = {"hw_s512_r32": chip_smoke.huffword_conf(),
                 "hw_s64_r8": chip_smoke.huffword_conf(64, 8),
                 "hw_ratio": chip_smoke.huffword_conf(base=cfg.RATIO)}
    tpu_confs = {k: tpu_cfg.GlzConfig(**dataclasses.asdict(c)) for k, c in tpu_confs.items()}
    for key, port_conf in chip_smoke.huffword_pinned_configs().items():
        tpu_blob = glz_tpu.compress(text, mode=tpu_cfg.MODE_HUFFWORD, conf=tpu_confs[key])
        assert hashlib.sha256(tpu_blob).hexdigest() == chip_smoke.HUFFWORD_PINNED[key]
        assert hashlib.sha256(_port_compress(text, port_conf)).hexdigest() \
            == chip_smoke.HUFFWORD_PINNED[key]
