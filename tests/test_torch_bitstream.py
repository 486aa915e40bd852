"""glz_tpu_torch's bitstream (layout 0) codec against glz_tpu on the CPU.

The contract is the bytes.  In byte mode these tests hold the port's
backend="device" container to glz_tpu's device path,
canonical_byte.compress_bytes_device (word-aligned dispatches of
MAX_DISPATCH_SYMBOLS symbols rounded down to whole streams; the default
backend="host" container is tests/test_torch_front_door.py's); in HuffWord
mode the port writes that of glz_tpu.compress(..., mode=MODE_HUFFWORD) and
compress_huffword_shared under a bitstream configuration.  The port decodes
every layout-0 container either package writes, the host encoder's
included, and glz_tpu decodes the port's.  glz_tpu runs as its own tests
run it (JAX on the CPU); the port runs its kernels' plain PyTorch versions
(device='cpu').
"""

import dataclasses
import hashlib

import numpy as np
import pytest

import glz_tpu
from glz_tpu import config as tpu_cfg
from glz_tpu.core import api as tpu_api
from glz_tpu.core import codebook as tpu_codebook
from glz_tpu.models import canonical_byte as tpu_cb_model
from glz_tpu.models import huffword as tpu_hw

import chip_smoke
import glz_tpu_torch
from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import container as port_container
from glz_tpu_torch.models import canonical_byte as port_model
from glz_tpu_torch.models import huffword as port_hw
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HW = cfg.MODE_HUFFWORD


def _confs(base: str = "DEFAULT", **kw):
    """The same bitstream configuration in both packages."""
    return tuple(dataclasses.replace(getattr(c, base), **kw) for c in (tpu_cfg, cfg))


def _port_compress(data, conf, mode=cfg.MODE_BYTE):
    """Byte mode through the device backend, HuffWord through the host
    backend (its bitstream container)."""
    backend = "device" if mode == cfg.MODE_BYTE else "host"
    return glz_tpu_torch.compress(data, mode=mode, backend=backend, conf=conf, device="cpu")


def _port_decompress(blob):
    return glz_tpu_torch.decompress(blob, device="cpu")


def _same_bytes_and_cross_decode(data, tpu_conf, port_conf):
    """The port writes compress_bytes_device's container; each package
    decodes it."""
    tpu_blob = tpu_cb_model.compress_bytes_device(data, tpu_conf)
    port_blob = _port_compress(data, port_conf)
    assert port_blob == tpu_blob
    assert _port_decompress(tpu_blob) == bytes(data)
    assert glz_tpu.decompress(port_blob) == bytes(data)
    return port_blob


def _same_huffword_bytes(data, tpu_conf, port_conf):
    """The port writes glz_tpu's HuffWord bitstream container; each package
    decodes it."""
    tpu_blob = glz_tpu.compress(data, mode=tpu_cfg.MODE_HUFFWORD, conf=tpu_conf)
    port_blob = _port_compress(data, port_conf, mode=HW)
    assert port_blob == tpu_blob
    assert _port_decompress(tpu_blob) == data
    assert glz_tpu.decompress(port_blob) == data
    f = port_container.read_container(port_blob)
    assert (f.mode, f.layout) == (HW, port_container.LAYOUT_BITSTREAM)
    return port_blob


# ---- byte mode ----------------------------------------------------------------

@pytest.mark.parametrize("base,kw", [
    ("DEFAULT", {}), ("DEFAULT", {"checksum": True}), ("RATIO", {"checksum": True}),
    ("DEFAULT", {"stream_symbols": 99_999}), ("DEFAULT", {"stream_symbols": 4096})])
def test_byte_containers_identical(realtext, base, kw):
    """DEFAULT, RATIO, a small stream size and one that is not a power of
    two (the TPU path encodes that one without K7, to the same bytes)."""
    blob = _same_bytes_and_cross_decode(realtext[: 1 << 20], *_confs(base, **kw))
    f = port_container.read_container(blob)
    assert f.layout == port_container.LAYOUT_BITSTREAM
    assert f.stream_symbols == kw.get("stream_symbols", getattr(cfg, base).stream_symbols)


@pytest.mark.parametrize("n", [(1 << 18) + 1, (1 << 18) - 1, 12345, 1])
def test_byte_ragged(text_1mb, n):
    _same_bytes_and_cross_decode(text_1mb[:n], *_confs())


def test_byte_binary(binary_100kb):
    _same_bytes_and_cross_decode(binary_100kb, *_confs(stream_symbols=1 << 12))


def test_byte_codes_of_27_to_32_bits():
    """Fibonacci symbol counts (29 symbols, 1.35 M bytes, shuffled): the
    DEFAULT codebook is 28 bits deep, past the lockstep path's 26."""
    fib = [1, 1]
    while len(fib) < 29:
        fib.append(fib[-1] + fib[-2])
    arr = np.repeat(np.arange(29, dtype=np.uint8) * 7, fib)
    arr = arr[np.random.default_rng(0x3232).permutation(arr.size)]
    blob = _same_bytes_and_cross_decode(arr, *_confs(stream_symbols=1 << 16))
    f = port_container.read_container(blob)
    assert port_container.decode_byte_codebook(f.codebook_blob).max() >= 27


@pytest.mark.parametrize("checksum", [False, True])
def test_byte_empty(checksum):
    """Empty input: glz_tpu returns compress_bytes_host's container."""
    tpu_conf, port_conf = _confs(checksum=checksum)
    blob = _port_compress(b"", port_conf)
    assert blob == tpu_api.compress_bytes_host(b"", tpu_conf)
    assert blob == port_model.empty_container(port_conf)
    assert _port_decompress(blob) == b"" and glz_tpu.decompress(blob) == b""


def test_byte_multi_dispatch(monkeypatch, text_1mb):
    """MAX_DISPATCH_SYMBOLS shrunk to 2^17 in both packages: eight word-
    aligned dispatches, each inflating its last stream's recorded bits."""
    monkeypatch.setattr(tpu_cb_model, "MAX_DISPATCH_SYMBOLS", 1 << 17)
    monkeypatch.setattr(port_model, "MAX_DISPATCH_SYMBOLS", 1 << 17)
    tpu_conf, port_conf = _confs(stream_symbols=1 << 14, checksum=True)
    data = text_1mb[: (1 << 20) - 777]
    blob = _same_bytes_and_cross_decode(data, tpu_conf, port_conf)
    monkeypatch.setattr(port_model, "MAX_DISPATCH_SYMBOLS", 1 << 27)
    assert _port_compress(data, port_conf) != blob  # the split is part of the container


def test_byte_max_streams_rule(monkeypatch, text_1mb):
    """RATIO's rule at a small size: max_streams caps the stream count, so S
    becomes ceil(n / max_streams), not a power of two, and a dispatch is a
    whole number of those streams."""
    monkeypatch.setattr(tpu_cb_model, "MAX_DISPATCH_SYMBOLS", 1 << 17)
    monkeypatch.setattr(port_model, "MAX_DISPATCH_SYMBOLS", 1 << 17)
    data = text_1mb[:700_001]
    blob = _same_bytes_and_cross_decode(data, *_confs("RATIO", max_streams=9,
                                                      stream_symbols=4096))
    f = port_container.read_container(blob)
    assert f.stream_symbols == -(-len(data) // 9) and f.n_streams == 9


def test_byte_shared_codebook(text_1mb, text_100kb):
    """A codebook carried across by its lengths encodes the same bytes."""
    tpu_cb = tpu_codebook.build_codebook(
        tpu_codebook.histogram_bytes(np.frombuffer(text_1mb, np.uint8)), 32)
    port_cb = glz_tpu_torch.codebook_from_lengths(tpu_cb.lengths)
    tpu_conf, port_conf = _confs(stream_symbols=1 << 13)
    data = text_100kb[:77777]
    blob = tpu_cb_model.compress_bytes_device(data, tpu_conf, codebook=tpu_cb)
    assert port_model.compress_bytes_device(data, port_conf, codebook=port_cb,
                                            device="cpu") == blob
    assert _port_decompress(blob) == data


@pytest.mark.parametrize("base,kw", [("DEFAULT", {}), ("RATIO", {"checksum": True}),
                                     ("DEFAULT", {"stream_symbols": 1000})])
def test_byte_decodes_host_containers(realtext, base, kw):
    """compress_bytes_host's containers (byte-aligned, ones-padded, no
    inflated streams) decode on the port, and differ from the device
    path's."""
    tpu_conf, port_conf = _confs(base, **kw)
    data = realtext[: 1 << 20]
    blob = tpu_api.compress_bytes_host(data, tpu_conf)
    assert _port_decompress(blob) == data
    assert blob != _port_compress(data, port_conf)


def test_byte_checksum_detects_corruption(text_100kb):
    blob = _same_bytes_and_cross_decode(text_100kb, *_confs(stream_symbols=4096,
                                                            checksum=True))
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x55
    with pytest.raises(ValueError, match="checksum|corrupt"):
        _port_decompress(bytes(bad))


def test_byte_rejects_short_stream_table(text_100kb):
    f = port_container.read_container(_port_compress(text_100kb,
                                                     _confs(stream_symbols=4096)[1]))
    short = dataclasses.replace(f, stream_bits=f.stream_bits[:-1])
    with pytest.raises(ValueError, match="stream table too short"):
        _port_decompress(port_container.write_container(short))


# ---- HuffWord -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["text", "nonword_first", "one_word", "one_separator",
                                  "empty", "binaryish"])
def test_huffword_containers_identical(text_1mb, name):
    data = {"text": text_1mb, "nonword_first": b"  ...  " + text_1mb[:300_000],
            "one_word": b"a", "one_separator": b" ", "empty": b"",
            "binaryish": bytes(np.random.default_rng(7).integers(0, 256, 60_000,
                                                                 dtype=np.uint8))}[name]
    _same_huffword_bytes(data, *_confs(checksum=True))


def test_huffword_big_vocab():
    """More than 64K distinct words: u32 ids and ranks."""
    blob = _same_huffword_bytes(chip_smoke.big_vocab_text(), *_confs())
    _, _, _, wv, _ = port_hw.huffword_state_from_blob(
        port_container.read_container(blob).codebook_blob)
    assert wv.n > 0xFFFF


@pytest.mark.parametrize("S", [1001, 4096])
def test_huffword_stream_sizes(realtext, S):
    """Odd stream sizes start every other stream on the odd dictionary."""
    blob = _same_huffword_bytes(realtext[:300_000], *_confs(stream_symbols=S))
    assert port_container.read_container(blob).stream_symbols == S


def test_huffword_max_streams(realtext):
    blob = _same_huffword_bytes(realtext[:200_000], *_confs(stream_symbols=512,
                                                            max_streams=5))
    f = port_container.read_container(blob)
    assert f.n_streams == 5 and f.stream_symbols == -(-f.n_symbols // 5)


def test_huffword_checksum_detects_corruption(text_100kb):
    blob = _same_huffword_bytes(text_100kb, *_confs(checksum=True))
    bad = bytearray(blob)
    bad[-100] ^= 0x0F
    with pytest.raises(ValueError, match="checksum|corrupt"):
        _port_decompress(bytes(bad))


@pytest.mark.parametrize("pipeline", [False, True])
def test_huffword_shared_matches_reference(text_100kb, realtext, pipeline):
    """Two files and an empty one with one shared dual codebook, bitstream
    layout (code lengths up to conf.length_limit)."""
    files = [text_100kb, b"  ...  " + realtext[:150_000], b""]
    tpu_conf, port_conf = _confs(checksum=True)
    want = tpu_hw.compress_huffword_shared(files, tpu_conf, pipeline=pipeline)
    got = glz_tpu_torch.compress_huffword_shared(files, port_conf, pipeline=pipeline,
                                                 device="cpu")
    assert got == want
    assert [_port_decompress(b) for b in want] == files


# ---- pinned digests ---------------------------------------------------------------

def test_pinned_digests(realtext):
    """The digests chip_smoke.py checks on the card are glz_tpu's, with the
    same mode and backend (the host containers' are pinned by
    tests/test_torch_front_door.py)."""
    text = realtext[: 1 << 20]
    tpu_confs = {k: tpu_cfg.GlzConfig(**dataclasses.asdict(c))
                 for k, (c, _, _) in chip_smoke.bitstream_pinned_configs().items()}
    for key, (port_conf, mode, backend) in chip_smoke.bitstream_pinned_configs().items():
        if backend == "host" and mode == cfg.MODE_BYTE:
            continue
        if mode == HW:
            tpu_blob = glz_tpu.compress(text, mode=tpu_cfg.MODE_HUFFWORD, conf=tpu_confs[key])
        else:
            tpu_blob = tpu_cb_model.compress_bytes_device(text, tpu_confs[key])
        assert hashlib.sha256(tpu_blob).hexdigest() == chip_smoke.BITSTREAM_PINNED[key]
        assert hashlib.sha256(_port_compress(text, port_conf, mode)).hexdigest() \
            == chip_smoke.BITSTREAM_PINNED[key]
