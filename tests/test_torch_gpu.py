"""glz_tpu_torch's CUDA kernels against their plain PyTorch versions, and its
entry points, on the card.  Skipped where torch.cuda.is_available() is false; run on a machine
with a card (no JAX needed there) with

    GLZ_TEST_TPU=1 python -m pytest -m gpu tests/test_torch_gpu.py

(GLZ_TEST_TPU=1 keeps tests/conftest.py from importing JAX.)
"""

import dataclasses
import hashlib

import pytest
import torch

import chip_smoke
import glz_tpu_torch
from glz_tpu_torch.models import canonical_byte as port_model
from glz_tpu_torch.ops import _kernels

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
