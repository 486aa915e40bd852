"""glz_tpu_torch's .crs2/.crs3/.crs formats (compat/glzip_format.py) against
glz_tpu's.

tests/test_compat.py's cases that need no reference binary: round trips,
edges, nonword-first text, header fields, the golden .crs3 fixture and
corrupt input.  Every file the port writes must be byte-identical to
glz_tpu's for the same input, and each package must read the other's.
"""

import pathlib
import struct

import numpy as np
import pytest

from glz_tpu.compat import glzip_format as tpu_gz

import glz_tpu_torch
from glz_tpu_torch.compat import glzip_format as gz
from glz_tpu_torch.config import MODE_HUFFWORD
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FORMATS = {"crs2": (gz.write_crs2, gz.read_crs2, tpu_gz.write_crs2, tpu_gz.read_crs2),
           "crs3": (gz.write_crs3, gz.read_crs3, tpu_gz.write_crs3, tpu_gz.read_crs3),
           "crs": (gz.write_crs, gz.read_crs, tpu_gz.write_crs, tpu_gz.read_crs)}


def same_file_both_ways(fmt: str, data: bytes) -> bytes:
    """The port's file for `data` equals glz_tpu's, each package reads
    it back to `data`; returns the file."""
    write, read, tpu_write, tpu_read = FORMATS[fmt]
    blob = write(data)
    assert blob == tpu_write(data)
    assert read(blob) == data
    assert tpu_read(blob) == data
    return blob


def test_crs2_roundtrip_ours(text_100kb):
    same_file_both_ways("crs2", text_100kb)


def test_crs_roundtrip_ours(text_100kb):
    same_file_both_ways("crs", text_100kb[:20_000])


@pytest.mark.parametrize("payload", [b"", b"a", b"ab" * 5, bytes(range(256))])
def test_crs_formats_edges(payload):
    blob = same_file_both_ways("crs2", payload)
    assert gz.read_crs2_ref(blob) == payload


def test_crs3_roundtrip(text_100kb):
    same_file_both_ways("crs3", text_100kb[:60_000])


def test_crs3_golden_fixture():
    """write_crs3 reproduces tests/fixtures/golden.crs3 byte for byte and
    read_crs3 decodes it."""
    fdir = pathlib.Path(__file__).parent / "fixtures"
    golden = (fdir / "golden.crs3").read_bytes()
    original = (fdir / "golden.crs3.txt").read_bytes()
    assert gz.read_crs3(golden) == original
    assert gz.write_crs3(original) == golden


# "a" and "  --  " leave one dictionary empty (but for its EOF pseudo-symbol)
@pytest.mark.parametrize("payload", [b"", b"a", b"hello world", b"  --  ",
                                     b"a-b c_d 'e", b"word " * 500])
def test_crs3_edges(payload):
    same_file_both_ways("crs3", payload)


def test_crs3_nonword_first(text_100kb):
    data = b"... " + text_100kb[:20_000]
    blob = same_file_both_ways("crs3", data)
    ia = gz._ArchiveReader(blob)
    ia.u32()
    ia.i32()
    ia.i32()
    assert ia.string() == b" "  # the first token's class comes first: non-words


def test_crs3_header_fields(text_100kb):
    """The archive preamble and the first dictionary's header follow the
    documented field sequence (canonical_huffword.h:311-358), and both
    packages' readers parse the same fields."""
    blob = same_file_both_ways("crs3", text_100kb[:10_000])
    (siglen,) = struct.unpack_from("<Q", blob, 0)
    assert blob[8 : 8 + siglen] == b"serialization::archive"
    ia, tia = gz._ArchiveReader(blob), tpu_gz._ArchiveReader(blob)
    assert ia.pos == tia.pos and ia.version == tia.version
    n_sym, max_len, min_len = ia.u32(), ia.i32(), ia.i32()
    assert (n_sym, max_len, min_len) == (tia.u32(), tia.i32(), tia.i32())
    assert 0 < min_len <= max_len <= 32
    assert n_sym > 1  # vocab + EOF pseudo-symbol


def test_huffword_container_smaller_than_crs3(text_1mb):
    """The HuffWord .glz container (a length-table codebook) undercuts the
    reference's .crs3 (a Boost archive with 8-byte string length prefixes
    and a u32 symbol_index a symbol)."""
    data = text_1mb[:500_000]
    ours = glz_tpu_torch.compress(data, mode=MODE_HUFFWORD, device="cpu")
    assert len(ours) <= len(same_file_both_ways("crs3", data))


def test_crs3_corrupt_raises():
    blob = gz.write_crs3(b"some words here")
    with pytest.raises(ValueError):
        gz.read_crs3(blob[:30])
    with pytest.raises(ValueError):
        gz.read_crs3(b"\x00" * 64)


def test_crs2_corrupt_raises(text_100kb):
    blob = gz.write_crs2(text_100kb[:5_000])
    with pytest.raises(ValueError, match="header truncated"):
        gz.read_crs2(blob[:100])
    with pytest.raises(ValueError, match="symbol count"):
        gz.read_crs2(text_100kb[:5_000])
    head = np.frombuffer(blob, ">u4", count=260)
    bad = head.copy()
    bad[259] = 40  # max_len past 32
    with pytest.raises(ValueError, match="corrupt .crs2 header"):
        gz.read_crs2(bad.tobytes() + blob[4 * 260 :])
    with pytest.raises(ValueError, match="corrupt .crs2 header"):
        gz.read_crs2(blob[: 4 * 260 + 4])  # the code tables cut short
    n_head = 260 + 2 * int(head[259])
    bad = np.frombuffer(blob, ">u4", count=n_head).copy()
    bad[260 + 2 * (int(head[258]) - 1)] = 1 << 20  # a start position past the symbols
    with pytest.raises(ValueError, match="past the symbols"):
        gz.read_crs2(bad.tobytes() + blob[4 * n_head :])


def test_crs3_roundtrip_realtext(realtext):
    same_file_both_ways("crs3", realtext[:150_000])


def test_crs2_realtext(realtext):
    same_file_both_ways("crs2", realtext[:300_000])


def test_huffword_smaller_than_crs3_realtext(realtext):
    data = realtext[:300_000]
    ours = glz_tpu_torch.compress(data, mode=MODE_HUFFWORD, device="cpu")
    assert len(ours) <= len(gz.write_crs3(data))
