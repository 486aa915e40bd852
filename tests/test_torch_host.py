"""glz_tpu_torch's host modules against glz_tpu: configuration, codebook
construction and the container.  Any difference in them changes the bytes,
so every table is compared exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from glz_tpu import config as tpu_cfg
from glz_tpu.core import api as tpu_api
from glz_tpu.core import bitio as tpu_bitio
from glz_tpu.core import codebook as tpu_codebook
from glz_tpu.core import container as tpu_container
from glz_tpu.utils import crc as tpu_crc

from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import bitio as port_bitio
from glz_tpu_torch.core import codebook as port_codebook
from glz_tpu_torch.core import container as port_container
from glz_tpu_torch.models.canonical_byte import decode_tables
from glz_tpu_torch.ops import decode_table
from glz_tpu_torch.utils import crc as port_crc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("limit", [None, 26, 12])
def test_codebook_matches_reference(rng, text_100kb, binary_100kb, limit):
    """Sampled histograms, lengths and every derived table agree."""
    geo = np.repeat(np.arange(40, dtype=np.uint8),
                    [1 << min(i, 22) for i in range(40)][::-1])
    for arr in (np.frombuffer(text_100kb, np.uint8), np.frombuffer(binary_100kb, np.uint8),
                geo[rng.permutation(geo.size)][: 1 << 20]):
        for budget in (None, 8 << 20, 16 << 10):
            h_port = port_codebook.sampled_histogram(arr, budget)
            assert np.array_equal(h_port, tpu_codebook.sampled_histogram(arr, budget))
            want = tpu_codebook.build_codebook(h_port, limit)
            got = port_codebook.build_codebook(h_port, limit)
            for field in ("lengths", "codewords", "first_code", "start_pos", "symbols"):
                assert np.array_equal(getattr(got, field), getattr(want, field)), field
            assert (got.min_len, got.max_len) == (want.min_len, want.max_len)
            assert np.array_equal(got.left_justified_codes(), want.left_justified_codes())
            assert np.array_equal(got.first_code_left_justified(),
                                  want.first_code_left_justified())
            assert np.array_equal(got.decode_offsets(), want.decode_offsets())
            shared = port_codebook.codebook_from_lengths(want.lengths)
            assert np.array_equal(shared.codewords, want.codewords)


def test_package_merge_fast_matches_reference(rng):
    """The vectorized package-merge (alphabets above 2048 symbols)."""
    freqs = np.maximum(rng.zipf(1.3, size=5000), 1).astype(np.int64)
    for limit in (16, 20):
        assert np.array_equal(port_codebook.package_merge_lengths_fast(freqs, limit),
                              tpu_codebook.package_merge_lengths_fast(freqs, limit))


def test_container_matches_reference():
    lengths = np.arange(256) % 20
    for rows, layout in ((8, 0), (64, 2)):
        kw = dict(mode=0, n_symbols=12345, stream_symbols=512,
                  stream_bits=np.array([128, 256, 0], np.uint64),
                  payload=bytes(range(256)) * 6, layout=layout, checksum=0xDEADBEEF,
                  group_rows=rows)
        blob = tpu_container.write_container(tpu_container.GlzFile(
            codebook_blob=tpu_container.encode_byte_codebook(lengths), **kw))
        assert port_container.write_container(port_container.GlzFile(
            codebook_blob=port_container.encode_byte_codebook(lengths), **kw)) == blob
        f = port_container.read_container(blob)
        assert (f.layout, f.group_rows, f.checksum) == (layout, rows, 0xDEADBEEF)
        assert np.array_equal(port_container.decode_byte_codebook(f.codebook_blob),
                              lengths)


def test_config_matches_reference():
    """Every preset glz_tpu.config defines exists in the port with the same
    fields: a missing one changes which stream size a HuffWord call picks."""
    presets = [name for name, value in vars(tpu_cfg).items()
               if isinstance(value, tpu_cfg.GlzConfig)]
    assert {"THROUGHPUT", "DEFAULT", "RATIO"} <= set(presets)
    for name in presets:
        assert isinstance(getattr(cfg, name, None), cfg.GlzConfig), name
        assert (dataclasses.asdict(getattr(cfg, name))
                == dataclasses.asdict(getattr(tpu_cfg, name))), name
    assert ([f.name for f in dataclasses.fields(cfg.GlzConfig)]
            == [f.name for f in dataclasses.fields(tpu_cfg.GlzConfig)])


@pytest.mark.parametrize("total_bits", [0, 1, 7, 8, 31, 32, 33, 1000, 32 * 64])
def test_bitio_matches_reference(rng, total_bits):
    """words_to_bytes (ones- and zero-padding of the last partial byte),
    bytes_to_words (big-endian words, zero-padded tail), pack_codes_msb and
    BitWriter (the .crs writer's: codes of 0-32 bits, flushed with 0s or
    1s)."""
    lens = rng.integers(0, 33, total_bits // 7 + 1, dtype=np.uint64)
    codes = rng.integers(0, 1 << 32, lens.size, dtype=np.uint64) & ((np.uint64(1) << lens) - 1)
    got_words, got_bits = port_bitio.pack_codes_msb(codes, lens)
    want_words, want_bits = tpu_bitio.pack_codes_msb(codes, lens)
    assert got_bits == want_bits == int(lens.sum())
    assert got_words.dtype == np.uint32 and np.array_equal(got_words, want_words)
    for pad in (0, 1):
        writers = port_bitio.BitWriter(), tpu_bitio.BitWriter()
        for w in writers:
            for c, n in zip(codes.tolist(), lens.tolist()):
                w.write_bits(c, n)
        assert writers[0].left_bits() == writers[1].left_bits()
        for w in writers:
            w.flush_bits(pad)
            w.write_bytes(b"\x5a")
        assert writers[0].getvalue() == writers[1].getvalue()
    words = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    for pad_ones in (True, False):
        got = port_bitio.words_to_bytes(words, total_bits, pad_ones)
        assert got == tpu_bitio.words_to_bytes(words, total_bits, pad_ones)
        assert len(got) == (total_bits + 7) // 8
    data = bytes(rng.integers(0, 256, total_bits // 8 + 3, dtype=np.uint8))
    for src in (data, np.frombuffer(data, np.uint8)):
        got = port_bitio.bytes_to_words(src)
        assert got.dtype == np.uint32
        assert np.array_equal(got, tpu_bitio.bytes_to_words(src))


@pytest.mark.parametrize("total_bits", [0, 1, 7, 8, 31, 32, 33, 1000, 32 * 64])
def test_words_to_payload_is_words_to_bytes_in_place(rng, total_bits):
    """words_to_payload gives the reference's words_to_bytes as a view of
    the words it was handed, and refuses words it cannot swap in place."""
    words = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    for pad_ones in (True, False):
        mine = words.copy()
        got = port_bitio.words_to_payload(mine, total_bits, pad_ones)
        assert bytes(got) == tpu_bitio.words_to_bytes(words, total_bits, pad_ones)
        assert len(got) == (total_bits + 7) // 8
        assert np.shares_memory(np.frombuffer(got, np.uint8), mine) or not len(got)
    for bad in (words.astype(np.uint64), words[::2]):
        with pytest.raises(ValueError):
            port_bitio.words_to_payload(bad, total_bits)


@pytest.mark.parametrize("n", [0, 1, 4096, 4097, 1 << 20, (1 << 30) + 3])
@pytest.mark.parametrize("preset", ["DEFAULT", "RATIO", "THROUGHPUT"])
def test_plan_streams_matches_reference(n, preset):
    """Stream size: conf.stream_symbols unless conf.max_streams would be
    exceeded (RATIO at 512 MiB: 192 streams of 2,796,203 symbols)."""
    for max_streams in (None, 3):
        kw = {} if max_streams is None else {"max_streams": max_streams}
        port_conf = dataclasses.replace(getattr(cfg, preset), **kw)
        tpu_conf = dataclasses.replace(getattr(tpu_cfg, preset), **kw)
        assert port_bitio.plan_streams(n, port_conf) == tpu_api._plan_streams(n, tpu_conf)
    assert port_bitio.plan_streams(512 << 20, cfg.RATIO) == 2_796_203


def table_codebook_lengths(name: str) -> np.ndarray:
    """Code lengths of the decode-table cases: the benchmark corpus's (the
    AND of three uniform bytes), depth-26 and depth-32 limited codebooks of
    a geometric law, a one-code codebook (one symbol: an incomplete code)
    and uniform 8-bit codes."""
    if name == "corpus":
        rng = np.random.default_rng(0xE58)
        arr = rng.integers(0, 256, 1 << 20, dtype=np.uint8)
        arr &= rng.integers(0, 256, 1 << 20, dtype=np.uint8)
        arr &= rng.integers(0, 256, 1 << 20, dtype=np.uint8)
        return port_codebook.code_lengths(port_codebook.histogram_bytes(arr), 32)
    if name.startswith("deep"):
        freqs = np.left_shift(1, np.maximum(40 - np.arange(256), 0)).astype(np.int64)
        return port_codebook.code_lengths(freqs, int(name[4:]))
    if name == "one_code":
        return port_codebook.code_lengths(np.eye(256, dtype=np.int64)[9], 32)
    return np.full(256, 8, np.int32)


TABLE_CODEBOOKS = ["corpus", "deep26", "deep32", "one_code", "uniform8"]


@pytest.mark.parametrize("table_bits", [8, 10, 11, 12, 16])
@pytest.mark.parametrize("name", TABLE_CODEBOOKS)
def test_decode_luts_match_reference(name, table_bits):
    """Codebook.decode_luts (the table-driven decode's tables) equals
    glz_tpu's, and decode_lut builds the same table from the tensors the
    decode wrappers take (fc_lj, offsets, symtab, min_len, max_len)."""
    lengths = table_codebook_lengths(name)
    want = tpu_codebook.canonical_codebook(lengths).decode_luts(table_bits)
    cb = port_codebook.codebook_from_lengths(lengths)
    got = cb.decode_luts(table_bits)
    assert {"deep26": 26, "deep32": 32, "one_code": 1, "uniform8": 8}.get(name, cb.max_len) \
        == cb.max_len
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    lut = decode_table.decode_lut(*decode_tables(cb, torch.device("cpu")), cb.min_len,
                                  cb.max_len, table_bits)
    assert np.array_equal(lut.numpy().view(np.uint32), want[0])


@pytest.mark.parametrize("lengths", [[0, 5], [3000, 0, 17], [1, 1 << 22, 1 << 33, 2, 0, 4095]])
def test_crc_matches_reference(rng, lengths):
    """utils/crc (the multi-process stitch's checksum) is a copy: every
    combine and concatenation equals glz_tpu's and zlib's."""
    import zlib

    crcs = [int(c) for c in rng.integers(0, 1 << 32, len(lengths), dtype=np.uint64)]
    assert port_crc.crc32_concat(crcs, lengths) == tpu_crc.crc32_concat(crcs, lengths)
    for a, b, n in zip(crcs, crcs[1:], lengths[1:]):
        assert port_crc.crc32_combine(a, b, n) == tpu_crc.crc32_combine(a, b, n)
    parts = [rng.integers(0, 256, min(n, 5000), dtype=np.uint8).tobytes() for n in lengths]
    assert port_crc.crc32_concat([zlib.crc32(p) for p in parts],
                                 [len(p) for p in parts]) == zlib.crc32(b"".join(parts))
    with pytest.raises(ValueError):
        port_crc.crc32_combine(0, 0, -1)
