"""glz_tpu_torch's bitstream (layout 0) kernel modules against glz_tpu on
the CPU.

The same symbols, codebooks and payloads go through the JAX package (K7,
its Pallas lut256, in interpret mode inside encode.lookup_lj_lens and
encode_block_fast; the XLA pack_lj, encode_block and decode_block; the
host HuffWord decode _decode_tokens_host) and through the port's plain
PyTorch versions, which are what the port's wrappers run for CPU tensors.
All data are integers, so every comparison is exact (tolerance 0).  The
byte stream kernel's own steps have plain versions too: its decode table
and probe are held against the plain decode's canonical scan, and its
subsequence table against the serial walk's code boundaries.

Cases: a text codebook (max_len <= 26, where the TPU path fuses its two
lookups), a codebook with codes of 27-32 bits, a ragged n_valid with
garbage past it, stream sizes that are and are not powers of two, one
stream, one symbol; and for the dual decode odd stream sizes, nonword-first
text, an empty dictionary and a >64K-word vocabulary.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from glz_tpu.core import bitio as tpu_bitio
from glz_tpu.core.codebook import build_codebook as tpu_build_codebook
from glz_tpu.core.codebook import canonical_codebook as tpu_canonical
from glz_tpu.core.host_codec import encode_streams as tpu_encode_streams
from glz_tpu.models import huffword as tpu_hw
from glz_tpu.ops import decode as tpu_decode
from glz_tpu.ops import encode as tpu_encode

import chip_smoke
from test_torch_host import TABLE_CODEBOOKS, table_codebook_lengths
from glz_tpu_torch.core.codebook import build_codebook, codebook_from_lengths, histogram_bytes
from glz_tpu_torch.models import huffword as port_hw
from glz_tpu_torch.models.canonical_byte import decode_tables
from glz_tpu_torch.models.transfer import i32_tensor
from glz_tpu_torch.ops import decode as bd
from glz_tpu_torch.ops import decode_table as dt
from glz_tpu_torch.ops import encode as be
from glz_tpu_torch.utils import tokenizer as tok
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
N = 1 << 18  # symbols of a byte case: a multiple of lut256's 64 KiB tile


def u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit patterns -> u32 numpy."""
    return t.numpy().view(np.uint32)


def byte_case(name: str, realtext: bytes):
    """(symbols u8 [N] with garbage past n_valid, n_valid, codebook)."""
    rng = np.random.default_rng(0xB175)
    if name == "deep32":
        arr, cb = chip_smoke.deep_case(N, limit=32)
        assert cb.max_len == 32 and (cb.lengths[arr] >= 27).sum() > 100
        return arr, N - 4321, cb
    arr = np.frombuffer(realtext, np.uint8)[:N].copy()
    n_valid = N - 12345
    cb = build_codebook(histogram_bytes(arr[:n_valid]), 32)
    arr[n_valid:] = rng.integers(0, 256, N - n_valid, dtype=np.uint8)
    assert cb.max_len <= 26
    return arr, n_valid, cb


def tables(cb):
    return (i32_tensor(cb.left_justified_codes(), CPU),
            i32_tensor(cb.lengths.astype(np.uint32), CPU))


@pytest.mark.parametrize("name", ["text", "deep32"])
def test_lookup_matches_reference(realtext, name):
    """K7's plain version against encode.lookup_lj_lens (lut256 in interpret
    mode: one fused lj|len gather for text, two gathers for deep32)."""
    arr, n_valid, cb = byte_case(name, realtext)
    lj_tbl, len_tbl = tables(cb)
    lj, lens = be.lookup_lj_lens(torch.from_numpy(arr), n_valid, lj_tbl, len_tbl)
    want_lj, want_lens = tpu_encode.lookup_lj_lens(
        jnp.asarray(arr), jnp.int32(n_valid), jnp.asarray(cb.left_justified_codes()),
        jnp.asarray(cb.lengths.astype(np.uint32)), cb.max_len, interpret=True)
    assert np.array_equal(u32(lj), np.asarray(want_lj))
    assert np.array_equal(u32(lens), np.asarray(want_lens))
    assert not lj[n_valid:].any() and not lens[n_valid:].any()


@pytest.mark.parametrize("name,S", [("text", 4096), ("text", 1000), ("deep32", 1 << 16)])
def test_pack_matches_reference(realtext, name, S):
    """pack_codes and its plain version pack_codes_ref (an int64 cumsum and
    the scatter, which CPU tensors run) against the XLA pack_lj and
    encode_block on the same codes; S = 1000 is not a power of two (the TPU
    path takes encode_block, without K7, there)."""
    arr, n_valid, cb = byte_case(name, realtext)
    sym = np.zeros(-(-n_valid // S) * S, np.uint8)
    sym[:n_valid] = arr[:n_valid]
    lj, lens = be.lookup_lj_lens(torch.from_numpy(sym), n_valid, *tables(cb))
    words, total_bits, stream_bits = be.pack_codes(lj, lens, S)
    ref = be.pack_codes_ref(lj, lens, S)
    assert ref[1] == total_bits and torch.equal(ref[0], words) and torch.equal(ref[2], stream_bits)
    for want_words, want_total, want_sb in (
            tpu_encode.pack_lj(jnp.asarray(u32(lj)), jnp.asarray(u32(lens)), S),
            tpu_encode.encode_block(jnp.asarray(sym), jnp.int32(n_valid),
                                    jnp.asarray(cb.codewords, dtype=jnp.uint32),
                                    jnp.asarray(cb.lengths, dtype=jnp.int32), S)):
        assert total_bits == int(want_total)
        assert words.numel() == (total_bits + 31) >> 5
        assert np.array_equal(u32(words), np.asarray(want_words)[: words.numel()])
        assert not np.asarray(want_words)[words.numel():].any()
        assert np.array_equal(stream_bits.numpy(), np.asarray(want_sb).astype(np.int64))


@pytest.mark.parametrize("name,S,phase", [("text", 4096, 0), ("text", 1000, 13),
                                          ("deep32", 1 << 16, 31), ("deep32", 4096, 77)])
def test_pack_kernels_plain_versions(realtext, name, S, phase):
    """The pack's two kernels' plain versions (pack_scan_ref: the tile bit
    sums; pack_tiles_ref: the words and each stream's first bit), which
    chip_smoke.py holds the kernels against, against the function's plain
    version pack_codes_ref from bit `phase` (the bits before it 0), on codes
    of up to 32 bits padded with zero-length codes past n_valid."""
    arr, n_valid, cb = byte_case(name, realtext)
    sym = np.zeros(-(-n_valid // S) * S + 3 * S, np.uint8)  # whole tiles of zero codes
    sym[:n_valid] = arr[:n_valid]
    lj, lens = be.lookup_lj_lens(torch.from_numpy(sym), n_valid, *tables(cb))
    tile_bits = be.pack_scan(lens)
    want = np.add.reduceat(u32(lens).astype(np.int64), np.arange(0, lens.numel(), be.PACK_TILE))
    assert np.array_equal(tile_bits.numpy(), want) and not tile_bits[-1]
    words, total, sb = be.pack_codes_ref(lj, lens, S, phase)
    tile_end = torch.cumsum(tile_bits, 0)
    got_words, starts = be.pack_tiles(lj, lens, tile_end, phase & 31, S, words.numel())
    assert torch.equal(got_words, words)
    assert torch.equal(torch.diff(starts), sb) and int(starts[-1]) == total
    assert torch.equal(starts[:-1], torch.cumsum(sb, 0) - sb)
    assert not sb[-3:].any()
    assert phase & 31 == 0 or u32(words)[0] >> (32 - (phase & 31)) == 0


@pytest.mark.parametrize("name,split", [("text", 0.37), ("deep32", 0.61)])
def test_pack_from_a_bit_offset(realtext, name, split):
    """Two dispatches packed one after the other, the second from the
    first's last bit (not a word boundary), their shared word ORed: the
    words of the JAX package's host encoder for the whole input, from
    codes of up to 32 bits; from pack_codes and from the card's step
    (pack_scan, the cumsum of its tile sums, pack_tiles) run on the two
    kernels' plain versions."""
    arr, n_valid, cb = byte_case(name, realtext)
    arr, S = arr[:n_valid], 1 << 12
    want, want_total, want_sb = tpu_encode_streams(arr, tpu_canonical(cb.lengths), S)
    cut = int(n_valid * split) // S * S
    for pack in (be.pack_codes, pack_by_tiles):
        words, at, sbits = [], 0, []
        for chunk in (arr[:cut], arr[cut:]):
            sym = np.zeros(-(-chunk.size // S) * S, np.uint8)
            sym[: chunk.size] = chunk
            lj, lens = be.lookup_lj_lens(torch.from_numpy(sym), chunk.size, *tables(cb))
            w, total, sb = pack(lj, lens, S, at)
            w = u32(w).copy()
            if at & 31:
                w[0] |= words[-1][-1]
                words[-1] = words[-1][:-1]
            words.append(w)
            sbits.append(sb.numpy())
            at += total
        assert at % 32 and at == want_total
        assert np.array_equal(np.concatenate(words), want)
        assert np.array_equal(np.concatenate(sbits), want_sb.astype(np.int64))


def pack_by_tiles(lj, lens, S, bit_offset):
    """pack_codes' step on the card, on the CPU: the two kernels' wrappers,
    which run their plain versions for CPU tensors."""
    tile_end = torch.cumsum(be.pack_scan(lens), 0)
    total, phase = int(tile_end[-1]), bit_offset & 31
    words, starts = be.pack_tiles(lj, lens, tile_end, phase, S, (phase + total + 31) >> 5)
    return words, total, torch.diff(starts)


def test_pack_ref_drops_words_past_the_end():
    """A code's parts at or past n_words are dropped by the plain pack's
    scatter, as the XLA scatter's mode='drop' does; zero codes write
    nothing."""
    lj = torch.tensor([-(1 << 31), 0x7FFFFFFF, 0, -(1 << 31)], dtype=torch.int32)
    offsets = torch.tensor([0, 33, 40, 95], dtype=torch.int64)
    words = u32(be.pack_lj_ref(lj, offsets, 3))
    assert list(words) == [0x80000000, 0x3FFFFFFF, 0x80000001]


def test_encode_block_fast_matches_reference(realtext):
    """One byte dispatch: K7 then the pack, against encode_block_fast."""
    arr, n_valid, cb = byte_case("deep32", realtext)
    S = 1 << 14
    got = be.encode_block_fast(torch.from_numpy(arr), n_valid, *tables(cb), S)
    want = tpu_encode.encode_block_fast(
        jnp.asarray(arr), jnp.int32(n_valid), jnp.asarray(cb.left_justified_codes()),
        jnp.asarray(cb.lengths.astype(np.uint32)), S, interpret=True, max_len=cb.max_len)
    assert got[1] == int(want[1])
    assert np.array_equal(u32(got[0]), np.asarray(want[0])[: got[0].numel()])
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]).astype(np.int64))


def _decode_both(words: np.ndarray, sbits: np.ndarray, n: int, S: int, cb):
    """The port's plain stream decode and the XLA decode_block (with
    assemble) of one payload."""
    starts = (np.cumsum(sbits) - sbits).astype(np.int64)
    got = bd.decode_streams(i32_tensor(words, CPU), torch.from_numpy(starts), n, S,
                            *decode_tables(cb, CPU), cb.min_len, cb.max_len).numpy()
    lut, fc_lj, sp, syms = tpu_canonical(cb.lengths).decode_luts(16)
    out = tpu_decode.decode_block(
        jnp.asarray(words), jnp.asarray(starts.astype(np.uint32)),
        jnp.asarray(lut, dtype=jnp.uint32), jnp.asarray(fc_lj, dtype=jnp.uint32),
        jnp.asarray(sp, dtype=jnp.uint32), jnp.asarray(syms, dtype=jnp.uint32), S, 16)
    want = np.asarray(tpu_decode.assemble(out, n)).astype(np.uint8)
    return got, want


@pytest.mark.parametrize("name,S", [("text", 4096), ("text", 1000), ("deep32", 1 << 15),
                                    ("deep32", N)])
def test_decode_matches_reference(realtext, name, S):
    """The plain stream decode against decode_block and the input, on the
    host encoder's payload (byte-aligned, ones-padded); deep32 takes the
    escape path of decode_block (codes longer than its 16-bit table) and
    length-32 codes; S = N is one stream."""
    arr, n_valid, cb = byte_case(name, realtext)
    arr = arr[:n_valid]
    words, total_bits, sbits = tpu_encode_streams(arr, tpu_canonical(cb.lengths), S)
    words = tpu_bitio.bytes_to_words(tpu_bitio.words_to_bytes(words, total_bits))
    got, want = _decode_both(words, sbits.astype(np.int64), n_valid, S, cb)
    assert np.array_equal(got, want)
    assert np.array_equal(got, arr)


def test_decode_word_aligned_dispatches(realtext):
    """The device container's stream table: each dispatch word-aligned by
    inflating its last stream's recorded bits; the pads are never read."""
    arr, n_valid, cb = byte_case("text", realtext)
    arr, S = arr[:n_valid], 4096
    dispatch = 16 * S
    words, sbits = [], []
    for lo in range(0, n_valid, dispatch):
        chunk = arr[lo : lo + dispatch]
        n = -(-chunk.size // S) * S
        sym = torch.from_numpy(np.concatenate([chunk, np.zeros(n - chunk.size, np.uint8)]))
        w, total, sb = be.encode_block_fast(sym, chunk.size, *tables(cb), S)
        sb = sb.numpy()
        sb[-1] += 32 * w.numel() - total
        words.append(u32(w))
        sbits.append(sb)
    got, want = _decode_both(np.concatenate(words), np.concatenate(sbits), n_valid, S, cb)
    assert np.array_equal(got, want) and np.array_equal(got, arr)


def test_decode_one_symbol():
    cb = build_codebook(histogram_bytes(np.frombuffer(b"ab", np.uint8)), 32)
    words, total, sbits = tpu_encode_streams(np.frombuffer(b"b", np.uint8),
                                             tpu_canonical(cb.lengths), 1 << 18)
    got, want = _decode_both(words, sbits.astype(np.int64), 1, 1 << 18, cb)
    assert bytes(got) == bytes(want) == b"b"


def test_decode_rejects_corrupt_tables(realtext):
    arr, n_valid, cb = byte_case("text", realtext)
    tbl = decode_tables(cb, CPU)
    words = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="stream table too short"):
        bd.decode_streams(words, torch.zeros(2, dtype=torch.int64), 100, 40, *tbl,
                          cb.min_len, cb.max_len)
    with pytest.raises(ValueError, match="negative stream start"):
        bd.decode_streams(words, torch.tensor([0, -5]), 80, 40, *tbl, cb.min_len, cb.max_len)
    with pytest.raises(ValueError, match="code length range"):
        bd.decode_streams(words, torch.zeros(2, dtype=torch.int64), 80, 40, *tbl, 0, 0)
    # starts past the payload decode from zeros instead of reading out of bounds
    out = bd.decode_streams(words, torch.tensor([0, 1 << 40]), 80, 40, *tbl,
                            cb.min_len, cb.max_len)
    assert out.shape == (80,)


# ---- the dual (HuffWord) stream decode -------------------------------------

def dual_case(name: str, realtext: bytes) -> bytes:
    if name == "nonword_first":
        return b"  ...  " + realtext[:60_000]
    if name == "one_token":
        return b"a"
    if name == "big_vocab":
        return chip_smoke.big_vocab_text(n_repeats=2_000)
    return realtext[:80_000]


@pytest.mark.parametrize("name,stream_tokens", [
    ("text", 1001), ("text", 16384), ("nonword_first", 777), ("one_token", 16384),
    ("big_vocab", 4097)])
def test_decode_dual_matches_host(realtext, name, stream_tokens):
    """The port's HuffWord bitstream encode (K6 twice, the pack) and its
    plain dual decode against the JAX package's host decode of the same
    payload; odd stream sizes start odd streams on the odd codebook."""
    _, _, word_first, wv, nv, ids = tok.build_vocabs(dual_case(name, realtext))
    T = ids.size
    cbs = [build_codebook(v.counts if v.n else np.zeros(1, np.int64), 32) for v in (wv, nv)]
    n_streams = -(-T // stream_tokens)
    payload, sbits = port_hw.encode_bitstream_tokens(
        ids, T, word_first, cbs, wv.n, nv.n, stream_tokens, n_streams, device="cpu")
    # the JAX package's host encode of the same tokens writes the same bits
    tpu_cbs = [tpu_build_codebook(v.counts if v.n else np.zeros(1, np.int64), 32)
               for v in (wv, nv)]
    is_word = (np.arange(T) % 2 == 0) == word_first
    pick = lambda col, k, v: col(tpu_cbs[k])[np.minimum(ids, max(v.n - 1, 0))] if v.n else 0
    codes = np.where(is_word, pick(lambda c: c.codewords, 0, wv),
                     pick(lambda c: c.codewords, 1, nv))
    lens = np.where(is_word, pick(lambda c: c.lengths, 0, wv), pick(lambda c: c.lengths, 1, nv))
    w, total = tpu_bitio.pack_codes_msb(codes, lens)
    assert payload == tpu_bitio.words_to_bytes(w, total)
    assert sbits.sum() == total and sbits.size == n_streams

    # the decoders' codebooks, from the lengths a container stores (none for
    # an empty dictionary); row 0 of the dual tables is the even tokens'
    lengths = [cb.lengths if v.n else np.zeros(0, np.int32) for cb, v in zip(cbs, (wv, nv))]
    cb_w, cb_n = (codebook_from_lengths(l) for l in lengths)
    even, odd = (cb_w, cb_n) if word_first else (cb_n, cb_w)
    fc, offs = port_hw._dual_tables(even, odd, CPU)
    starts = torch.from_numpy(np.cumsum(sbits) - sbits)
    ranks = bd.decode_streams_dual(i32_tensor(tpu_bitio.bytes_to_words(payload), CPU),
                                   starts, T, stream_tokens, fc, offs,
                                   (even.min_len, odd.min_len), (even.max_len, odd.max_len))
    got = port_hw._ranks_to_ids(ranks, even, odd, max(wv.n, nv.n) <= 0xFFFF, T, CPU)
    dicts = [tpu_canonical(l) if l.size else tpu_canonical(np.zeros(1, np.int32))
             for l in lengths]
    want = tpu_hw._decode_tokens_host(tpu_bitio.bytes_to_words(payload), sbits, T,
                                      stream_tokens, dicts if word_first else dicts[::-1])
    assert np.array_equal(got, want)
    assert np.array_equal(got, ids)


# ---- the decode table and the subsequence table (the byte kernel's steps) --

@pytest.mark.parametrize("table_bits", [8, 10, 11, 12])
@pytest.mark.parametrize("name", TABLE_CODEBOOKS)
def test_table_probe_matches_scan(name, table_bits):
    """The kernels' table (table_ref) and probe (decode_one_ref, escapes by
    the scan from the entry's level) against the plain decode's canonical
    scan on every table_bits-bit window: each slot's smallest, largest and
    a random window.  For a complete code the table is decode_luts'
    compacted."""
    cb = codebook_from_lengths(table_codebook_lengths(name))
    fc, offs, symtab = decode_tables(cb, CPU)
    table = dt.table_ref(fc, offs, symtab, cb.min_len, cb.max_len, table_bits)
    if name != "one_code":
        lut = dt.decode_lut(fc, offs, symtab, cb.min_len, cb.max_len, table_bits)
        assert torch.equal(table, dt.compact_lut(lut, table_bits, cb.min_len))
    shift = 32 - table_bits
    slot = torch.arange(1 << table_bits) << shift
    rnd = torch.from_numpy(np.random.default_rng(table_bits).integers(0, 1 << shift, slot.numel()))
    v = torch.cat([slot, slot | ((1 << shift) - 1), slot | rnd])
    ln, sym = dt.decode_one_ref(v, table, fc, offs, symtab, cb.max_len, table_bits)
    # the plain decode's scan, on a payload whose word i is window i
    want_ln, want_rank = bd._position_tables(torch.cat([v, v.new_zeros(2)]), 0, 32 * v.numel(),
                                             fc, offs, cb.min_len, cb.max_len)
    assert torch.equal(ln, want_ln[::32])
    assert torch.equal(sym, (symtab.long() & 0xFFFFFFFF)[want_rank[::32] & 255])
    escapes = int((table < 256).sum())
    assert escapes == 0 if cb.max_len <= table_bits else escapes > 0


def _container(arr: np.ndarray, S: int, cb, dispatch: int | None = None):
    """(words int32, starts int64) of the port's device container of arr:
    one pack, or dispatches of `dispatch` symbols each word-aligned (the
    last stream's recorded bits carry the pad)."""
    words, sbits = [], []
    for lo in range(0, arr.size, dispatch or arr.size):
        chunk = arr[lo : lo + (dispatch or arr.size)]
        sym = np.zeros(-(-chunk.size // S) * S, np.uint8)
        sym[: chunk.size] = chunk
        w, total, sb = be.encode_block_fast(torch.from_numpy(sym), chunk.size, *tables(cb), S)
        sb = sb.numpy()
        sb[-1] += 32 * w.numel() - total
        words.append(w)
        sbits.append(sb)
    sbits = np.concatenate(sbits)
    return torch.cat(words), torch.from_numpy(np.cumsum(sbits) - sbits)


def _check_subsequences(words, starts, n: int, S: int, cb, T: int, rounds=None) -> int:
    """subsequence_table_ref against the serial walk's code boundaries
    (_chains): each synchronised start is the walk's first boundary at or
    past the subsequence's first bit; each exit the first at or past its
    end, and each count the walk's codes between.  With rounds = 0 (step
    1's table) only subsequences whose guess is a boundary are held.
    Returns the rounds taken."""
    tbl = decode_tables(cb, CPU)
    stream, start, exit_, cnt, n_rounds = bd.subsequence_table_ref(
        words, starts, n, S, *tbl, cb.min_len, cb.max_len, T, rounds=rounds)
    B = 32 * words.numel()
    P = torch.cat([u32_t(words), words.new_zeros(2, dtype=torch.int64)])
    L = starts.numel()
    _, walk, _ = bd._chains(P, B, starts.clamp(0, B), torch.arange(L) * S, S + T,
                            [(tbl[0], tbl[1], cb.min_len, cb.max_len)], positions=True)
    per = torch.bincount(stream, minlength=L)
    sub = torch.arange(stream.numel()) - (torch.cumsum(per, 0) - per)[stream]
    nominal = starts[stream] + sub * T
    b = walk[stream]
    j0 = torch.searchsorted(b, nominal[:, None])[:, 0].clamp(max=b.shape[1] - 1)
    # (each stream's last subsequence has no end: its j1 is not held)
    j1 = torch.searchsorted(b, (nominal + T)[:, None])[:, 0].clamp(max=b.shape[1] - 1)
    at_j0 = b.gather(1, j0[:, None])[:, 0]
    bounded = cnt >= 0
    synced = start == at_j0
    if rounds is None:
        assert bool(synced.all())
    held = bounded & synced
    assert bool(held.any())
    assert torch.equal(exit_[held], b.gather(1, j1[:, None])[:, 0][held])
    assert torch.equal(cnt[held], (j1 - j0)[held])
    assert bool((per[: -(-n // S)] >= 1).all())
    return n_rounds


def u32_t(t: torch.Tensor) -> torch.Tensor:
    return t.long() & 0xFFFFFFFF


def test_subsequences_uniform8_never_synchronise():
    """Uniform 8-bit codes: with T = 1001 bits (odd) no guess after a
    stream's first lands on a byte boundary, so each round synchronises one
    more subsequence (8 per stream: 7 rounds); the kernel's T, a multiple
    of 32 from each stream's start, synchronises them at once."""
    arr = np.random.default_rng(8).integers(0, 256, 5000, dtype=np.uint8)
    cb = build_codebook(np.ones(256, np.int64), 32)
    words, starts = _container(arr, 1000, cb)
    assert _check_subsequences(words, starts, arr.size, 1000, cb, 1001) == 7
    assert _check_subsequences(words, starts, arr.size, 1000, cb, bd.SUBSEQ_BITS) == 0


@pytest.mark.parametrize("T", [96, 100, bd.SUBSEQ_BITS])
def test_subsequences_s1000(realtext, T):
    """S = 1000 (not a power of two) on the text codebook, at the kernel's
    T and at short subsequences; step 1's table (rounds = 0) holds wherever
    a guess is a code boundary."""
    arr, n_valid, cb = byte_case("text", realtext)
    arr = arr[:40_000]
    words, starts = _container(arr, 1000, cb)
    assert _check_subsequences(words, starts, arr.size, 1000, cb, T) >= 1
    _check_subsequences(words, starts, arr.size, 1000, cb, T, rounds=0)


def test_subsequences_two_dispatches(realtext):
    """Two word-aligned dispatches: the first dispatch's last stream spans
    its pad, which its last subsequence decodes past."""
    arr, n_valid, cb = byte_case("text", realtext)
    arr, S = arr[: 2 * 4096 - 777], 4096
    words, starts = _container(arr, S, cb, dispatch=S)
    assert starts.numel() == 2 and int(starts[1]) % 32 == 0
    _check_subsequences(words, starts, arr.size, S, cb, 128)
    _check_subsequences(words, starts, arr.size, S, cb, bd.SUBSEQ_BITS)


def test_subsequences_host_encoder(realtext):
    """A container of the JAX package's host encoder (byte-aligned,
    ones-padded payload), with codes of 27-32 bits (escapes)."""
    arr, n_valid, cb = byte_case("deep32", realtext)
    arr, S = arr[:30_000], 4096
    words, total_bits, sbits = tpu_encode_streams(arr, tpu_canonical(cb.lengths), S)
    words = tpu_bitio.bytes_to_words(tpu_bitio.words_to_bytes(words, total_bits))
    sbits = sbits.astype(np.int64)
    starts = torch.from_numpy(np.cumsum(sbits) - sbits)
    _check_subsequences(i32_tensor(words, CPU), starts, arr.size, S, cb, 256)


# ---- the dual kernel's steps: its tables and its subsequence table ----------

def dual_codebook(name: str):
    """A codebook of the dual decode: the HuffWord benchmark's words
    (Zipf(1.1) counts over 20,000 words, codes of 3-21 bits) and
    separators, a 70,000-word vocabulary (ranks above 65,535), codes of
    27-32 bits, one code, and an empty dictionary's (0, 0) codebook."""
    if name == "words":
        return build_codebook(np.maximum(1e7 / np.arange(1, 20001) ** 1.1, 1).astype(np.int64), 32)
    if name == "separators":
        return build_codebook(np.array([3_000_000, 1_000_000, 1_000_000, 1_000_000]), 32)
    if name == "big_vocab":
        return build_codebook(np.random.default_rng(0xB16).integers(1, 40, 70_000), 32)
    if name == "deep32":
        return build_codebook(np.left_shift(1, np.maximum(40 - np.arange(200), 0)), 32)
    if name == "one_code":
        return codebook_from_lengths(np.array([1], np.int32))
    return codebook_from_lengths(np.zeros(0, np.int32))


DUAL_TABLE_BITS = [11, 12, 13, 14]


@pytest.mark.parametrize("table_bits", DUAL_TABLE_BITS)
@pytest.mark.parametrize("name", ["words", "separators", "big_vocab", "deep32", "one_code",
                                  "empty"])
def test_dual_table_probe_matches_scan(name, table_bits):
    """The dual kernel's table (dual_table_ref, u8 entries: a length or the
    scan's level) and probe (decode_dual_ref, the rank from the window)
    against the plain decode's canonical scan on every slot's smallest,
    largest and a random window, at each swept table size."""
    cb = dual_codebook(name)
    fc, offs = port_hw._dual_tables(cb, cb, CPU)
    fc, offs = fc[0], offs[0]
    table = dt.dual_table_ref(fc, offs, cb.min_len, cb.max_len, table_bits)
    bits = dt.dual_bits(table_bits, cb.max_len)
    assert table.numel() == 1 << bits and int(table.max()) < 256
    shift = 32 - bits
    slot = torch.arange(1 << bits) << shift
    rnd = torch.from_numpy(np.random.default_rng(table_bits).integers(0, 1 << shift, slot.numel()))
    v = torch.cat([slot, slot | ((1 << shift) - 1), slot | rnd])
    ln, rank = dt.decode_dual_ref(v, table, fc, offs, cb.max_len, table_bits)
    want_ln, want_rank = bd._position_tables(torch.cat([v, v.new_zeros(2)]), 0, 32 * v.numel(),
                                             fc, offs, cb.min_len, cb.max_len)
    assert torch.equal(ln, want_ln[::32])
    assert torch.equal(rank, want_rank[::32])
    escapes = int((table < dt.RESOLVED).sum())
    assert escapes == 0 if cb.max_len <= bits else escapes > 0
    if name == "big_vocab":
        assert int(rank.max()) > 0xFFFF
    if name == "empty":
        assert not ln.any()


def _dual_payload(name: str, realtext: bytes, stream_tokens: int):
    """(words, starts, T, fc, offsets, min_lens, max_lens) of the port's
    HuffWord bitstream encode of a dual case; deep32 draws tokens from the
    made-up dictionaries of chip_smoke's deep32 case (word codes of 27-32
    bits)."""
    if name == "deep32":
        ids, word_first, cbs, n_word, n_nonword, _ = chip_smoke.huffword_bitstream_case(
            "hw_deep32_s999")
    else:
        _, _, word_first, wv, nv, ids = tok.build_vocabs(dual_case(name, realtext))
        cbs = [build_codebook(v.counts if v.n else np.zeros(1, np.int64), 32) for v in (wv, nv)]
        n_word, n_nonword = wv.n, nv.n
    T = ids.size
    payload, sbits = port_hw.encode_bitstream_tokens(
        ids, T, word_first, cbs, n_word, n_nonword, stream_tokens, -(-T // stream_tokens),
        device="cpu")
    lengths = [cb.lengths if n else np.zeros(0, np.int32) for cb, n in zip(cbs, (n_word, n_nonword))]
    cb_w, cb_n = (codebook_from_lengths(l) for l in lengths)
    even, odd = (cb_w, cb_n) if word_first else (cb_n, cb_w)
    fc, offs = port_hw._dual_tables(even, odd, CPU)
    words = i32_tensor(tpu_bitio.bytes_to_words(payload), CPU)
    return (words, torch.from_numpy(np.cumsum(sbits) - sbits), T, fc, offs,
            (even.min_len, odd.min_len), (even.max_len, odd.max_len))


@pytest.mark.parametrize("T", [96, 100, bd.DUAL_SUBSEQ_BITS])
@pytest.mark.parametrize("name,stream_tokens", [
    ("text", 1001), ("text", 16384), ("nonword_first", 777), ("one_token", 16384),
    ("big_vocab", 4097), ("deep32", 999)])
def test_subsequences_dual(realtext, name, stream_tokens, T):
    """subsequence_table_dual_ref against the serial walk's code boundaries
    and parities (_chains): each synchronised start state is the walk's
    first boundary at or past the subsequence's first bit, with its token's
    parity; each exit state the first at or past its end, and each count
    the walk's codes between.  Step 1's table (rounds = 0) holds wherever a
    guess is a boundary of the right parity."""
    words, starts, n, fc, offs, min_lens, max_lens = _dual_payload(name, realtext,
                                                                   stream_tokens)
    S = stream_tokens
    B = 32 * words.numel()
    P = torch.cat([u32_t(words), words.new_zeros(2, dtype=torch.int64)])
    L = starts.numel()
    _, walk, cls = bd._chains(P, B, starts.clamp(0, B), torch.arange(L) * S, S + T,
                              [(fc[p], offs[p], min_lens[p], max_lens[p]) for p in (0, 1)],
                              positions=True)
    for rounds in (None, 0):
        stream, start, spar, exit_, epar, cnt, n_rounds = bd.subsequence_table_dual_ref(
            words, starts, n, S, fc, offs, min_lens, max_lens, T, rounds=rounds)
        per = torch.bincount(stream, minlength=L)
        assert bool((per[: -(-n // S)] >= 1).all())
        sub = torch.arange(stream.numel()) - (torch.cumsum(per, 0) - per)[stream]
        nominal = starts[stream] + sub * T
        b, c = walk[stream], cls[stream]
        j0 = torch.searchsorted(b, nominal[:, None])[:, 0].clamp(max=b.shape[1] - 1)
        j1 = torch.searchsorted(b, (nominal + T)[:, None])[:, 0].clamp(max=b.shape[1] - 1)
        synced = (start == b.gather(1, j0[:, None])[:, 0]) & (spar == c.gather(1, j0[:, None])[:, 0])
        if rounds is None:
            assert bool(synced.all())
            if name == "text" and T == 100:
                assert n_rounds >= 1
        held = (cnt >= 0) & synced
        assert torch.equal(exit_[held], b.gather(1, j1[:, None])[:, 0][held])
        assert torch.equal(epar[held], c.gather(1, j1[:, None])[:, 0][held])
        assert torch.equal(cnt[held], (j1 - j0)[held])
        if name != "one_token":
            assert bool(held.any())
