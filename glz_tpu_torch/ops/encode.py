"""Bitstream (layout-0) encode: the byte lookup (K7) and the bit pack.

Counterpart of glz_tpu/ops/encode.py:lookup_lj_lens, pack_lj and
encode_block_fast.  A dispatch of u8 symbols becomes one MSB-first bit
stream in u32 words, its streams stitched by construction:

    lj, lens = lj_tbl[sym], len_tbl[sym]   (0 past n_valid)     K7
    offsets  = exclusive cumsum of lens          pack_scan + torch.cumsum
    words    = the codes laid end to end at their offsets       pack_tiles

The pack may start at any bit of a payload (bit_offset), so dispatches of
one stream follow each other without a pad.  u32 data (tables, lj, words)
travels in int32 tensors holding the bit pattern; the plain versions do
u32 bit math in int64 and mask it to 32 bits, because CPU PyTorch has no
u32 arithmetic.  All offsets are 64-bit, so a dispatch may hold any number
of bits.

Each kernel has a plain PyTorch version (`*_ref`, CPU or CUDA tensors) and
a wrapper that runs the plain version for CPU tensors and launches the CUDA
kernels (csrc/bitstream.cu) for CUDA tensors.
"""

from __future__ import annotations

import torch

from glz_tpu_torch.ops import _kernels
from glz_tpu_torch.ops.lockstep_encode import U32, as_u32, to_i32


def _check_lookup(sym: torch.Tensor, lj_tbl: torch.Tensor, len_tbl: torch.Tensor) -> None:
    _kernels.check(sym, "sym", torch.uint8, (sym.numel(),), sym.device)
    _kernels.check(lj_tbl, "lj_tbl", torch.int32, (256,), sym.device)
    _kernels.check(len_tbl, "len_tbl", torch.int32, (256,), sym.device)


# ---- K7: the 256-entry byte lookup ------------------------------------------

def lookup_lj_lens_ref(sym: torch.Tensor, n_valid: int, lj_tbl: torch.Tensor,
                       len_tbl: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7: (lj_tbl[sym], len_tbl[sym]) as int32 (u32 bit
    patterns), both 0 at positions >= n_valid."""
    valid = torch.arange(sym.numel(), device=sym.device) < n_valid
    idx = sym.long()
    lj = torch.where(valid, as_u32(lj_tbl)[idx], 0)
    lens = torch.where(valid, as_u32(len_tbl)[idx], 0)
    return to_i32(lj), to_i32(lens)


def lookup_lj_lens(sym: torch.Tensor, n_valid: int, lj_tbl: torch.Tensor,
                   len_tbl: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 (replaces glz_tpu/ops/pallas_lut.py:lut256 as
    glz_tpu/ops/encode.py:lookup_lj_lens calls it).  See lookup_lj_lens_ref
    for the function; CUDA tensors launch the kernel.

    sym: u8 [n], any n; lj_tbl[b] = codeword[b] << (32 - length[b]) and
    len_tbl[b] = length[b], int32 [256].  The TPU's split into one fused
    lj|len gather (max_len <= 26) or two gathers has no counterpart: both
    tables sit in shared memory and one launch writes both outputs."""
    _check_lookup(sym, lj_tbl, len_tbl)
    if _kernels.runs_plain(sym):
        return lookup_lj_lens_ref(sym, n_valid, lj_tbl, len_tbl)
    if sym.data_ptr() % 4:
        raise ValueError("sym: the kernel reads it 4 bytes at a time; its data "
                         "must be 4-byte aligned")
    n = sym.numel()
    lj = torch.empty(n, dtype=torch.int32, device=sym.device)
    lens = torch.empty(n, dtype=torch.int32, device=sym.device)
    if n:
        _kernels.launch("glz_lookup_lj_lens", "lookup_lj_lens", _kernels.ptr(sym), n,
                        max(0, min(int(n_valid), n)), _kernels.ptr(lj_tbl),
                        _kernels.ptr(len_tbl), _kernels.ptr(lj), _kernels.ptr(lens))
    return lj, lens


# ---- the bit pack ------------------------------------------------------------

# Codes per block of the pack kernels: 256 threads of 16 codes each.
PACK_TILE = 4096


def _check_pack(lj: torch.Tensor, lens: torch.Tensor, stream_symbols: int,
                bit_offset: int) -> int:
    """n, after checking the pack's inputs."""
    n = lens.numel()
    _kernels.check(lens, "lens", torch.int32, (n,), lens.device)
    _kernels.check(lj, "lj", torch.int32, (n,), lens.device)
    if stream_symbols < 1 or n % stream_symbols:
        raise ValueError(f"pad the symbols to a multiple of stream_symbols "
                         f"({stream_symbols}), got {n}")
    if bit_offset < 0:
        raise ValueError(f"bit_offset must not be negative, got {bit_offset}")
    return n


def pack_lj_ref(lj: torch.Tensor, offsets: torch.Tensor, n_words: int) -> torch.Tensor:
    """The scatter of the plain pack: words int32 [n_words] (u32 bit
    patterns) with, for every code i at bit offset o = offsets[i],
        words[o >> 5]     |= lj[i] >> (o & 31)
        words[o >> 5 + 1] |= lj[i] << (32 - (o & 31))   (only when o & 31 > 0)
    and parts that land at or past n_words dropped.  Codes hold no bits past
    their length and their offsets do not overlap, so the ORs touch disjoint
    bits and are computed as a sum."""
    c = as_u32(lj)
    phase = offsets & 31
    w = offsets >> 5
    lo = c >> phase
    hi = torch.where(phase > 0, (c << ((32 - phase) & 31)) & U32, 0)
    words = torch.zeros(n_words, dtype=torch.int64, device=lj.device)
    for idx, val in ((w, lo), (w + 1, hi)):
        keep = (val != 0) & (idx < n_words)
        words.index_add_(0, idx[keep], val[keep])
    return to_i32(words)


def pack_codes_ref(lj: torch.Tensor, lens: torch.Tensor, stream_symbols: int,
                   bit_offset: int = 0) -> tuple[torch.Tensor, int, torch.Tensor]:
    """Plain version of the pack: the int64 exclusive cumsum of the lengths,
    shifted by bit_offset & 31, then the scatter (pack_lj_ref).  See
    pack_codes for the function."""
    n = _check_pack(lj, lens, stream_symbols, bit_offset)
    ends = torch.cumsum(lens, 0, dtype=torch.int64)
    total_bits = int(ends[-1]) if n else 0
    phase = bit_offset & 31
    words = pack_lj_ref(lj, ends - lens + phase, (phase + total_bits + 31) >> 5)
    stream_bits = lens.view(-1, stream_symbols).sum(dim=1, dtype=torch.int64)
    return words, total_bits, stream_bits


def pack_scan_ref(lens: torch.Tensor) -> torch.Tensor:
    """Plain version of pack_scan: int64 [ceil(n / PACK_TILE)], the bits of
    each tile of PACK_TILE codes (the last tile ragged)."""
    n = lens.numel()
    padded = torch.zeros(-(-n // PACK_TILE) * PACK_TILE, dtype=torch.int64, device=lens.device)
    padded[:n] = lens
    return padded.view(-1, PACK_TILE).sum(dim=1)


def pack_scan(lens: torch.Tensor) -> torch.Tensor:
    """The pack's first kernel (the tile sums of glz_tpu/ops/encode.py:
    pack_lj's cumsum).  See pack_scan_ref; CUDA tensors launch the kernel.
    lens: int32 [n], n >= 1."""
    n = lens.numel()
    _kernels.check(lens, "lens", torch.int32, (n,), lens.device)
    if n == 0:
        raise ValueError("no codes to scan")
    if _kernels.runs_plain(lens):
        return pack_scan_ref(lens)
    if lens.data_ptr() % 16:  # the kernel reads 16 bytes at a time
        lens = lens.clone()
    tile_bits = torch.empty(-(-n // PACK_TILE), dtype=torch.int64, device=lens.device)
    _kernels.launch("glz_pack_scan", "pack_scan", _kernels.ptr(lens), n,
                    _kernels.ptr(tile_bits))
    return tile_bits


def pack_tiles_ref(lj: torch.Tensor, lens: torch.Tensor, tile_end: torch.Tensor, phase: int,
                   stream_symbols: int, n_words: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of pack_tiles: (words int32 [n_words], starts int64
    [n // stream_symbols + 1]).  The codes are laid end to end from bit
    `phase` of words[0]; starts holds each stream's first bit (from the
    first code's, without `phase`) and then the total.  tile_end (the
    inclusive cumsum of pack_scan's tile bits) only places the kernel's
    tiles: the function does not depend on it."""
    ends = torch.cumsum(lens, 0, dtype=torch.int64)
    offsets = ends - lens
    words = pack_lj_ref(lj, offsets + phase, n_words)
    return words, torch.cat([offsets[::stream_symbols], ends[-1:]])


def pack_tiles(lj: torch.Tensor, lens: torch.Tensor, tile_end: torch.Tensor, phase: int,
               stream_symbols: int, n_words: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The pack's second kernel (the scatter of glz_tpu/ops/encode.py:
    pack_lj, with each stream's first bit).  See pack_tiles_ref; CUDA
    tensors launch the kernel, which also needs tile_end."""
    n = _check_pack(lj, lens, stream_symbols, phase)
    _kernels.check(tile_end, "tile_end", torch.int64, (-(-n // PACK_TILE),), lens.device)
    if n == 0 or not 0 <= phase < 32 or n_words < (phase + 31) >> 5:
        raise ValueError(f"bad pack geometry: {n} codes, phase {phase}, {n_words} words")
    if _kernels.runs_plain(lens):
        return pack_tiles_ref(lj, lens, tile_end, phase, stream_symbols, n_words)
    lj, lens = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (lj, lens))
    words = torch.zeros(n_words, dtype=torch.int32, device=lens.device)
    starts = torch.empty(n // stream_symbols + 1, dtype=torch.int64, device=lens.device)
    _kernels.launch("glz_pack_tiles", "pack_tiles", _kernels.ptr(lj), _kernels.ptr(lens), n,
                    _kernels.ptr(tile_end), phase, stream_symbols, _kernels.ptr(words),
                    n_words, _kernels.ptr(starts))
    return words, starts


def pack_codes(lj: torch.Tensor, lens: torch.Tensor, stream_symbols: int,
               bit_offset: int = 0) -> tuple[torch.Tensor, int, torch.Tensor]:
    """The bit pack (replaces glz_tpu/ops/encode.py:pack_lj, an XLA cumsum
    and scatter): left-justified codes and their lengths (int32, 0 where
    there is no symbol; n a multiple of stream_symbols) -> (words,
    total_bits, stream_bits int64 [n // stream_symbols]).

    The codes are laid end to end from bit `bit_offset` of a payload, and
    `words` int32 [((bit_offset & 31) + total_bits + 31) >> 5] are that
    payload's words from the one holding bit `bit_offset` (the bits before
    it 0, the words past the last code's not returned: they are 0).  With
    bit_offset 0 this is glz_tpu's pack_lj; pack_codes_ref is its plain
    version, which CPU tensors run.  On the card the step is the tile sums
    (pack_scan), a torch.cumsum over the n/4096 of them, the total on the
    host (it sizes the words), and the pack (pack_tiles)."""
    n = _check_pack(lj, lens, stream_symbols, bit_offset)
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=lens.device), 0,
                torch.zeros(0, dtype=torch.int64, device=lens.device))
    if _kernels.runs_plain(lens):
        return pack_codes_ref(lj, lens, stream_symbols, bit_offset)
    tile_end = torch.cumsum(pack_scan(lens), 0)
    total_bits = int(tile_end[-1])
    phase = bit_offset & 31
    words, starts = pack_tiles(lj, lens, tile_end, phase, stream_symbols,
                               (phase + total_bits + 31) >> 5)
    return words, total_bits, torch.diff(starts)


# ---- one byte dispatch --------------------------------------------------------

def encode_block_fast(sym: torch.Tensor, n_valid: int, lj_tbl: torch.Tensor,
                      len_tbl: torch.Tensor, stream_symbols: int, bit_offset: int = 0
                      ) -> tuple[torch.Tensor, int, torch.Tensor]:
    """One dispatch of the byte bitstream encode: K7, then pack_codes from
    bit `bit_offset`.  With bit_offset 0 it returns (words, total_bits,
    stream_bits) as glz_tpu/ops/encode.py:encode_block_fast does.  sym: u8,
    padded with anything to a multiple of stream_symbols (positions >=
    n_valid code nothing)."""
    lj, lens = lookup_lj_lens(sym, n_valid, lj_tbl, len_tbl)
    return pack_codes(lj, lens, stream_symbols, bit_offset)
