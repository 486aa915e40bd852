"""Bitstream (layout-0) encode: the byte lookup (K7) and the bit pack.

Counterpart of glz_tpu/ops/encode.py:lookup_lj_lens, pack_lj and
encode_block_fast.  A dispatch of u8 symbols becomes one MSB-first bit
stream in u32 words, its streams stitched by construction:

    lj, lens = lj_tbl[sym], len_tbl[sym]   (0 past n_valid)     K7
    offsets  = exclusive cumsum of lens (int64)                 torch.cumsum
    words    = OR of each code's <= 2 touched words             pack kernel

The cumsum is outside any kernel, as it is XLA code outside any Pallas
kernel in the JAX package.  u32 data (tables, lj, words) travels in int32
tensors holding the bit pattern; the plain versions do u32 bit math in
int64 and mask it to 32 bits, because CPU PyTorch has no u32 arithmetic.
All offsets are 64-bit, so a dispatch may hold any number of bits.

Each kernel has a plain PyTorch version (`*_ref`, CPU or CUDA tensors) and
a wrapper that runs the plain version for CPU tensors and launches the CUDA
kernel (csrc/bitstream.cu) for CUDA tensors.
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

def _check_pack(lj: torch.Tensor, offsets: torch.Tensor, n_words: int) -> None:
    _kernels.check(lj, "lj", torch.int32, (lj.numel(),), lj.device)
    _kernels.check(offsets, "offsets", torch.int64, (lj.numel(),), lj.device)
    if n_words < 0:
        raise ValueError(f"n_words must not be negative, got {n_words}")


def pack_lj_ref(lj: torch.Tensor, offsets: torch.Tensor, n_words: int) -> torch.Tensor:
    """Plain version of the pack: words int32 [n_words] (u32 bit patterns)
    with, for every code i at bit offset o = offsets[i],
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


def pack_lj(lj: torch.Tensor, offsets: torch.Tensor, n_words: int) -> torch.Tensor:
    """The bit pack (replaces the XLA scatter of glz_tpu/ops/encode.py:
    pack_lj).  See pack_lj_ref for the function; CUDA tensors launch the
    kernel.  lj: int32 [n] left-justified codes (0 where there is no
    symbol); offsets: int64 [n] exclusive bit offsets."""
    _check_pack(lj, offsets, n_words)
    if _kernels.runs_plain(lj):
        return pack_lj_ref(lj, offsets, n_words)
    words = torch.zeros(n_words, dtype=torch.int32, device=lj.device)
    if lj.numel() and n_words:
        _kernels.launch("glz_pack_lj", "pack_lj", _kernels.ptr(lj), _kernels.ptr(offsets),
                        lj.numel(), _kernels.ptr(words), n_words)
    return words


# ---- the pack with its offsets, and one byte dispatch ------------------------

def pack_codes(lj: torch.Tensor, lens: torch.Tensor, stream_symbols: int
               ) -> tuple[torch.Tensor, int, torch.Tensor]:
    """Left-justified codes and their lengths (int32, 0 where there is no
    symbol) -> (words int32 [ceil(total/32)], total_bits, stream_bits int64
    [n // stream_symbols]): the int64 exclusive cumsum of the lengths, then
    the pack, as glz_tpu/ops/encode.py:pack_lj computes them (the words past
    the last code's are not returned; they are 0)."""
    n = lens.numel()
    if stream_symbols < 1 or n % stream_symbols:
        raise ValueError(f"pad the symbols to a multiple of stream_symbols "
                         f"({stream_symbols}), got {n}")
    offsets = torch.cumsum(lens, 0, dtype=torch.int64)
    total_bits = int(offsets[-1]) if n else 0
    offsets.sub_(lens)
    stream_bits = lens.view(-1, stream_symbols).sum(dim=1, dtype=torch.int64)
    return pack_lj(lj, offsets, (total_bits + 31) >> 5), total_bits, stream_bits


def encode_block_fast(sym: torch.Tensor, n_valid: int, lj_tbl: torch.Tensor,
                      len_tbl: torch.Tensor, stream_symbols: int
                      ) -> tuple[torch.Tensor, int, torch.Tensor]:
    """One dispatch of the byte bitstream encode: K7, then pack_codes.
    Returns (words, total_bits, stream_bits) as
    glz_tpu/ops/encode.py:encode_block_fast does.  sym: u8, padded with
    anything to a multiple of stream_symbols (positions >= n_valid code
    nothing)."""
    lj, lens = lookup_lj_lens(sym, n_valid, lj_tbl, len_tbl)
    return pack_codes(lj, lens, stream_symbols)
