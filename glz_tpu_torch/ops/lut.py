"""The HuffWord vocabulary gather (K6) and its two callers.

Counterpart of glz_tpu/ops/pallas_lut.py:lut_table together with the index
math of its callers in glz_tpu/models/huffword.py:_device_fns:

  gather_entries: token id -> the fused lj|len entry word of its parity
      dictionary, 0 past the valid token count (the encode's input);
  map_ranks: canonical rank (the dual decode's output) -> token id.

One kernel serves both and every table size: the TPU path's 64K-entry cap
is a VMEM limit, and its jnp.take branch for larger tables computes the
same function (an index clipped to the table's last entry).

u16 and u32 data travel in int16 and int32 tensors holding the bit
pattern; the plain versions do the arithmetic in int64.
"""

from __future__ import annotations

import torch

from glz_tpu_torch.ops import _kernels
from glz_tpu_torch.ops.lockstep_encode import U32, as_u32, to_i32

_BITS = {torch.int16: 16, torch.int32: 32}


def _unsigned(t: torch.Tensor) -> torch.Tensor:
    """int16/int32 bit pattern -> its unsigned value in int64."""
    return t.long() & ((1 << _BITS[t.dtype]) - 1)


def _narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Unsigned values in int64 -> the low 16 or 32 bits as an int16/int32
    bit pattern."""
    if dtype == torch.int32:
        return to_i32(x & U32)
    x = x & 0xFFFF
    return torch.where(x >= (1 << 15), x - (1 << 16), x).to(torch.int16)


def lut_gather_ref(idx: torch.Tensor, tbl: torch.Tensor, add_even: int,
                   add_odd: int, lo: int, T: int, out_dtype: torch.dtype
                   ) -> torch.Tensor:
    """Plain version of K6:
    out[i] = tbl[min(idx[i] + (i odd ? add_odd : add_even), V-1)] where
    lo + i < T, else 0; narrowed to out_dtype (int16 or int32)."""
    pos = torch.arange(idx.numel(), device=idx.device)
    x = _unsigned(idx) + torch.where(pos % 2 == 1, add_odd, add_even)
    x = x.clamp(max=tbl.numel() - 1)
    return _narrow(torch.where(lo + pos < T, as_u32(tbl)[x], 0), out_dtype)


def lut_gather(idx: torch.Tensor, tbl: torch.Tensor, add_even: int,
               add_odd: int, lo: int, T: int, out_dtype: torch.dtype
               ) -> torch.Tensor:
    """K6 (replaces glz_tpu/ops/pallas_lut.py:lut_table).  See
    lut_gather_ref for the function; CUDA tensors launch the kernel.

    idx int16 or int32 (u16/u32 values) [n]; tbl int32 (u32 values) [V],
    V >= 1."""
    if idx.dtype not in _BITS or out_dtype not in _BITS:
        raise TypeError(f"idx and output must be int16 or int32, got {idx.dtype} "
                        f"and {out_dtype}")
    _kernels.check(idx, "idx", idx.dtype, (idx.numel(),), idx.device)
    _kernels.check(tbl, "tbl", torch.int32, (tbl.numel(),), idx.device)
    if tbl.numel() == 0:
        raise ValueError("tbl: the table needs at least one entry")
    if min(add_even, add_odd) < 0:
        raise ValueError("the parity offsets must not be negative")
    if _kernels.runs_plain(idx):
        return lut_gather_ref(idx, tbl, add_even, add_odd, lo, T, out_dtype)
    out = torch.empty(idx.numel(), dtype=out_dtype, device=idx.device)
    if idx.numel():
        _kernels.launch("glz_lut_gather", "lut_gather", _kernels.ptr(idx),
                        _BITS[idx.dtype], idx.numel(), _kernels.ptr(tbl), tbl.numel(),
                        int(lo), int(T), int(add_even), int(add_odd), _kernels.ptr(out),
                        _BITS[out_dtype])
    return out


def _entry_offsets(n0: int, even_is_dict0: bool) -> tuple[int, int]:
    """(add_even, add_odd): tokens of the second dictionary index past the
    first dictionary's n0 entries."""
    return (0, n0) if even_is_dict0 else (n0, 0)


def gather_entries_ref(ids: torch.Tensor, tbl: torch.Tensor, lo: int, n0: int,
                       T: int, even_is_dict0: bool) -> torch.Tensor:
    """Plain version of gather_entries."""
    return lut_gather_ref(ids, tbl, *_entry_offsets(n0, even_is_dict0), lo, T,
                          torch.int32)


def gather_entries(ids: torch.Tensor, tbl: torch.Tensor, lo: int, n0: int,
                   T: int, even_is_dict0: bool) -> torch.Tensor:
    """Token ids -> u32 lj|len entry words (int32 bit patterns):
    tbl[min(id + (in_dict0 ? 0 : n0), V-1)], 0 where lo + pos >= T.

    ids: int16/int32 class-local ids (u16 when both dictionaries are below
    64K entries); tbl: the two dictionaries' entry tables concatenated, the
    first one n0 entries long; position pos is in dictionary 0 when its
    parity is even == even_is_dict0.  K6 on CUDA tensors."""
    return lut_gather(ids, tbl, *_entry_offsets(n0, even_is_dict0), lo, T, torch.int32)


def map_ranks_ref(ranks: torch.Tensor, tbl: torch.Tensor, n_even: int,
                  small: bool) -> torch.Tensor:
    """Plain version of map_ranks."""
    return lut_gather_ref(ranks, tbl, 0, n_even, 0, ranks.numel(),
                          torch.int16 if small else torch.int32)


def map_ranks(ranks: torch.Tensor, tbl: torch.Tensor, n_even: int,
              small: bool) -> torch.Tensor:
    """Canonical ranks in file order -> token ids:
    tbl[min(rank + (pos odd ? n_even : 0), V-1)], u16 (int16) when `small`,
    else u32 (int32).

    ranks: int32 (u32 values), the dual decode's output; tbl: the even and
    the odd codebook's bucket-sorted symbol tables concatenated, the even
    one n_even entries long.  K6 on CUDA tensors."""
    return lut_gather(ranks, tbl, 0, n_even, 0, ranks.numel(),
                      torch.int16 if small else torch.int32)
