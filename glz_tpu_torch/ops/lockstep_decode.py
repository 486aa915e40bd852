"""Lockstep (layout-2) decode: one codebook (K3, byte mode) and two
alternating codebooks (K5, HuffWord).

Counterpart of glz_tpu/ops/pallas_decode.py:decode_groups and
decode_groups_dual.  The kernels write their output in file order (lane l
of group g at [(g*G + l)*S, ...)), so the TPU path's packed step-major
outputs and their unpack steps (unpack_symbols, unpack_ranks,
unpack_ranks_packed) have no counterpart here.
"""

from __future__ import annotations

import torch

from glz_tpu_torch.core.lockstep import LANES
from glz_tpu_torch.ops import _kernels
from glz_tpu_torch.ops.lockstep_encode import U32, as_u32, lane_counts, to_i32

CODE_TABLE = 34  # fc_lj / offsets entries (MAX_CODE_LEN + 2)
# K3's decode table indexes the window's first TABLE_BITS bits (chosen among
# 10, 11 and 12 by chip_smoke.py's sweep, PERF.md)
TABLE_BITS = 11
# K5's word table indexes the window's first DUAL_TABLE_BITS bits (the
# separators' table has as many bits as their longest code; PERF.md)
DUAL_TABLE_BITS = 12


def _decode_ref(payload: torch.Tensor, group_starts: torch.Tensor,
                group_counts: torch.Tensor, codebooks, S: int, rows: int,
                emit) -> None:
    """The lockstep decode of K3 and K5.  codebooks: one (fc_lj, offsets,
    min_len, max_len) per step parity class, step t using codebooks[t %
    len(codebooks)].  Calls emit(t, rank, active) per step with the
    [n_groups, G] canonical ranks (int64, unmasked) and the active mask.

    Per step, refilling lanes take payload[start + base + exclusive rank]
    (0 past the payload's end) into a (phase 0) or b; the window is
    v = (a << phase) | (b >> (32 - phase)); the code length is
    min_len + sum_l [v < fc_lj[l]] with the offset selected by the same
    scan; the rank is (v >> (32 - len)) + off."""
    dev = payload.device
    G = rows * LANES
    n_groups = group_starts.numel()
    n_words = payload.numel()
    # one zero word past the end: loads beyond the payload read 0
    P = torch.cat([as_u32(payload), payload.new_zeros(1, dtype=torch.int64)])
    tables = [(as_u32(fc).tolist(), as_u32(off).tolist(), lo, hi)
              for fc, off, lo, hi in codebooks]
    count = lane_counts(group_counts, n_groups, G, S, dev)
    shape = (n_groups, G)
    a = torch.zeros(shape, dtype=torch.int64, device=dev)
    b = torch.zeros_like(a)
    phase = torch.zeros_like(a)
    qm = torch.full(shape, 31, dtype=torch.int64, device=dev)
    need = count > 0
    base = group_starts.long().clone()
    for t in range(S):
        fc, off_tbl, min_len, max_len = tables[t % len(tables)]
        # ---- refill: needing lanes take sequential words (lane order)
        need_i = need.long()
        idx = base[:, None] + torch.cumsum(need_i, dim=1) - need_i
        base = base + need_i.sum(dim=1)
        w = P[idx.clamp(max=n_words)]
        to_a = phase == 0
        a = torch.where(need & to_a, w, a)
        b = torch.where(need & ~to_a, w, b)
        # ---- window
        v = torch.where(phase > 0,
                        ((a << phase) & U32) | (b >> ((32 - phase) & 31)), a)
        # ---- length scan + offset select
        ln = torch.full(shape, min_len, dtype=torch.int64, device=dev)
        off = torch.full(shape, off_tbl[min_len], dtype=torch.int64, device=dev)
        for l in range(min_len, max_len):
            cond = v < fc[l]
            ln = ln + cond.long()
            off = torch.where(cond, off_tbl[l + 1], off)
        active = t < count
        ln = torch.where(active, ln, 0)
        emit(t, ((v >> ((32 - ln) & 31)) + off) & U32, active)
        # ---- advance
        crossed = (phase + ln) >= 32
        need = (qm + ln) >= 32
        qm = (qm + ln) & 31
        a = torch.where(crossed, b, a)
        phase = (phase + ln) & 31


def _check_decode(payload, group_starts, group_counts, S: int, rows: int,
                  any_even_s: bool = False) -> int:
    """n_groups, after checking the inputs both decode kernels share (S a
    power of two in [64, 8192], or with any_even_s any even S there)."""
    if (S % 2 if any_even_s else S & (S - 1)) or not 64 <= S <= 8192:
        raise ValueError(f"S must be {'even' if any_even_s else 'a power of two'} "
                         f"in [64, 8192], got {S}")
    if rows not in (8, 16, 32, 64):
        raise ValueError(f"rows must be 8, 16, 32 or 64, got {rows}")
    dev = payload.device
    n_groups = group_starts.numel()
    if n_groups == 0:
        raise ValueError("no groups to decode")
    _kernels.check(payload, "payload", torch.int32, (payload.numel(),), dev)
    _kernels.check(group_starts, "group_starts", torch.int64, (n_groups,), dev)
    _kernels.check(group_counts, "group_counts", torch.int32, (n_groups,), dev)
    return n_groups


# ---- K3: byte mode ---------------------------------------------------------

def decode_groups_ref(payload: torch.Tensor, group_starts: torch.Tensor,
                      group_counts: torch.Tensor, fc_lj: torch.Tensor,
                      offsets: torch.Tensor, symtab: torch.Tensor, S: int,
                      min_len: int, max_len: int, rows: int) -> torch.Tensor:
    """Plain version of K3.  Returns u8 [n_groups*G*S] in file order, 0 past
    each lane's symbol count: sym = symtab[rank & 255] (see _decode_ref)."""
    G = rows * LANES
    sym_tbl = as_u32(symtab)
    out = torch.zeros((group_starts.numel(), G, S), dtype=torch.uint8,
                      device=payload.device)

    def emit(t, rank, active):
        out[:, :, t] = torch.where(active, sym_tbl[rank & 255], 0).to(torch.uint8)

    _decode_ref(payload, group_starts, group_counts,
                [(fc_lj, offsets, min_len, max_len)], S, rows, emit)
    return out.view(-1)


def decode_groups(payload: torch.Tensor, group_starts: torch.Tensor,
                  group_counts: torch.Tensor, fc_lj: torch.Tensor,
                  offsets: torch.Tensor, symtab: torch.Tensor, S: int,
                  min_len: int, max_len: int, rows: int) -> torch.Tensor:
    """K3 (replaces glz_tpu/ops/pallas_decode.py:decode_groups).  See
    decode_groups_ref for the function; CUDA tensors launch the kernel.

    payload int32 [W] (u32 words); group_starts int64 [n_groups] absolute
    segment starts in words; group_counts int32 [n_groups] symbols per
    group; fc_lj/offsets int32 [34]; symtab int32 [256]."""
    if not 1 <= min_len <= max_len <= 32:
        raise ValueError(f"bad code length range [{min_len}, {max_len}]")
    dev = payload.device
    n_groups = _check_decode(payload, group_starts, group_counts, S, rows)
    _kernels.check(fc_lj, "fc_lj", torch.int32, (CODE_TABLE,), dev)
    _kernels.check(offsets, "offsets", torch.int32, (CODE_TABLE,), dev)
    _kernels.check(symtab, "symtab", torch.int32, (256,), dev)
    if _kernels.runs_plain(payload):
        return decode_groups_ref(payload, group_starts, group_counts, fc_lj,
                                 offsets, symtab, S, min_len, max_len, rows)
    G = rows * LANES
    out = torch.empty(n_groups * G * S, dtype=torch.uint8, device=dev)
    if payload.data_ptr() % 16:  # the kernel copies 16-byte pieces
        payload = payload.clone()
    _kernels.launch("glz_decode_groups", "decode_groups", _kernels.ptr(payload),
                    payload.numel(), _kernels.ptr(group_starts),
                    _kernels.ptr(group_counts), TABLE_BITS, _kernels.ptr(fc_lj),
                    _kernels.ptr(offsets), _kernels.ptr(symtab),
                    min_len, max_len, n_groups, S, rows, _kernels.ptr(out))
    return out


# ---- K5: HuffWord, two codebooks alternating by token parity --------------

def decode_groups_dual_ref(payload: torch.Tensor, group_starts: torch.Tensor,
                           group_counts: torch.Tensor, fc_lj: torch.Tensor,
                           offsets: torch.Tensor, S: int, min_lens, max_lens,
                           rows: int) -> torch.Tensor:
    """Plain version of K5.  fc_lj, offsets: int32 [2, 34], row 0 the even
    tokens' codebook (step t uses row t & 1; S is even and lane starts are
    multiples of S, so step parity is token parity).  Returns the canonical
    ranks, int32 (u32 bit patterns) [n_groups*G*S] in file order, 0 for
    inactive tokens (see _decode_ref)."""
    G = rows * LANES
    out = torch.zeros((group_starts.numel(), G, S), dtype=torch.int64,
                      device=payload.device)

    def emit(t, rank, active):
        out[:, :, t] = torch.where(active, rank, 0)

    _decode_ref(payload, group_starts, group_counts,
                [(fc_lj[p], offsets[p], min_lens[p], max_lens[p]) for p in (0, 1)],
                S, rows, emit)
    return to_i32(out.view(-1))


def decode_groups_dual(payload: torch.Tensor, group_starts: torch.Tensor,
                       group_counts: torch.Tensor, fc_lj: torch.Tensor,
                       offsets: torch.Tensor, S: int, min_lens, max_lens,
                       rows: int) -> torch.Tensor:
    """K5 (replaces glz_tpu/ops/pallas_decode.py:decode_groups_dual).  See
    decode_groups_dual_ref for the function; CUDA tensors launch the kernel.

    S: even, in [64, 8192].  min_lens, max_lens: (even, odd) code length
    ranges, each [0, 0] for an empty dictionary or within [1, 32]."""
    for lo, hi in zip(min_lens, max_lens):
        if not ((lo, hi) == (0, 0) or 1 <= lo <= hi <= 32):
            raise ValueError(f"bad code length range [{lo}, {hi}]")
    dev = payload.device
    n_groups = _check_decode(payload, group_starts, group_counts, S, rows, any_even_s=True)
    _kernels.check(fc_lj, "fc_lj", torch.int32, (2, CODE_TABLE), dev)
    _kernels.check(offsets, "offsets", torch.int32, (2, CODE_TABLE), dev)
    if _kernels.runs_plain(payload):
        return decode_groups_dual_ref(payload, group_starts, group_counts, fc_lj,
                                      offsets, S, min_lens, max_lens, rows)
    out = torch.empty(n_groups * rows * LANES * S, dtype=torch.int32, device=dev)
    if payload.data_ptr() % 16:  # the kernel copies 16-byte pieces
        payload = payload.clone()
    _kernels.launch("glz_decode_dual", "decode_dual", _kernels.ptr(payload),
                    payload.numel(), _kernels.ptr(group_starts),
                    _kernels.ptr(group_counts), DUAL_TABLE_BITS, _kernels.ptr(fc_lj),
                    _kernels.ptr(offsets), min_lens[0], max_lens[0], min_lens[1],
                    max_lens[1], n_groups, S, rows, _kernels.ptr(out))
    return out
