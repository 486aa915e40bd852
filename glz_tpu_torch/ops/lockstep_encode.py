"""Lockstep (layout-2) encode: lane totals (K1) and the reverse sweep (K2,
K4).

Counterpart of glz_tpu/ops/pallas_encode.py with exact geometry, in two
forms.  Byte mode: u8 symbols and the 256-entry lj|len table (K1, K2).
HuffWord: one u32 lj|len entry word per token, 0 past the valid token
count (the entry-word lane totals and K4).  Symbols are in file order,
padded to a whole number of groups of G = rows*128 lanes x S symbols; lane
l of group g owns symbols [(g*G + l)*S, (g*G + l + 1)*S).  The step-major
transpose of the TPU path is folded into the kernels' indexing.

u32 data (the fused lj|len table, payload words) travels in int32 tensors
holding the bit pattern.  The plain versions do u32 bit math in int64 and
mask it to 32 bits, because CPU PyTorch has no u32 arithmetic.

Each kernel has a plain PyTorch version of the same function (`*_ref`, CPU
or CUDA tensors) and a wrapper that runs the plain version for CPU tensors
and launches the CUDA kernel for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from glz_tpu_torch.core.lockstep import LANES, LEN_BITS, MAX_FUSED_LEN  # noqa: F401
from glz_tpu_torch.ops import _kernels
from glz_tpu_torch.utils import timer

LEN_MASK = (1 << LEN_BITS) - 1
U32 = 0xFFFFFFFF
# The smallest S the lockstep kernels take (the mesh's dry run uses it;
# containers need S >= 64, as the JAX package's do).
MIN_KERNEL_S = 32


def as_u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its u32 value in int64."""
    return t.long() & U32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> int32 bit pattern."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def group_geometry(sym: torch.Tensor, S: int, rows: int) -> tuple[int, int]:
    """(G, n_groups) of a group-padded flat symbol tensor."""
    G = rows * LANES
    if sym.dim() != 1 or sym.numel() == 0 or sym.numel() % (G * S):
        raise ValueError(f"symbols must be a non-empty flat tensor holding whole "
                         f"groups of {G} x {S}, got shape {tuple(sym.shape)}")
    return G, sym.numel() // (G * S)


def lane_counts(limit, n_groups: int, G: int, S: int,
                device: torch.device) -> torch.Tensor:
    """[n_groups, G] valid symbols per lane: clamp(limit - first, 0, S).
    `limit` is the valid symbol count (a scalar, flat over all groups) or a
    [n_groups] tensor of per-group counts (group-relative)."""
    if isinstance(limit, torch.Tensor):
        first = torch.arange(G, device=device, dtype=torch.int64) * S
        return (limit.long()[:, None] - first[None, :]).clamp(0, S)
    first = torch.arange(n_groups * G, device=device, dtype=torch.int64) * S
    return (int(limit) - first).clamp(0, S).view(n_groups, G)


def _check_symbols(sym: torch.Tensor, dtype: torch.dtype, S: int, rows: int):
    """(G, n_groups) of a kernel's symbol input, after checking it."""
    if sym.dtype != dtype:
        raise TypeError(f"sym: expected {dtype}, got {sym.dtype}")
    if S & (S - 1) or not MIN_KERNEL_S <= S <= 8192:
        raise ValueError(f"S must be a power of two in [{MIN_KERNEL_S}, 8192], got {S}")
    if rows not in (8, 16, 32, 64):
        raise ValueError(f"rows must be 8, 16, 32 or 64, got {rows}")
    G, n_groups = group_geometry(sym, S, rows)
    _kernels.check(sym, "sym", dtype, (n_groups * G * S,), sym.device)
    if sym.is_cuda and sym.data_ptr() % 16:
        raise ValueError("sym: the kernels read it 16 bytes at a time; "
                         "its data must be 16-byte aligned")
    return G, n_groups


def _check_common(sym: torch.Tensor, tbl: torch.Tensor, S: int, rows: int):
    G, n_groups = _check_symbols(sym, torch.uint8, S, rows)
    _kernels.check(tbl, "tbl", torch.int32, (256,), sym.device)
    return G, n_groups


def _check_sweep_inputs(sym: torch.Tensor, ctot: torch.Tensor, gw: torch.Tensor,
                        grow: torch.Tensor, n_groups: int, rows: int,
                        n_words: int) -> None:
    _kernels.check(ctot, "ctot", torch.int32, (n_groups, rows, LANES), sym.device)
    _kernels.check(gw, "gw", torch.int32, (n_groups,), sym.device)
    _kernels.check(grow, "grow", torch.int32, (n_groups,), sym.device)
    lo, hi = torch.stack([gw.min().long(), (grow.long() * LANES + gw.long()).max()]).tolist()
    if lo < 0 or hi > n_words:
        raise ValueError(f"group segments (grow*128 + gw) exceed the {n_words}-word payload")


def _totals_from_lens(lens: torch.Tensor, rows: int):
    """(ctot, gw) from [n_groups, G, S] code lengths (0 where invalid)."""
    n_groups = lens.shape[0]
    ctot = lens.sum(dim=2)
    last = lens[:, :, -1].long()
    words = torch.where(ctot > 0, (ctot - last + 31) // 32 + 1, 0)
    return (ctot.to(torch.int32).view(n_groups, rows, LANES),
            words.sum(dim=1).to(torch.int32))


# ---- K1: per-lane bit totals and per-group word counts ---------------------

def lane_totals_ref(sym: torch.Tensor, tbl: torch.Tensor, n_valid: int,
                    S: int, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1.  Returns (ctot int32 [n_groups, rows, 128],
    gw int32 [n_groups]): ctot = sum of code lengths of the lane's valid
    symbols, gw = sum over lanes of the refill word count
    [ctot > 0] * ((ctot - len_last + 31) // 32 + 1)."""
    G, n_groups = group_geometry(sym, S, rows)
    lens_tbl = (tbl & LEN_MASK).to(torch.int32)
    lens = lens_tbl[sym.view(n_groups, G, S).int()]
    count = lane_counts(n_valid, n_groups, G, S, sym.device)
    valid = torch.arange(S, device=sym.device) < count[..., None]
    return _totals_from_lens(torch.where(valid, lens, 0), rows)


def lane_totals(sym: torch.Tensor, tbl: torch.Tensor, n_valid: int, S: int,
                rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 (replaces glz_tpu/ops/pallas_encode.py:lane_totals).  See
    lane_totals_ref for the function; CUDA tensors launch the kernel."""
    G, n_groups = _check_common(sym, tbl, S, rows)
    if _kernels.runs_plain(sym):
        return lane_totals_ref(sym, tbl, n_valid, S, rows)
    ctot = torch.empty((n_groups, rows, LANES), dtype=torch.int32, device=sym.device)
    gw = torch.zeros(n_groups, dtype=torch.int32, device=sym.device)
    _kernels.launch("glz_lane_totals", "lane_totals", _kernels.ptr(sym),
                    _kernels.ptr(tbl), int(n_valid), n_groups, S, rows,
                    _kernels.ptr(ctot), _kernels.ptr(gw))
    return ctot, gw


# ---- the entry-word form of K1 (HuffWord) ---------------------------------

def lane_totals_entries_ref(ent: torch.Tensor, S: int, rows: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the entry-word lane totals (the totals half of
    glz_tpu/ops/pallas_encode.py:prepare_entry_words).  ent: int32 u32
    lj|len entry words, 0 past the valid token count.  Returns (ctot int32
    [n_groups, rows, 128], gw int32 [n_groups]) as lane_totals_ref does."""
    G, n_groups = group_geometry(ent, S, rows)
    return _totals_from_lens((ent & LEN_MASK).view(n_groups, G, S), rows)


def lane_totals_entries(ent: torch.Tensor, S: int, rows: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Entry-word lane totals (K1's HuffWord form).  See
    lane_totals_entries_ref for the function; CUDA tensors launch the
    kernel."""
    G, n_groups = _check_symbols(ent, torch.int32, S, rows)
    if _kernels.runs_plain(ent):
        return lane_totals_entries_ref(ent, S, rows)
    ctot = torch.empty((n_groups, rows, LANES), dtype=torch.int32, device=ent.device)
    gw = torch.zeros(n_groups, dtype=torch.int32, device=ent.device)
    _kernels.launch("glz_lane_totals_entries", "lane_totals_entries", _kernels.ptr(ent),
                    n_groups, S, rows, _kernels.ptr(ctot), _kernels.ptr(gw))
    return ctot, gw


# ---- K2 / K4: reverse-sweep encode ----------------------------------------

def _sweep_ref(entry_at, n_groups: int, G: int, S: int, ctot: torch.Tensor,
               gw: torch.Tensor, grow: torch.Tensor, n_words: int,
               dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The reverse sweep of K2 and K4; entry_at(t) gives step t's u32 lj|len
    entries, [n_groups, G] int64 (0 where invalid)."""
    cur = ctot.reshape(n_groups, G).long()
    w0 = torch.zeros((n_groups, G), dtype=torch.int64, device=dev)
    w1 = torch.zeros_like(w0)
    gwl = gw.long()
    cursor = gwl.clone()
    base = grow.long() * LANES
    out = torch.zeros(n_words, dtype=torch.int64, device=dev)

    def emit(need: torch.Tensor, word: torch.Tensor) -> None:
        nonlocal cursor
        need_i = need.long()
        rank = torch.cumsum(need_i, dim=1) - need_i
        cursor = cursor - need_i.sum(dim=1)
        pos = cursor.clamp(min=0)[:, None] + rank
        keep = need & (pos < gwl[:, None])
        out[(base[:, None] + pos)[keep]] = word[keep]

    ln = None
    for t in range(S - 1, -1, -1):
        ent = entry_at(t)
        ln = ent & LEN_MASK
        lj = ent & (U32 ^ LEN_MASK)
        cur_prev = cur - ln
        if t != S - 1:
            need = ((cur + 31) >> 5) > ((cur_prev + 31) >> 5)
            d = (32 - (cur & 31)) & 31
            word = torch.where(d > 0,
                               ((w0 << d) & U32) | (w1 >> ((32 - d) & 31)), w0)
            emit(need, word)
        nz = ln > 0
        big = ln >= 32
        lnc = ln & 31
        sl = (32 - ln) & 31
        rs1 = torch.where(big, 0, w1 >> lnc)
        rs0 = torch.where(big, 0, w0 >> lnc)
        w1 = torch.where(nz, ((w0 << sl) & U32) | rs1, w1)
        w0 = torch.where(nz, lj | rs0, w0)
        cur = cur_prev
    # forward step 0: word 0 for every lane with a step-0 symbol
    emit(ln > 0, w0)
    return to_i32(out), cursor.to(torch.int32)


def encode_groups_ref(sym: torch.Tensor, tbl: torch.Tensor, n_valid: int,
                      ctot: torch.Tensor, gw: torch.Tensor, grow: torch.Tensor,
                      S: int, rows: int, n_words: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2.  Returns (payload int32 [n_words], cursor_end
    int32 [n_groups]).

    Group g's consumption-ordered words land at [grow[g]*128, +gw[g]); the
    rest of the payload stays zero.  Per lane, t = S-1 .. 0: emit the word
    forward step t+1 loads (not at t = S-1), then prepend symbol t's code
    into the 64-bit window (w0, w1).  A step's k emitted words fill
    [cursor-k, cursor) in lane order; the cursor starts at gw[g], is
    floored at 0 for addressing, and its unfloored final value is
    cursor_end[g] (0 when gw is exact)."""
    G, n_groups = group_geometry(sym, S, rows)
    ent_tbl = as_u32(tbl)
    s3 = sym.view(n_groups, G, S)
    count = lane_counts(n_valid, n_groups, G, S, sym.device)
    return _sweep_ref(lambda t: torch.where(t < count, ent_tbl[s3[:, :, t].long()], 0),
                      n_groups, G, S, ctot, gw, grow, n_words, sym.device)


def encode_groups(sym: torch.Tensor, tbl: torch.Tensor, n_valid: int,
                  ctot: torch.Tensor, gw: torch.Tensor, grow: torch.Tensor,
                  S: int, rows: int, n_words: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 (replaces glz_tpu/ops/pallas_encode.py:encode_groups, byte-LUT
    mode).  See encode_groups_ref for the function; CUDA tensors launch the
    kernel."""
    G, n_groups = _check_common(sym, tbl, S, rows)
    _check_sweep_inputs(sym, ctot, gw, grow, n_groups, rows, n_words)
    if _kernels.runs_plain(sym):
        return encode_groups_ref(sym, tbl, n_valid, ctot, gw, grow, S, rows, n_words)
    out = torch.zeros(n_words, dtype=torch.int32, device=sym.device)
    cursor_end = torch.empty(n_groups, dtype=torch.int32, device=sym.device)
    _kernels.launch("glz_encode_groups", "encode_groups", _kernels.ptr(sym),
                    _kernels.ptr(tbl), int(n_valid), _kernels.ptr(ctot),
                    _kernels.ptr(gw), _kernels.ptr(grow), n_groups, S, rows,
                    _kernels.ptr(out), _kernels.ptr(cursor_end))
    return out, cursor_end


def encode_entries_ref(ent: torch.Tensor, ctot: torch.Tensor, gw: torch.Tensor,
                       grow: torch.Tensor, S: int, rows: int, n_words: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: encode_groups_ref's sweep on u32 lj|len entry
    words (int32 bit patterns, 0 past the valid token count)."""
    G, n_groups = group_geometry(ent, S, rows)
    e3 = as_u32(ent).view(n_groups, G, S)
    return _sweep_ref(lambda t: e3[:, :, t], n_groups, G, S, ctot, gw, grow,
                      n_words, ent.device)


def encode_entries(ent: torch.Tensor, ctot: torch.Tensor, gw: torch.Tensor,
                   grow: torch.Tensor, S: int, rows: int, n_words: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 (replaces glz_tpu/ops/pallas_encode.py:encode_groups, u32-entry
    mode).  See encode_entries_ref for the function; CUDA tensors launch
    the kernel."""
    G, n_groups = _check_symbols(ent, torch.int32, S, rows)
    _check_sweep_inputs(ent, ctot, gw, grow, n_groups, rows, n_words)
    if _kernels.runs_plain(ent):
        return encode_entries_ref(ent, ctot, gw, grow, S, rows, n_words)
    out = torch.zeros(n_words, dtype=torch.int32, device=ent.device)
    cursor_end = torch.empty(n_groups, dtype=torch.int32, device=ent.device)
    _kernels.launch("glz_encode_entries", "encode_entries", _kernels.ptr(ent),
                    _kernels.ptr(ctot), _kernels.ptr(gw), _kernels.ptr(grow),
                    n_groups, S, rows, _kernels.ptr(out), _kernels.ptr(cursor_end))
    return out, cursor_end


def group_layout(gw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact geometry from the real word counts: (padded counts, start rows).
    Each group's segment starts 128-word aligned; its padded count is what
    the container's group table stores."""
    gw = np.asarray(gw, dtype=np.int64)
    padded = -(-gw // LANES) * LANES
    grow = (np.cumsum(padded) - padded) // LANES
    return padded, grow


def encode_payload_from_symbols(sym: torch.Tensor, n_valid: int,
                                tbl: torch.Tensor, S: int, rows: int
                                ) -> tuple[torch.Tensor, np.ndarray]:
    """Full lockstep encode of group-padded u8 symbols: K1, exact geometry on
    the host, then K2.  Returns (payload int32 tensor, padded group word
    counts np.int64).  tbl[b] = lj[b] | len[b] (max_len <= 26)."""
    ctot, gw = lane_totals(sym, tbl, n_valid, S, rows)
    return _exact_sweep(lambda grow, n_words: encode_groups(
        sym, tbl, n_valid, ctot, gw, grow, S, rows, n_words), gw)


def encode_payload_from_entries(ent: torch.Tensor, S: int, rows: int
                                ) -> tuple[torch.Tensor, np.ndarray]:
    """Full lockstep encode of group-padded u32 lj|len entry words (the
    HuffWord token path; int32 bit patterns, 0 past the valid token count):
    the entry-word lane totals, exact geometry on the host, then K4.
    Returns (payload int32 tensor, padded group word counts np.int64)."""
    ctot, gw = lane_totals_entries(ent, S, rows)
    return _exact_sweep(lambda grow, n_words: encode_entries(
        ent, ctot, gw, grow, S, rows, n_words), gw)


def _exact_sweep(sweep, gw: torch.Tensor) -> tuple[torch.Tensor, np.ndarray]:
    """Exact geometry from the real word counts (one small D2H, the wait for
    the lane totals: span `sync.layout`), then sweep(grow, n_words); raises
    unless every group's cursor ends at 0 (a wait for the sweep:
    `sync.cursor`)."""
    with timer.span("sync.layout"):
        padded, grow = group_layout(gw.cpu().numpy())
    grow_t = torch.from_numpy(grow.astype(np.int32)).to(gw.device)
    payload, cursor_end = sweep(grow_t, int(padded.sum()))
    with timer.span("sync.cursor"):
        bad = torch.nonzero(cursor_end).flatten()
    if bad.numel():
        g = int(bad[0])
        raise RuntimeError(f"lockstep encode: group {g} cursor ended at "
                           f"{int(cursor_end[g])}, not 0 (word count mismatch)")
    return payload, padded
