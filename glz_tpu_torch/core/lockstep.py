"""Lockstep multi-stream payload schedule ("layout 2").

A group of rows x 128 streams is decoded in lockstep, one symbol per stream
per step.  The payload is written in *decoder consumption order*: the
encoder simulates the decoder's word-refill schedule (fully determined by
the per-symbol code lengths) and places each 32-bit word of each lane's
stream where the decoder will ask for it, so decode-side payload access is
one sequential cursor per group.

Schedule (per lane; c(t) = inclusive cumsum of code lengths, c(-1) = 0):

    words_needed_after_step_t = floor((c(t-1) + 31) / 32) + 1   [t >= 1]
    mask[t]  = words_needed(t) - words_needed(t-1)  in {0, 1}
    mask[0]  = 1 if the lane has any symbols else 0

Loaded word j is bits [32j, 32j+32) of the lane's own MSB-first bit stream
(zero-padded).  Within a group, words are ordered step-major, then by lane
id (row*128 + column) within a step.
"""

from __future__ import annotations

import warnings

import numpy as np

from glz_tpu_torch import config as cfg

ROWS = 8      # default group rows; containers record their own (byte 7)
LANES = 128   # streams per group row
GROUP_ROWS = (8, 16, 32, 64)  # the group widths both packages decode
LEN_BITS = 6  # the encode kernels' entry word is lj | len, the length in LEN_BITS bits,
MAX_FUSED_LEN = 32 - LEN_BITS  # so a lockstep code is at most 26 bits long

# stream_symbols values of the byte-oriented presets: for huffword they mean
# "no token-count preference was expressed", not an explicit request.
_BYTE_PRESET_S = {cfg.DEFAULT.stream_symbols, cfg.THROUGHPUT.stream_symbols,
                  cfg.RATIO.stream_symbols}
_HUFFWORD_DEFAULT_S = 512


def _is_stream_symbols(S: int) -> bool:
    """A lockstep stream's symbol count: a power of two in [64, 8192]."""
    return S & (S - 1) == 0 and 64 <= S <= 8192


def stream_symbols(conf: cfg.GlzConfig) -> int:
    """conf.stream_symbols for the byte lockstep layout, after checking it."""
    S = conf.stream_symbols
    if not _is_stream_symbols(S):
        raise ValueError(
            f"lockstep layout needs stream_symbols a power of two in "
            f"[64, 8192], got {S}; use cfg.THROUGHPUT or set it explicitly")
    return S


def group_rows(conf: cfg.GlzConfig) -> int:
    """conf.group_rows, after checking that it is a supported group width."""
    rows = conf.group_rows
    if rows not in GROUP_ROWS:
        raise ValueError(f"group_rows must be 8, 16, 32 or 64, got {rows}")
    return rows


def fused_length_limit(conf: cfg.GlzConfig) -> int:
    """The code-length cap of a lockstep encode: conf.length_limit (none:
    MAX_FUSED_LEN), at most MAX_FUSED_LEN, so the fused entry word applies."""
    return min(conf.length_limit or MAX_FUSED_LEN, MAX_FUSED_LEN)


def group_streams(f) -> int:
    """Streams a group (rows x 128) of lockstep container f, after checking
    its stream_symbols and that its group table covers its symbols."""
    S = f.stream_symbols
    if not _is_stream_symbols(S):
        raise ValueError(f"corrupt .glz container: lockstep stream_symbols {S}")
    G = f.group_rows * LANES
    if f.n_streams * G * S < f.n_symbols:
        raise ValueError("corrupt .glz container: group table too short")
    return G


def huffword_rows_cap(S: int, pack2: bool) -> int:
    """The container's group_rows bound for the dual decode.  It comes from
    the JAX package's TPU kernel (its u32 rank output block, (S//2 with
    pack2 else S) * rows * 512 B, must stay <= 4 MiB), and it decides the
    container's group_rows, so both packages apply it."""
    return max(8, ((1 << 14) if pack2 else (1 << 13)) // S)


def capped_rows(rows: int, S: int, pack2: bool) -> int:
    """Apply huffword_rows_cap, with a warning when it lowers the request
    (attributed to the caller's caller)."""
    cap = huffword_rows_cap(S, pack2)
    if rows > cap:
        warnings.warn(
            f"huffword lockstep group_rows={rows} exceeds the dual kernel's "
            f"VMEM budget at stream_symbols={S} "
            f"({'pack2' if pack2 else 'u32-rank'} path); using group_rows="
            f"{cap} — lower stream_symbols to use wider groups",
            stacklevel=3)
        rows = cap
    return rows


def huffword_stream_tokens(conf: cfg.GlzConfig) -> int:
    """Tokens per HuffWord lockstep stream, a power of two in [64, 1024].

    An explicitly configured stream_symbols outside that range raises;
    the byte presets' defaults carry no huffword intent and select 512."""
    S = conf.stream_symbols
    if S & (S - 1) == 0 and 64 <= S <= 1024:
        return S
    if S in _BYTE_PRESET_S:
        return _HUFFWORD_DEFAULT_S
    raise ValueError(
        f"huffword device layout needs stream_symbols a power of two in "
        f"[64, 1024], got {S}")


def refill_masks(lens_mat: np.ndarray) -> np.ndarray:
    """mask[l, t] = 1 iff lane l loads a word at step t (schedule above)."""
    c = np.cumsum(lens_mat, axis=1)
    words_after = (np.concatenate([np.zeros((c.shape[0], 1), np.int64), c[:, :-1]], axis=1) + 31) // 32 + 1
    prev = np.concatenate([np.zeros((c.shape[0], 1), np.int64), words_after[:, :-1]], axis=1)
    mask = (words_after - prev).astype(np.int64)
    mask[:, 0] = (lens_mat[:, 0] > 0).astype(np.int64)
    return mask
