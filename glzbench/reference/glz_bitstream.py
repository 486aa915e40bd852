"""The plain reference of the bitstream configurations: a reader of .glz
bitstream containers (layout 0) in byte mode, written from the format's
description alone, in plain PyTorch.

It imports nothing of the program and takes nothing the program made but
the container it judges.  `check(blob, data, conf, device)` decodes the
container, compares the result with the input the benchmark made, and
checks the container against the configuration it was written under and
against the input's exact byte counts.  It returns the number of output
bytes that differ from the input (a missing or extra byte counts as one)
and the list of format faults found.

The format (little-endian):
  header (32 B): b"GLZ1", version 1, mode 0 (bytes), flags (low nibble the
    layout, 0; bit 4 a trailing crc32), 0, the byte count n (u64), the
    number of streams (u32), bytes a stream S (u32), the codebook's size
    (u32), 0.
  codebook: u8 max_len, then 128 B of nibbles (byte 2i in the high one)
    when max_len <= 15, else 256 B of code lengths.
  stream table: one u32 a stream, its bits.
  payload: the codes of the input's bytes one after another, each most
    significant bit first, in bytes up to the last code bit; the last
    byte's bits past it are 1s.
  crc32 of the input (u32), when flagged.
S is the configured stream_symbols, unless ceil(n / S) streams would pass
max_streams; then it is ceil(n / max_streams).  Stream k holds bytes
[k*S, (k+1)*S) of the input and begins at the sum of the table's earlier
entries; an empty input has one stream of 0 bits.  A code's length and
byte give its canonical code: first[max] = 0, first[l] = (first[l+1] +
num[l+1]) // 2, and the codes of one length go to their bytes in byte
order, counting up from first[l].  The code is an optimal prefix code of
the input's exact byte counts among those with no code longer than
length_limit bits.

The decode is vectorised over the payload: the length of the code that
begins at every bit position, then the positions of each stream's codes
from its first bit by pointer doubling, all in torch gathers on `device`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

HEADER = "<4sBBBBQIIII"
HEADER_SIZE = struct.calcsize(HEADER)
LAYOUT_BITSTREAM = 0
WIDTH = 32           # no code is longer than a window
U32 = 0xFFFFFFFF
CHUNK = 1 << 24      # bit positions a pass of the length scan


class Faults(list):
    """Format faults, as short strings."""

    def need(self, ok: bool, what: str) -> bool:
        if not ok:
            self.append(what)
        return ok


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Each byte's canonical code (int64; 0 where the length is 0)."""
    lengths = np.asarray(lengths, np.int64)
    top = int(lengths.max(initial=0))
    num = np.bincount(lengths, minlength=top + 2)
    num[0] = 0
    first = np.zeros(top + 2, np.int64)
    for l in range(top - 1, 0, -1):
        first[l] = (first[l + 1] + num[l + 1]) // 2
    order = np.lexsort((np.arange(lengths.size), lengths))
    order = order[lengths[order] > 0]
    ls = lengths[order]
    rank = np.arange(order.size) - np.searchsorted(ls, ls, side="left")
    codes = np.zeros(lengths.size, np.int64)
    codes[order] = first[ls] + rank
    return codes


def least_cost(counts: np.ndarray, limit: int | None) -> int | None:
    """The least sum of count x length over the prefix codes of the bytes
    that occur, with no code longer than `limit` (None: no limit), by
    package-merge; a lone byte takes one bit.  None where no such code
    exists."""
    w = np.sort(np.asarray(counts, np.int64)[np.asarray(counts) > 0])
    m = w.size
    if m <= 1:
        return int(w.sum())
    limit = m - 1 if limit is None else limit
    if (1 << limit) < m:
        return None
    items = w
    for _ in range(limit - 1):
        packages = items[: items.size // 2 * 2].reshape(-1, 2).sum(1)
        items = np.sort(np.concatenate([w, packages]))
    return int(items[: 2 * m - 2].sum())


def code_table(lengths: np.ndarray, faults: Faults, device):
    """(lo, hi, length, byte) int64 tensors of the codes, by lo: the code of
    a byte begins the 32-bit windows in [lo, hi).  None where the lengths
    make no prefix code."""
    present = np.flatnonzero(lengths)
    ls = lengths[present]
    codes = canonical_codes(lengths)[present]
    ok = faults.need(bool((codes < (1 << ls)).all()), "a code longer than its length")
    lo = codes << (WIDTH - ls)
    hi = (codes + 1) << (WIDTH - ls)
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    ok &= faults.need(bool((lo[1:] >= hi[:-1]).all()), "two codes overlap (not a prefix code)")
    if not ok or not present.size:
        return None
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (lo, hi, ls[order], present[order]))


def windows(u: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The 32 payload bits from each bit position `pos` (u: the payload's
    bytes as int64, with 5 zero bytes past its end)."""
    q = pos >> 3
    x = (u[q] << 32) | (u[q + 1] << 24) | (u[q + 2] << 16) | (u[q + 3] << 8) | u[q + 4]
    return (x >> (8 - (pos & 7))) & U32


def lookup(v: torch.Tensor, table) -> tuple[torch.Tensor, torch.Tensor]:
    """(index into the table, whether a code begins the window) of each
    window."""
    lo, hi = table[0], table[1]
    k = torch.searchsorted(lo, v, right=True) - 1
    kc = k.clamp(min=0)
    return kc, (k >= 0) & (v < hi[kc])


def decode(payload: bytes, table, stream_bits: np.ndarray, n: int, S: int, faults: Faults,
           device) -> torch.Tensor:
    """The n bytes (uint8) of the streams, each decoded from its first bit.
    Faults: a code that begins no window or runs past the payload, a stream
    whose codes do not end where the next one begins."""
    T = int(stream_bits.sum())
    u = torch.zeros(len(payload) + 5, dtype=torch.int64, device=device)
    if payload:
        u[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(device)
    # the length of the code at every bit position; T is the end, T + 1 a dead end
    lens = torch.zeros(T + 2, dtype=torch.int64, device=device)
    for a in range(0, T, CHUNK):
        p = torch.arange(a, min(T, a + CHUNK), device=device)
        k, ok = lookup(windows(u, p), table)
        lens[a : a + p.numel()] = torch.where(ok & (p + table[2][k] <= T), table[2][k], 0)
    at = torch.arange(T + 2, device=device)
    jump = torch.where(lens > 0, at + lens, T + 1)
    jump[T] = T
    K = stream_bits.size
    bits = torch.from_numpy(stream_bits.astype(np.int64)).to(device)
    starts = torch.cumsum(bits, 0) - bits
    pos = torch.empty((K, S), dtype=torch.int64, device=device)
    pos[:, 0] = starts.clamp(max=T + 1)
    width = 1
    while width < S:  # jump is next^width here
        take = min(width, S - width)
        pos[:, width : width + take] = jump[pos[:, :take]]
        width += take
        if width < S:
            jump = jump[jump]
    count = (n - torch.arange(K, device=device) * S).clamp(0, S)
    active = torch.arange(S, device=device) < count[:, None]
    at_codes = pos[active]
    stray = int((at_codes >= T).sum())
    faults.need(stray == 0, f"{stray} codes that begin no window or run past the payload")
    last = pos[torch.arange(K, device=device), (count - 1).clamp(min=0)]
    ends = torch.where(count > 0, last + lens[last], starts)
    wrong = int((ends != starts + bits).sum())
    faults.need(wrong == 0, f"{wrong} streams whose codes do not end at the table's bits")
    k, _ = lookup(windows(u, at_codes.clamp(max=max(T - 1, 0))), table)
    return table[3][k].to(torch.uint8)


def check(blob: bytes, data: bytes, conf: dict, device) -> tuple:
    """(wrong bytes, faults) of one container against its input under the
    configuration `conf` (its mode, stream_symbols, max_streams,
    length_limit and checksum)."""
    faults = Faults()
    c = conf["conf"]
    n_in = len(data)
    mv = memoryview(blob)
    if not faults.need(len(mv) >= HEADER_SIZE, "shorter than a header"):
        return n_in, faults
    magic, version, mode, flags, rows, n, K, S, cb_size, reserved = \
        struct.unpack_from(HEADER, mv, 0)
    faults.need(magic == b"GLZ1", "bad magic")
    faults.need(version == 1, f"version {version}")
    faults.need(mode == conf["mode"] == 0, f"mode {mode}, configured {conf['mode']}")
    faults.need(flags & 0x0F == LAYOUT_BITSTREAM, f"layout {flags & 0x0F}, not bitstream")
    faults.need(bool(flags & 0x10) == c["checksum"], "checksum flag")
    faults.need(flags & 0xE0 == 0 and rows == 0 and reserved == 0, "unknown flags or fields")
    faults.need(n == n_in, f"{n} bytes for {n_in}")
    want_S = c["stream_symbols"]
    if -(-n_in // want_S) > c["max_streams"]:
        want_S = -(-n_in // c["max_streams"])
    want_K = max(1, -(-n_in // want_S))
    faults.need(S == want_S, f"{S} bytes a stream, configured {want_S}")
    faults.need(K == want_K, f"{K} streams for {n_in} bytes")
    off = HEADER_SIZE + cb_size
    crc = 4 if flags & 0x10 else 0
    body = len(mv) - off - 4 * K - crc
    faults.need(body >= 0, "truncated before the payload")
    if not faults.need(cb_size in (129, 257), f"byte codebook of {cb_size} B") or faults:
        return n_in, faults
    raw = np.frombuffer(mv, np.uint8, cb_size - 1, HEADER_SIZE + 1)
    lengths = (np.stack([raw >> 4, raw & 15], 1).ravel() if cb_size == 129
               else raw).astype(np.int64)
    faults.need(int(lengths.max()) == mv[HEADER_SIZE], "byte codebook's max_len")
    faults.need((cb_size == 129) == (mv[HEADER_SIZE] <= 15), "codebook form for its max_len")
    limit = c["length_limit"]
    if not faults.need(int(lengths.max()) <= min(limit or WIDTH, WIDTH),
                       f"a code of {int(lengths.max())} bits, limit {limit}"):
        return n_in, faults
    stream_bits = np.frombuffer(mv, "<u4", K, off).astype(np.int64)
    T = int(stream_bits.sum())
    payload = bytes(mv[off + 4 * K : off + 4 * K + body])
    if crc:
        faults.need(struct.unpack_from("<I", mv, len(mv) - 4)[0] == zlib.crc32(data),
                    "crc32 of the input")
    ref = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device) if data \
        else torch.zeros(0, dtype=torch.uint8, device=device)
    counts = torch.bincount(ref.long(), minlength=256).cpu().numpy()
    faults.need(not ((counts > 0) & (lengths == 0)).any(), "a byte of the input has no code")
    best = least_cost(counts, limit)
    cost = int((counts * lengths).sum())
    faults.need(cost == best, f"a code of {cost} bits where the least is {best} "
                "(not optimal for the exact byte counts)")
    if not faults.need(body == -(-T // 8), f"payload of {body} B for {T} bits"):
        return n_in, faults
    if T % 8:
        pad = (1 << (8 - T % 8)) - 1
        faults.need(payload[-1] & pad == pad, "the last byte's pad bits are not 1s")
    if n_in == 0:
        faults.need(T == 0, f"{T} bits for no byte")
        return 0, faults
    table = code_table(lengths, faults, device)
    if table is None:
        return n_in, faults
    out = decode(payload, table, stream_bits, n_in, S, faults, device)
    return int((out != ref).sum()), faults


def check_all(items: list, conf: dict, device) -> list:
    """[(wrong bytes, faults)] of each (container, the input it was made
    from) under the configuration `conf`, one container at a time."""
    return [check(blob, data, conf, device) for blob, data in items]
