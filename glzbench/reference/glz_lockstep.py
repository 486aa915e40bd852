"""The plain reference of the lockstep configurations: a reader of .glz
lockstep containers (layout 2) in byte mode and in HuffWord mode, written
from the format's description alone, in plain PyTorch.

It imports nothing of the program and takes nothing the program made but
the container it judges.  `check(blob, data, conf, device)` decodes the
container and compares the result with the input the benchmark made,
and checks the container against the configuration it was written under.
It returns the number of output bytes that differ from the input (a
missing or extra byte counts as one) and the list of format faults found.

The format (little-endian):
  header (32 B): b"GLZ1", version (1, or 2 when group_rows != 8), mode
    (0 byte, 1 HuffWord), flags (low nibble the layout, 2; bit 4 a
    trailing crc32), group_rows, the symbol count (u64), the number of
    groups (u32), symbols a stream S (u32), the codebook's size (u32), 0.
  codebook: byte mode, u8 max_len then 128 B of nibbles (symbol 2i high)
    when max_len <= 15, else 256 B of lengths.  HuffWord, u8 word_first,
    then the word and the non-word dictionary, each u32 n, n u8 code
    lengths, n u32 token lengths and the token text.
  group table: one u32 a group, its words, rounded up to 128.
  payload: u32 words in the order the decoder takes them.
A code's length and symbol give its canonical code: first[max] = 0,
first[l] = (first[l+1] + num[l+1]) // 2, and the codes of one length go to
its symbols in symbol order, counting up from first[l].
A group is rows x 128 lanes; lane l of group g holds symbols
[(g*G + l)*S, (g*G + l + 1)*S) of the file (tokens, in HuffWord mode,
token i from the word dictionary when (i even) == word_first).  A lane
holding c bits before step t has taken ceil(c / 32) + 1 words of its own
MSB-first bit stream (none when it holds no symbol); at each step the
lanes that need a word take the group's next ones, in lane order.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

HEADER = "<4sBBBBQIIII"
HEADER_SIZE = struct.calcsize(HEADER)
LAYOUT_LOCKSTEP = 2
LANES = 128
MAX_LEN = 26  # the lockstep layout's longest code
U32 = 0xFFFFFFFF


class Faults(list):
    """Format faults, as short strings."""

    def need(self, ok: bool, what: str) -> bool:
        if not ok:
            self.append(what)
        return ok


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Each symbol's canonical code (int64; 0 where the length is 0)."""
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


def decode_table(lengths: np.ndarray, faults: Faults, device) -> tuple:
    """(bits, length table int8, symbol table int32) of a code: entry v of
    the tables is the length and the symbol of the code that the `bits`-bit
    prefix v begins with (length 0 where none does).  Faults: a code longer than
    MAX_LEN, a code past its length's range, two codes that overlap."""
    lengths = np.asarray(lengths, np.int64)
    present = np.flatnonzero(lengths)
    bits = int(lengths.max(initial=0))
    if not faults.need(bits <= MAX_LEN, f"a code of {bits} bits (lockstep limit {MAX_LEN})"):
        bits = 0
    if bits == 0:
        return 0, torch.zeros(1, dtype=torch.int8, device=device), \
            torch.zeros(1, dtype=torch.int32, device=device)
    codes = canonical_codes(lengths)[present]
    ls = lengths[present]
    lo = codes << (bits - ls)
    hi = (codes + 1) << (bits - ls)
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    faults.need(bool((codes < (1 << ls)).all()), "a code longer than its length")
    faults.need(bool((lo[1:] >= hi[:-1]).all()), "two codes overlap (not a prefix code)")
    v = torch.arange(1 << bits, device=device)
    lo_t = torch.from_numpy(lo).to(device)
    k = (torch.searchsorted(lo_t, v, right=True) - 1).clamp(min=0)
    hit = (v >= lo_t[0]) & (v < torch.from_numpy(hi).to(device)[k])
    syms = torch.from_numpy(present[order]).to(device)
    lens = torch.from_numpy(ls[order]).to(device)
    return (bits, torch.where(hit, lens[k], 0).to(torch.int8),
            torch.where(hit, syms[k], 0).to(torch.int32))


@dataclasses.dataclass
class Container:
    """One container, parsed: what decoding it needs."""
    n: int                 # symbols (bytes, or HuffWord tokens)
    table: np.ndarray      # words of each group
    words: np.ndarray      # the payload, u32 words as int64
    lengths: list          # code lengths, one array a step parity class
    faults: Faults
    huffword: tuple | None = None  # (word_first, word dictionary, non-word dictionary)


def decode_lockstep(items: list, S: int, rows: int, device) -> list:
    """The symbols (int64, file order) of several lockstep payloads of one
    geometry, decoded together, one step of every lane of every group at a
    time; each container's faults are added to its own list."""
    G = rows * LANES
    P = len(items[0].lengths)
    n_groups = [c.table.size for c in items]
    cid = torch.repeat_interleave(torch.arange(len(items), device=device),
                                  torch.tensor(n_groups, device=device))
    tbl = torch.from_numpy(np.concatenate([c.table for c in items])).to(device)
    start = torch.cumsum(tbl, 0) - tbl
    end = start + tbl
    words = torch.from_numpy(np.concatenate([c.words for c in items])).to(device)
    W = words.numel()
    fetch = torch.cat([words, words.new_zeros(1)])
    local = torch.cat([torch.arange(k, device=device) for k in n_groups])
    first = (local[:, None] * G + torch.arange(G, device=device)) * S
    n = torch.tensor([c.n for c in items], device=device)[cid]
    count = (n[:, None] - first).clamp(0, S)
    # each parity class's codes: all containers' tables end to end
    codes = []
    for p in range(P):
        built = [decode_table(c.lengths[p], c.faults, device) for c in items]
        size = torch.tensor([t[1].numel() for t in built], device=device)
        off = (torch.cumsum(size, 0) - size)[cid][:, None]
        shift = (32 - torch.tensor([t[0] for t in built], device=device))[cid][:, None]
        codes.append((torch.cat([t[1] for t in built]), torch.cat([t[2] for t in built]),
                      off, shift))
    has = (count > 0).long()
    p = torch.zeros_like(count)      # bits taken
    taken = torch.zeros_like(count)  # words taken
    buf = torch.zeros_like(count)    # the last two words taken, as 64 bits
    cursor = start.clone()
    stuck = torch.zeros_like(count, dtype=torch.bool)
    out = torch.zeros((len(cid), G, S), dtype=torch.int64, device=device)
    for t in range(S):
        len_tab, sym_tab, off, shift = codes[t % P]
        want = ((p + 31) >> 5) + has
        need = want - taken  # 0 or 1: no code is longer than a word
        taken = want
        c = torch.cumsum(need, 1)
        w = fetch[(cursor[:, None] + c - need).clamp(max=W)]
        cursor = cursor + c[:, -1]
        buf = torch.where(need > 0, (buf << 32) | w, buf)
        v = (buf >> ((-p) & 31)) & U32  # the 32 bits from bit p of the lane's stream
        e = (v >> shift) + off
        ln, sym = len_tab[e], sym_tab[e]
        active = t < count
        stuck |= active & (ln == 0)
        out[:, :, t] = torch.where(active, sym, 0)
        p += torch.where(active, ln, 0)
    # bits past a lane's last code, in the two words it took last, are 0
    used = p - 32 * (taken - 2)
    tail = (has > 0) & (used < 64) & ((buf << used.clamp(0, 63)) != 0)
    pad = torch.zeros(W + 1, dtype=torch.int64, device=device)
    pad.index_add_(0, cursor.clamp(max=W), torch.ones_like(cursor))
    pad.index_add_(0, end.clamp(max=W), -torch.ones_like(end))
    bad_pad = (torch.cumsum(pad, 0)[:W] > 0) & (words != 0)
    word_cid = torch.repeat_interleave(cid, tbl)
    per = {"windows that begin no code": torch.zeros(len(items), dtype=torch.int64,
                                                     device=device),
           "groups whose word count is not their words rounded up to 128": None,
           "lanes whose trailing bits are not 0": None,
           "padding words that are not 0": None}
    per["windows that begin no code"].index_add_(0, cid, stuck.sum(1))
    rounded = (cursor - start + LANES - 1) // LANES * LANES
    per["groups whose word count is not their words rounded up to 128"] = torch.bincount(
        cid[rounded != tbl], minlength=len(items))
    per["lanes whose trailing bits are not 0"] = torch.zeros_like(
        per["windows that begin no code"]).index_add_(0, cid, tail.sum(1))
    per["padding words that are not 0"] = torch.bincount(word_cid[bad_pad],
                                                         minlength=len(items))
    for what, counts in per.items():
        for c, k in zip(items, counts.tolist()):
            c.faults.need(k == 0, f"{k} {what}")
    flat = out.view(len(cid), -1)
    outs, g = [], 0
    for c, k in zip(items, n_groups):
        outs.append(flat[g : g + k].reshape(-1)[: c.n])
        g += k
    return outs


def _dictionary(mv: memoryview, off: int, faults: Faults):
    """(code lengths, token lengths, token text, next offset) of one
    HuffWord dictionary, or None past the end of the section."""
    if not faults.need(off + 4 <= len(mv), "codebook: truncated dictionary"):
        return None
    (k,) = struct.unpack_from("<I", mv, off)
    off += 4
    if not faults.need(off + 5 * k <= len(mv), "codebook: truncated dictionary"):
        return None
    lengths = np.frombuffer(mv, np.uint8, k, off).astype(np.int64)
    tok = np.frombuffer(mv, "<u4", k, off + k).astype(np.int64)
    off += 5 * k
    size = int(tok.sum())
    if not faults.need(off + size <= len(mv), "codebook: truncated token text"):
        return None
    return lengths, tok, np.frombuffer(mv, np.uint8, size, off), off + size


def _detokenize(ids: torch.Tensor, word_first: bool, dicts, device) -> torch.Tensor:
    """The bytes of a token sequence: token i is a word when (i even) ==
    word_first."""
    (_, wtok, wtext, _), (_, ntok, ntext, _) = dicts
    T = ids.numel()
    pool = torch.from_numpy(np.concatenate([wtext, ntext])).to(device)
    woff = torch.from_numpy(np.cumsum(wtok) - wtok).to(device)
    noff = torch.from_numpy(np.cumsum(ntok) - ntok + wtext.size).to(device)
    wlen, nlen = torch.from_numpy(wtok).to(device), torch.from_numpy(ntok).to(device)
    is_word = (torch.arange(T, device=device) % 2 == 0) == word_first
    wi = ids.clamp(0, max(wlen.numel() - 1, 0))
    ni = ids.clamp(0, max(nlen.numel() - 1, 0))
    zero = torch.zeros_like(ids)
    lens = torch.where(is_word, wlen[wi] if wlen.numel() else zero,
                       nlen[ni] if nlen.numel() else zero)
    starts = torch.where(is_word, woff[wi] if woff.numel() else zero,
                         noff[ni] if noff.numel() else zero)
    src = torch.repeat_interleave(starts - (torch.cumsum(lens, 0) - lens), lens)
    src += torch.arange(src.numel(), device=device)
    return pool[src]


def parse(blob: bytes, size: int, conf: dict) -> Container | None:
    """A container, parsed and checked against the configuration's `conf`
    (its mode, stream_symbols, group_rows and checksum) and the input's
    size; None, with its faults, where it cannot be decoded."""
    faults = Faults()
    mv = memoryview(blob)
    if not faults.need(len(mv) >= HEADER_SIZE, "shorter than a header"):
        return Container(0, None, None, [], faults)
    magic, version, mode, flags, rows, n, n_groups, S, cb_size, _ = \
        struct.unpack_from(HEADER, mv, 0)
    faults.need(magic == b"GLZ1", "bad magic")
    faults.need(version == (1 if rows == 8 else 2), f"version {version} for {rows} rows")
    faults.need(mode == conf["mode"], f"mode {mode}, configured {conf['mode']}")
    faults.need(flags & 0x0F == LAYOUT_LOCKSTEP, f"layout {flags & 0x0F}, not lockstep")
    faults.need(bool(flags & 0x10) == conf["conf"]["checksum"], "checksum flag")
    faults.need(flags & 0xE0 == 0, "unknown flags")
    faults.need(S == conf["conf"]["stream_symbols"],
                f"{S} symbols a stream, configured {conf['conf']['stream_symbols']}")
    faults.need(rows == conf["conf"]["group_rows"],
                f"{rows} group rows, configured {conf['conf']['group_rows']}")
    faults.need(n_groups == -(-n // (rows * LANES * S)) if S and rows else False,
                f"{n_groups} groups for {n} symbols")
    off = HEADER_SIZE + cb_size
    body = len(mv) - off - 4 * n_groups - (4 if flags & 0x10 else 0)
    faults.need(body >= 0, "truncated before the payload")
    if faults:
        return Container(0, None, None, [], faults)
    table = np.frombuffer(mv, "<u4", n_groups, off).astype(np.int64)
    faults.need(body == 4 * int(table.sum()), "payload size is not the group table's")
    words = np.frombuffer(mv, "<u4", body // 4, off + 4 * n_groups).astype(np.int64)
    cb = mv[HEADER_SIZE:off]
    if mode == 0:
        faults.need(n == size, f"{n} symbols for {size} bytes")
        if not faults.need(cb_size in (129, 257), f"byte codebook of {cb_size} B"):
            return Container(0, None, None, [], faults)
        raw = np.frombuffer(cb, np.uint8, offset=1)
        lengths = (np.stack([raw >> 4, raw & 15], 1).ravel() if cb_size == 129
                   else raw).astype(np.int64)
        faults.need(int(lengths.max()) == cb[0], "byte codebook's max_len")
        return Container(n, table, words, [lengths], faults)
    if not faults.need(cb_size >= 1, "empty HuffWord codebook"):
        return Container(0, None, None, [], faults)
    word_first = bool(cb[0])
    first = _dictionary(cb, 1, faults)
    second = first and _dictionary(cb, first[3], faults)
    if not second:
        return Container(0, None, None, [], faults)
    faults.need(second[3] == cb_size, "bytes after the dictionaries")
    even, odd = (first, second) if word_first else (second, first)
    return Container(n, table, words, [even[0], odd[0]], faults, (word_first, first, second))


def check_all(items: list, conf: dict, device) -> list:
    """[(wrong bytes, faults)] of each (container, the input it was made
    from) under the configuration `conf`: the containers are decoded
    together, and each output byte that differs from its input, or is
    missing or extra, is a wrong byte."""
    parsed = [parse(blob, len(data), conf) for blob, data in items]
    ok = [c for c in parsed if c.words is not None and not c.faults]
    outs = dict(zip(map(id, ok), decode_lockstep(ok, conf["conf"]["stream_symbols"],
                                                 conf["conf"]["group_rows"], device)
                    if ok else []))
    result = []
    for c, (_, data) in zip(parsed, items):
        out = outs.get(id(c))
        if out is None:
            result.append((len(data), c.faults))
            continue
        if c.huffword:
            out = _detokenize(out, c.huffword[0], c.huffword[1:], device)
        if out.numel() != len(data):
            result.append((abs(out.numel() - len(data)) + min(out.numel(), len(data)),
                           c.faults))
            continue
        ref = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device) if data \
            else torch.zeros(0, dtype=torch.uint8, device=device)
        result.append((int((out.to(torch.uint8) != ref).sum()), c.faults))
    return result


def check(blob: bytes, data: bytes, conf: dict, device) -> tuple:
    """(wrong bytes, faults) of one container against its input."""
    return check_all([(blob, data)], conf, device)[0]
