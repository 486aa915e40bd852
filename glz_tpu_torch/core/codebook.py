"""Canonical Huffman codebook construction (host numpy).

The container stores only the 256 code lengths; everything else is derived
from them deterministically, so two codecs that compute the same lengths
write the same bytes.  Lengths come from Moffat–Katajainen on sorted
frequencies, with a package-merge length limiter, then the canonical code
assignment:

    first_code[max_len] = 0
    first_code[l]       = (first_code[l+1] + num[l+1]) / 2
    codeword[sym]       = next_code[len(sym)]++   in symbol order
    symbol[start_pos[len]++] = sym                # bucket sort by length

i.e. deeper codes are numerically smaller and codes are MSB-first.  Ties
are broken by symbol index, so construction is deterministic.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_CODE_LEN = 32


NATIVE_HISTOGRAM_BYTES = 1 << 20  # inputs this large count with the host library


def histogram_bytes(data: np.ndarray | bytes) -> np.ndarray:
    """256-bin byte histogram: the host library's threaded count from 1 MiB
    up, np.bincount below (where it is as fast)."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    if arr.size >= NATIVE_HISTOGRAM_BYTES:
        from glz_tpu_torch.utils import native
        return native.histogram(arr)
    return np.bincount(arr, minlength=256).astype(np.int64)


SAMPLE_BLOCK = 4096


def sampled_histogram(arr: np.ndarray, budget_bytes: int | None) -> np.ndarray:
    """Histogram estimate from evenly spaced 4 KiB blocks, scaled to the
    full size and smoothed so every byte value keeps a code.

    Any histogram yields a valid code, so round trips stay exact; budget
    None or >= n means an exact scan."""
    n = arr.size
    if budget_bytes is None or n <= budget_bytes:
        return histogram_bytes(arr)
    nb = n // SAMPLE_BLOCK
    take = max(1, budget_bytes // SAMPLE_BLOCK)
    stride = max(1, nb // take)
    sample = np.ascontiguousarray(
        arr[: nb * SAMPLE_BLOCK].reshape(nb, SAMPLE_BLOCK)[::stride]).reshape(-1)
    freqs = histogram_bytes(sample)
    scale = max(1, n // sample.size)
    # +1 smoothing: a symbol missing from the sample but present in the
    # file must still get a code (it lands at the deepest length)
    return np.maximum(freqs * scale, 1)


def minimum_redundancy_lengths(freqs: np.ndarray) -> np.ndarray:
    """Optimal (unbounded) Huffman code lengths via Moffat–Katajainen.

    In-place over frequencies sorted ascending; O(n) after the sort.  Zero
    frequencies get length 0 (absent symbol).  Ties are broken by symbol
    index so results are deterministic.
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    n_sym = freqs.shape[0]
    present = np.flatnonzero(freqs > 0)
    n = present.size
    lengths = np.zeros(n_sym, dtype=np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[present[0]] = 1
        return lengths

    order = present[np.argsort(freqs[present], kind="stable")]
    a = freqs[order].astype(np.int64).tolist()

    # Phase 1: tree building; a[i] becomes parent index for internal nodes.
    a[0] += a[1]
    root = 0
    leaf = 2
    for nxt in range(1, n - 1):
        if leaf >= n or a[root] < a[leaf]:
            a[nxt] = a[root]
            a[root] = nxt
            root += 1
        else:
            a[nxt] = a[leaf]
            leaf += 1
        if leaf >= n or (root < nxt and a[root] < a[leaf]):
            a[nxt] += a[root]
            a[root] = nxt
            root += 1
        else:
            a[nxt] += a[leaf]
            leaf += 1

    # Phase 2: internal node depths.
    a[n - 2] = 0
    for nxt in range(n - 3, -1, -1):
        a[nxt] = a[a[nxt]] + 1

    # Phase 3: leaf depths from internal depths.
    avail = 1
    used = 0
    depth = 0
    root = n - 2
    nxt = n - 1
    while avail > 0:
        while root >= 0 and a[root] == depth:
            used += 1
            root -= 1
        while avail > used:
            a[nxt] = depth
            nxt -= 1
            avail -= 1
        avail = 2 * used
        depth += 1
        used = 0

    # a[0..n-1] holds depths for the sorted symbols (ascending freq ->
    # non-increasing depth).
    lengths[order] = np.asarray(a, dtype=np.int32)
    return lengths


def package_merge_lengths(freqs: np.ndarray, limit: int) -> np.ndarray:
    """Length-limited code lengths via boundary package-merge, O(n * limit).

    Runs level by level, remembering for each level the packages as
    (weight, leaf_idx|-1, childA, childB) in one pool, and walks the DAG
    of the first 2n-2 packages of the final level to count, per symbol, how
    many selected packages contain it: that count is its code length."""
    freqs = np.asarray(freqs, dtype=np.int64)
    n_sym = freqs.shape[0]
    present = np.flatnonzero(freqs > 0)
    n = present.size
    lengths = np.zeros(n_sym, dtype=np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[present[0]] = 1
        return lengths
    if n > (1 << limit):
        raise ValueError(f"cannot code {n} symbols with length limit {limit}")

    order = present[np.argsort(freqs[present], kind="stable")]
    w = freqs[order].astype(np.float64)

    pool: list[tuple[float, int, int, int]] = []  # (weight, leaf_idx|-1, childA, childB)

    def leaf_pkg(i: int) -> int:
        pool.append((float(w[i]), i, -1, -1))
        return len(pool) - 1

    prev_level: list[int] = []
    for _level in range(limit):
        merged: list[int] = []
        # packages from prev level, paired
        pairs = [(prev_level[2 * i], prev_level[2 * i + 1]) for i in range(len(prev_level) // 2)]
        pi = 0
        li = 0
        while li < n or pi < len(pairs):
            take_pair = False
            if pi < len(pairs):
                pw = pool[pairs[pi][0]][0] + pool[pairs[pi][1]][0]
                if li >= n or pw < w[li]:
                    take_pair = True
            if take_pair:
                a_, b_ = pairs[pi]
                pool.append((pool[a_][0] + pool[b_][0], -1, a_, b_))
                merged.append(len(pool) - 1)
                pi += 1
            else:
                merged.append(leaf_pkg(li))
                li += 1
        prev_level = merged

    # Select the first 2n-2 packages of the final level; count leaf coverage.
    counts = np.zeros(n, dtype=np.int32)
    stack = list(prev_level[: 2 * n - 2])
    while stack:
        idx = stack.pop()
        wt, leaf, a_, b_ = pool[idx]
        if leaf >= 0:
            counts[leaf] += 1
        else:
            stack.append(a_)
            stack.append(b_)
    lengths[order] = counts
    return lengths


def package_merge_lengths_fast(freqs: np.ndarray, limit: int) -> np.ndarray:
    """Vectorized boundary package-merge (large alphabets).  Uses the
    prefix property of boundary PM: the selected items of each level form a
    prefix, so per-symbol lengths are sum_k [position_of_leaf_in_level_k <
    selected_k], all computable with sorts/searchsorted."""
    freqs = np.asarray(freqs, dtype=np.int64)
    n_sym = freqs.shape[0]
    present = np.flatnonzero(freqs > 0)
    n = present.size
    lengths = np.zeros(n_sym, dtype=np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[present[0]] = 1
        return lengths
    if n > (1 << limit):
        raise ValueError(f"cannot code {n} symbols with length limit {limit}")

    order = present[np.argsort(freqs[present], kind="stable")]
    leaf_w = freqs[order].astype(np.float64)

    # build levels top-down: level L = leaves; level k-1 = merge(leaves,
    # pairs(level k)); record leaf positions per level
    leafpos_levels = []
    merged_w = leaf_w.copy()
    leafpos_levels.append(np.arange(n, dtype=np.int64))
    for _ in range(limit - 1):
        m = merged_w.shape[0]
        pair_w = merged_w[: m - (m % 2)].reshape(-1, 2).sum(axis=1)
        # leaf precedes equal-weight packages
        leafpos = np.arange(n) + np.searchsorted(pair_w, leaf_w, side="left")
        merged_w = np.sort(np.concatenate([leaf_w, pair_w]), kind="stable")
        leafpos_levels.append(leafpos)
    # leafpos_levels[k] corresponds to level (limit - k); level 1 is last.

    counts = np.zeros(n, dtype=np.int32)
    sel = 2 * n - 2
    for k in range(limit - 1, -1, -1):
        leafpos = leafpos_levels[k]
        n_leaves_sel = int(np.searchsorted(leafpos, sel, side="left"))
        counts[:n_leaves_sel] += 1
        n_packages = sel - n_leaves_sel
        sel = 2 * n_packages
        if sel == 0:
            break
    lengths[order] = counts
    return lengths


def code_lengths(freqs: np.ndarray, limit: int | None = MAX_CODE_LEN) -> np.ndarray:
    """Huffman code lengths, limited to `limit` if necessary."""
    lengths = minimum_redundancy_lengths(freqs)
    if limit is not None and lengths.max(initial=0) > limit:
        n = int((np.asarray(freqs) > 0).sum())
        pm = package_merge_lengths_fast if n > 2048 else package_merge_lengths
        lengths = pm(freqs, limit)
    return lengths


@dataclasses.dataclass
class Codebook:
    """Canonical codebook.

    lengths[sym]   : code length, 0 = absent
    codewords[sym] : right-justified code value
    first_code[l]  : numerically smallest code of length l (sentinel for
                     l < min_len so decode comparisons fail)
    start_pos[l]   : index into `symbols` of the first symbol of length l
    symbols        : symbol indices bucket-sorted by (length, symbol)
    """

    lengths: np.ndarray
    codewords: np.ndarray
    first_code: np.ndarray
    start_pos: np.ndarray
    symbols: np.ndarray
    min_len: int
    max_len: int

    def left_justified_codes(self) -> np.ndarray:
        """codeword << (32 - length) per symbol (0 for absent symbols) —
        the encoder-side table for MSB-first packing."""
        sh = (32 - np.maximum(self.lengths, 1)).astype(np.uint64)
        lj = (self.codewords.astype(np.uint64) << sh).astype(np.uint32)
        return np.where(self.lengths > 0, lj, 0).astype(np.uint32)

    def first_code_left_justified(self, width: int = 32) -> np.ndarray:
        """first_code << (width - l), with sentinels so the branch-free scan
        `len = min_len + sum_l [v < fc[l]]` terminates correctly:
        0xFFFFFFFF for l < min_len and 0 for l > max_len."""
        fc = np.full(MAX_CODE_LEN + 2, 0xFFFFFFFF, dtype=np.uint64)
        fc[self.max_len + 1 :] = 0
        for l in range(self.min_len, self.max_len + 1):
            fc[l] = (np.uint64(self.first_code[l]) << np.uint64(width - l)) & np.uint64(0xFFFFFFFF)
        return fc[: MAX_CODE_LEN + 2].astype(np.uint32)

    def decode_offsets(self) -> np.ndarray:
        """offsets[l] = (start_pos[l] - first_code[l]) mod 2^32, so that
        symbol_index = (v >> (32-len)) + offsets[len]   (mod 2^32)."""
        out = np.zeros(MAX_CODE_LEN + 2, dtype=np.uint32)
        for l in range(self.min_len, self.max_len + 1):
            out[l] = np.uint32((int(self.start_pos[l]) - int(self.first_code[l])) & 0xFFFFFFFF)
        return out

    def decode_luts(self, table_bits: int = 16):
        """(lut, fc_lj, start_pos, symbols) for table-driven decode.

        lut[idx] packs (length << 16) | symbol for codes of length <=
        table_bits.  Entries whose true length exceeds table_bits store
        (length_lower_bound << 16) with symbol 0xFFFF (the decoder scans
        from table_bits + 1); slots no code covers stay 0.  The decode
        kernels build the same table on the card (ops/decode_table.py)."""
        size = 1 << table_bits
        lut = np.zeros(size, dtype=np.uint32)
        fc_lj = self.first_code_left_justified(32)
        sp = self.start_pos
        syms = self.symbols
        for l in range(self.min_len, self.max_len + 1):
            n_l = int(self.start_pos[l + 1] - self.start_pos[l]) if l + 1 < len(self.start_pos) else 0
            if n_l == 0:
                continue
            first = int(self.first_code[l])
            if l <= table_bits:
                # each code of length l owns 2^(table_bits-l) consecutive slots
                span = 1 << (table_bits - l)
                for k in range(n_l):
                    code = first + k
                    sym = int(syms[sp[l] + k])
                    if sym >= 0xFFFF:  # id too wide to embed -> escape path
                        sym = 0xFFFF
                    base = code << (table_bits - l)
                    lut[base : base + span] = (np.uint32(l) << 16) | np.uint32(sym)
            else:
                # mark the slot range covered by length-l codes with the
                # escape tag
                lo = (first << (32 - l)) >> (32 - table_bits)
                hi_code = first + n_l - 1
                hi = (hi_code << (32 - l)) >> (32 - table_bits)
                mask = lut[lo : hi + 1] == 0
                lut[lo : hi + 1] = np.where(mask, (np.uint32(l) << 16) | np.uint32(0xFFFF), lut[lo : hi + 1])
        return lut, fc_lj, sp.astype(np.uint32), syms.astype(np.uint32)


def canonical_codebook(lengths: np.ndarray) -> Codebook:
    """Assign canonical codes from lengths."""
    lengths = np.asarray(lengths, dtype=np.int32)
    n_sym = lengths.shape[0]
    max_len = int(lengths.max(initial=0))
    if max_len == 0:
        return Codebook(lengths, np.zeros(n_sym, np.uint32),
                        np.zeros(2, np.uint32), np.zeros(2, np.uint32),
                        np.zeros(0, np.int32), 0, 0)
    if max_len > MAX_CODE_LEN:
        raise ValueError(f"code length {max_len} exceeds {MAX_CODE_LEN}")

    num = np.bincount(lengths, minlength=max_len + 2).astype(np.int64)
    num[0] = 0
    nonzero = np.flatnonzero(num)
    min_len = int(nonzero[0])

    # start_pos[l] = number of symbols with length < l
    start_pos = np.zeros(max_len + 2, dtype=np.int64)
    start_pos[1:] = np.cumsum(num[: max_len + 1])

    # first_code recurrence, top-down (deeper codes numerically smaller)
    first_code = np.zeros(max_len + 1, dtype=np.int64)
    for l in range(max_len - 1, 0, -1):
        first_code[l] = (first_code[l + 1] + num[l + 1]) // 2

    codewords = np.zeros(n_sym, dtype=np.uint32)
    symbols_sorted = np.full(int(num.sum()), -1, dtype=np.int32)
    present = np.flatnonzero(lengths > 0)
    # rank within each length bucket in symbol order: sort present symbols
    # by (length, symbol)
    sort_idx = present[np.lexsort((present, lengths[present]))]
    ls = lengths[sort_idx]
    bucket_start = start_pos[ls]
    pos_in_sorted = np.arange(sort_idx.size)
    rank = pos_in_sorted - bucket_start
    codewords[sort_idx] = (first_code[ls] + rank).astype(np.uint32)
    symbols_sorted[pos_in_sorted] = sort_idx.astype(np.int32)

    # sentinel for l < min_len: a value above any l-bit code
    fc_out = first_code.astype(np.uint32)
    for l in range(1, min_len):
        fc_out[l] = np.uint32(1 << 31)

    return Codebook(
        lengths=lengths,
        codewords=codewords,
        first_code=fc_out,
        start_pos=start_pos.astype(np.uint32),
        symbols=symbols_sorted,
        min_len=min_len,
        max_len=max_len,
    )


def build_codebook(freqs: np.ndarray, limit: int | None = MAX_CODE_LEN) -> Codebook:
    return canonical_codebook(code_lengths(freqs, limit))


def codebook_from_lengths(lengths: np.ndarray) -> Codebook:
    """The codebook that code lengths describe (256 in byte mode, one per
    token of a HuffWord dictionary) — the whole codec state a container
    carries, so this turns any codebook's lengths (from either package)
    into a codebook for this one."""
    lengths = np.asarray(lengths)
    if lengths.ndim != 1:
        raise ValueError(f"expected a flat array of code lengths, got shape {lengths.shape}")
    return canonical_codebook(lengths)
