"""The decode tables of the table-driven decodes: the byte table K3
(csrc/lockstep.cu) and the byte stream decode (csrc/bitstream.cu) share,
and the dual stream decode's two tables (dual_table_ref, decode_dual_ref:
a length or a level per slot, the rank computed from the window).  The
device side is csrc/decode_table.cuh.

A code's length and symbol come from one probe of a 2^table_bits-entry u16
table indexed by the window's first table_bits bits: (len << 8) | sym where
every window of the slot has a code of len <= table_bits bits, else the
level the canonical scan starts from (a zero length field).  Each kernel
block builds the table in shared memory from the decode's fc_lj / offsets /
symtab; table_ref is the plain version of that build and decode_one_ref of
the probe.  The table changes no output: for every table a probe and, where
it has no length, the scan from its level give the canonical scan's length
and symbol on every 32-bit window (the tests hold it against the scan on
every table_bits-bit prefix).

For a complete code (every codebook of two or more symbols) the table is
the compacted form (compact_lut) of Codebook.decode_luts' table
(glz_tpu/core/codebook.py, copied in core/codebook.py), which decode_lut
builds from the same tensors:

    (len << 16) | sym        slots of a code of len <= table_bits bits
    (len << 16) | 0xFFFF     slots of longer codes, len the shortest of them
    0                        slots no code covers (an incomplete code: a
                             one-code codebook)
"""

from __future__ import annotations

import torch

from glz_tpu_torch.ops.lockstep_encode import U32, as_u32, to_i32

ESCAPE = 0xFFFF  # the symbol field of decode_luts' escape entries


def canonical_scan(v: torch.Tensor, fc_lj: torch.Tensor, offsets: torch.Tensor,
                   lo, max_len: int):
    """(length, rank) of the windows v (u32 values in int64) by the
    canonical scan from level lo (an int, or a tensor like v) to max_len, as
    the kernels run it: len = lo + sum_{l in [lo, max_len)} [v < fc_lj[l]],
    the offset offsets[l + 1] of the last level whose compare holds (else
    offsets[lo]), rank = ((v >> (32 - len)) + off) mod 2^32."""
    fc, off_l = as_u32(fc_lj).tolist(), as_u32(offsets)
    start = torch.as_tensor(lo, device=v.device)
    ln = torch.zeros_like(v) + start
    off = torch.zeros_like(v) + off_l[start]
    for l in range(int(start.min()) if start.numel() else max_len, max_len):
        c = (start <= l) & (v < fc[l])
        ln += c
        off = torch.where(c, off_l[l + 1], off)
    return ln, ((v >> ((32 - ln) & 31)) + off) & U32


# ---- the reference's two decoders without a table -----------------------------

def _checked(v: torch.Tensor, ln: torch.Tensor, offsets: torch.Tensor, max_len: int,
             n_codes: int):
    """(length, rank) of codes of lengths ln (max_len + 1: none matched) at
    the windows v, as decode_table.cuh's checked: rank = ((v >> (32 - len)) +
    offsets[len]) mod 2^32, or -1 for a code that matches no codeword (no
    length, or a rank not below n_codes), whose length is then max(max_len,
    1)."""
    none = ln > max_len
    ln = torch.where(none, max(max_len, 1), ln)
    rank = ((v >> ((32 - ln) & 31)) + as_u32(offsets)[ln]) & U32
    return ln, torch.where(none | (rank >= n_codes), -1, rank)


def bitwalk_step(v: torch.Tensor, fc_lj: torch.Tensor, offsets: torch.Tensor, min_len: int,
                 max_len: int, n_codes: int):
    """Plain version of decode_table.cuh's decode_bitwalk (glz_tpu's
    decode_stream_bitwalk, the reference's CanonicalHuffDecoder): (length,
    rank) int64 tensors of the windows v (u32 values in int64), rank -1
    where no codeword matches.  The code's value is accumulated one bit of
    the window at a time, c = c << 1 | bit, and the length is the first len
    in [min_len, max_len] with c >= first_code[len] = fc_lj[len] >> (32 -
    len)."""
    fc = as_u32(fc_lj).tolist()
    c = torch.zeros_like(v)
    ln = torch.full_like(v, max_len + 1)
    for l in range(1, max_len + 1):
        c = (c << 1) | ((v >> (32 - l)) & 1)
        if l >= min_len:
            ln = torch.where((ln > max_len) & (c >= fc[l] >> (32 - l)), l, ln)
    return _checked(v, ln, offsets, max_len, n_codes)


def fast_step(v: torch.Tensor, fc_lj: torch.Tensor, offsets: torch.Tensor, min_len: int,
              max_len: int, n_codes: int):
    """Plain version of decode_table.cuh's decode_fast (glz_tpu's
    decode_stream_fast, the reference's FastCanonicalHuffDecoder): the
    length runs up from min_len (at least 1) while the window is below
    fc_lj[len]; (length, rank) as bitwalk_step gives them."""
    fc = as_u32(fc_lj).tolist()
    lo = max(min_len, 1)
    ln = torch.full_like(v, lo)
    below = torch.ones_like(v, dtype=torch.bool)
    for l in range(lo, max_len + 1):
        below &= v < fc[l]
        ln += below
    return _checked(v, ln, offsets, max_len, n_codes)


def _slots(fc_lj: torch.Tensor, offsets: torch.Tensor, min_len: int, max_len: int,
           bits: int):
    """(level, length at the smallest window, length and rank at the largest
    window) of each slot of a table of `bits` bits, as decode_table.cuh's
    probe_slot computes them: the level is the first at which the slot's
    largest window is not below fc_lj, and both scans start there."""
    dev = fc_lj.device
    shift = 32 - bits
    v_lo = torch.arange(1 << bits, device=dev) << shift
    v_hi = v_lo | ((1 << shift) - 1)
    fc = as_u32(fc_lj).tolist()
    lo = torch.full_like(v_lo, min_len)
    below = torch.ones_like(v_lo, dtype=torch.bool)
    for l in range(min_len, max_len):
        below &= v_hi < fc[l]
        lo += below
    len_lo, _ = canonical_scan(v_lo, fc_lj, offsets, lo, max_len)
    len_hi, rank = canonical_scan(v_hi, fc_lj, offsets, lo, max_len)
    return lo, len_lo, len_hi, rank


def table_ref(fc_lj: torch.Tensor, offsets: torch.Tensor, symtab: torch.Tensor,
              min_len: int, max_len: int, table_bits: int) -> torch.Tensor:
    """Plain version of decode_table.cuh's build_decode_table: the u16
    table (int64 values) [2^table_bits].  A slot is resolved where the scan
    gives the same length, at most table_bits, at its smallest and largest
    window; else its entry is the first level at which its largest window is
    not below fc_lj."""
    lo, len_lo, len_hi, rank = _slots(fc_lj, offsets, min_len, max_len, table_bits)
    sym = as_u32(symtab)[rank & 255]
    return torch.where((len_lo == len_hi) & (len_hi <= table_bits), (len_hi << 8) | sym, lo)


def decode_one_ref(v: torch.Tensor, table: torch.Tensor, fc_lj: torch.Tensor,
                   offsets: torch.Tensor, symtab: torch.Tensor, max_len: int,
                   table_bits: int):
    """Plain version of decode_table.cuh's decode_one: (length, symbol)
    int64 tensors of the windows v (u32 values in int64), by one probe of
    the u16 table and, where it has no length, the scan from its level."""
    e = table[v >> (32 - table_bits)]
    scan = e < 256
    ln, rank = canonical_scan(v, fc_lj, offsets, torch.where(scan, e, max_len), max_len)
    return (torch.where(scan, ln, e >> 8),
            torch.where(scan, as_u32(symtab)[rank & 255], e & 255))


def decode_lut(fc_lj: torch.Tensor, offsets: torch.Tensor, symtab: torch.Tensor,
               min_len: int, max_len: int, table_bits: int) -> torch.Tensor:
    """Codebook.decode_luts(table_bits)[0] as an int32 tensor (u32 bit
    patterns) [2^table_bits], on fc_lj's device, from the byte decodes'
    tables (fc_lj/offsets int32 [34], symtab int32 [256]).  Over the code
    lengths l in [min_len, max_len]: first_code[l] = fc_lj[l] >> (32 - l),
    start_pos[l] = offsets[l] + first_code[l], each length's count the next
    length's start_pos less its own, and the deepest length's count its
    strictly increasing run of symbols in symtab (symbols are sorted by
    (length, symbol) and symtab is zero-padded)."""
    dev = fc_lj.device
    lv = torch.arange(min_len, max_len + 1, device=dev)
    first = as_u32(fc_lj)[lv] >> (32 - lv)
    sp = (as_u32(offsets)[lv] + first) & U32
    sym = as_u32(symtab)
    j = torch.arange(256, device=dev)
    ends = (j >= sp[-1]) & torch.cat([sym[1:] <= sym[:-1], j.new_ones(1, dtype=torch.bool)])
    count = torch.cat([sp[1:], (torch.where(ends, j, 255).min() + 1).view(1)]) - sp
    s = torch.arange(1 << table_bits, device=dev)[:, None]
    idx = torch.arange(lv.numel(), device=dev)
    short = lv <= table_bits
    # a code of length l <= table_bits owns the slots whose top l bits are
    # it; the longest such length wins (decode_luts writes them in order)
    code = s >> (table_bits - lv).clamp(min=0)
    k = torch.where(short & (code >= first) & (code < first + count), idx, -1).max(dim=1).values
    kc = k.clamp(min=0)
    rank = (sp[kc] + code.gather(1, kc[:, None])[:, 0] - first[kc]).clamp(0, 255)
    resolved = (lv[kc] << 16) | sym[rank]
    # longer codes: the slots from their first to their last code's prefix,
    # tagged with the shortest length that reaches them
    lo = (first << (32 - lv)) >> (32 - table_bits)
    hi = ((first + count - 1) << (32 - lv)) >> (32 - table_bits)
    cover = ~short & (count > 0) & (s >= lo) & (s <= hi)
    e = torch.where(cover, idx, lv.numel()).min(dim=1).values
    escape = (lv[e.clamp(max=lv.numel() - 1)] << 16) | ESCAPE
    return to_i32(torch.where(k >= 0, resolved, torch.where(e < lv.numel(), escape, 0)))


def compact_lut(lut: torch.Tensor, table_bits: int, min_len: int) -> torch.Tensor:
    """decode_luts' table in the kernels' u16 form (int64 values): (len <<
    8) | sym for a resolved slot, else the scan's first level (the escape's
    length, or min_len for an uncovered slot)."""
    e = as_u32(lut)
    ln, sym = e >> 16, e & 0xFFFF
    return torch.where(e == 0, min_len, torch.where(sym == ESCAPE, ln, (ln << 8) | sym))


# ---- the dual (HuffWord) stream decode's tables ------------------------------

RESOLVED = 0x80  # the flag of a dual table's resolved entries


def dual_bits(table_bits: int, max_len: int) -> int:
    """Bits of a dual table (decode_table.cuh's dual_bits): the word table's
    table_bits, no more than the codebook's longest code, at least 1."""
    return max(min(table_bits, max_len), 1)


def dual_table_ref(fc_lj: torch.Tensor, offsets: torch.Tensor, min_len: int, max_len: int,
                   table_bits: int) -> torch.Tensor:
    """Plain version of one table of decode_table.cuh's build_dual_table:
    the u8 table (int64 values) [2^dual_bits(table_bits, max_len)] of one
    codebook, RESOLVED | len where every window of the slot has a code of
    len <= its bits, else the scan's level.  An empty dictionary's (0, 0)
    codebook resolves every slot to length 0."""
    bits = dual_bits(table_bits, max_len)
    lo, len_lo, len_hi, _ = _slots(fc_lj, offsets, min_len, max_len, bits)
    return torch.where((len_lo == len_hi) & (len_hi <= bits), RESOLVED | len_hi, lo)


def decode_dual_ref(v: torch.Tensor, table: torch.Tensor, fc_lj: torch.Tensor,
                    offsets: torch.Tensor, max_len: int, table_bits: int):
    """Plain version of decode_table.cuh's decode_dual for one codebook:
    (length, rank) int64 tensors of the windows v (u32 values in int64), by
    one probe of its table and, where the entry has no length, the scan from
    its level; rank = ((v >> (32 - len)) + offsets[len]) mod 2^32."""
    e = table[v >> (32 - dual_bits(table_bits, max_len))]
    scan = e < RESOLVED
    ln, rank = canonical_scan(v, fc_lj, offsets, torch.where(scan, e, max_len), max_len)
    ln_t = e & (RESOLVED - 1)
    rank_t = ((v >> ((32 - ln_t) & 31)) + as_u32(offsets)[ln_t]) & U32
    return torch.where(scan, ln, ln_t), torch.where(scan, rank, rank_t)
