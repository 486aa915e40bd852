// The decode table the two byte decodes share: K3 (lockstep.cu) and the
// stream decode (bitstream.cu).
//
// A code's length and symbol come from one probe of a 2^table_bits-entry
// u16 table in shared memory, indexed by the window's first table_bits
// bits:
//
//   (len << 8) | sym   every window in the slot has a code of len <=
//                      table_bits bits and this symbol
//   level              no length field: the canonical scan starts at
//                      `level` (a slot of longer codes)
//
// Each block builds its table from the decode's own fc_lj / offsets /
// symtab (build_decode_table), so the wrappers pass nothing new and launch
// nothing more: building Codebook.decode_luts' table with tensor ops on the
// card cost 1.3-1.6 ms of host dispatch a call (PERF.md).  A slot is
// resolved when the canonical scan gives the same length, at most
// table_bits, at the slot's smallest and largest window: every level's
// compare [v < fc_lj[l]] is monotone in v, so then it is the same for every
// window of the slot, and so are the length, the offset and, the length
// being at most table_bits, the rank.  Otherwise the entry is the first
// level at which the slot's largest window is not below fc_lj; every window
// of the slot is below fc_lj at every level before it, so the scan from
// there gives the full scan's length and offset.  The table therefore
// changes no output, whatever the tables; for a complete code (every
// codebook of two or more symbols) it is the compacted form of
// Codebook.decode_luts (ops/decode_table.py: decode_lut, compact_lut).  On
// the benchmark corpus 10-12 bits resolve ~99% of codes (PERF.md), where the
// scan loads two shared entries per length level (~20 levels there).
// Shifts stay below 32: the rank's shift is (32 - len) & 31, as in the scan.

#pragma once

#include <cstdint>

namespace glz {

constexpr int kMaxTableBits = 12;
constexpr int kCodeLevels = 34;  // fc_lj / offsets entries (MAX_CODE_LEN + 2)

struct DecodeTable {
  uint16_t lut[1 << kMaxTableBits];
  uint32_t fc[kCodeLevels];
  uint32_t offs[kCodeLevels];
  uint32_t symtab[256];
  int shift;     // 32 - table_bits
  int min_len;
  int max_len;
  int monotone;  // fc[l] non-increasing over [min_len, max_len]
};

// The canonical scan from level lo: len = lo + sum_{l in [lo, max_len)}
// [v < fc[l]], the offset selected by the same compares; the rank's symbol
// in *sym.
__device__ __forceinline__ uint32_t scan_from(const DecodeTable& t, uint32_t v, uint32_t lo,
                                              uint32_t* sym) {
  uint32_t ln = lo;
  uint32_t off = t.offs[lo];
  for (int l = static_cast<int>(lo); l < t.max_len; ++l) {
    const bool c = v < t.fc[l];
    ln += c ? 1u : 0u;
    off = c ? t.offs[l + 1] : off;
  }
  *sym = t.symtab[((v >> ((32u - ln) & 31u)) + off) & 255u];
  return ln;
}

// All threads of the block; synchronises before returning.
__device__ __forceinline__ void build_decode_table(
    DecodeTable& t, int table_bits, const uint32_t* __restrict__ fc_g,
    const uint32_t* __restrict__ off_g, const uint32_t* __restrict__ symtab_g, int min_len,
    int max_len) {
  for (int i = threadIdx.x; i < kCodeLevels; i += blockDim.x) {
    t.fc[i] = fc_g[i];
    t.offs[i] = off_g[i];
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x) t.symtab[i] = symtab_g[i];
  if (threadIdx.x == 0) {
    t.shift = 32 - table_bits;
    t.min_len = min_len;
    t.max_len = max_len;
    int mono = 1;
    for (int l = min_len; l < max_len; ++l) mono &= fc_g[l] >= fc_g[l + 1];
    t.monotone = mono;
  }
  __syncthreads();
  const uint32_t low = (1u << t.shift) - 1u;
  for (int s = threadIdx.x; s < (1 << table_bits); s += blockDim.x) {
    const uint32_t v_lo = static_cast<uint32_t>(s) << t.shift;
    const uint32_t v_hi = v_lo | low;
    uint32_t lo = static_cast<uint32_t>(min_len);
    while (static_cast<int>(lo) < max_len && v_hi < t.fc[lo]) ++lo;
    uint32_t sym_lo, sym_hi;
    const uint32_t len_lo = scan_from(t, v_lo, lo, &sym_lo);
    const uint32_t len_hi = scan_from(t, v_hi, lo, &sym_hi);
    t.lut[s] = static_cast<uint16_t>(len_lo == len_hi && len_hi <= static_cast<uint32_t>(table_bits)
                                         ? (len_hi << 8) | sym_hi
                                         : lo);
  }
  __syncthreads();
}

// Length of the code at the top of the 32-bit window v; its symbol in *sym.
// Where fc is non-increasing (every complete code), the compares that hold
// are a prefix of the levels, so an escape's scan stops at the first that
// fails and its offset is that level's: the same length and offset in ~1-2
// levels instead of all of them to max_len.
__device__ __forceinline__ uint32_t decode_one(const DecodeTable& t, uint32_t v,
                                               uint32_t* sym) {
  const uint32_t e = t.lut[v >> t.shift];
  if (e >> 8) {
    *sym = e & 255u;
    return e >> 8;
  }
  if (!t.monotone) return scan_from(t, v, e, sym);
  uint32_t ln = e;
  while (static_cast<int>(ln) < t.max_len && v < t.fc[ln]) ++ln;
  *sym = t.symtab[((v >> ((32u - ln) & 31u)) + t.offs[ln]) & 255u];
  return ln;
}

}  // namespace glz
