// The decode tables of the table-driven decodes: the byte table K3
// (lockstep.cu) and the byte stream decode (bitstream.cu) share, and the
// two tables of the dual (HuffWord) stream decode (bitstream.cu).
//
// A code's length comes from one probe of a 2^table_bits-entry table in
// shared memory, indexed by the window's first table_bits bits.  A slot is
// resolved when the canonical scan gives the same length, at most
// table_bits, at the slot's smallest and largest window (probe_slot): every
// level's compare [v < fc_lj[l]] is monotone in v, so then it is the same
// for every window of the slot, and so are the length and the offset.
// Otherwise the entry is the slot's level: the first level at which its
// largest window is not below fc_lj.  Every window of the slot is below
// fc_lj at every level before it, so the scan from there gives the full
// scan's length and offset.  A table therefore changes no output, whatever
// the tables.  The entries:
//
//   byte (u16)   (len << 8) | sym for a resolved slot (the length <=
//                table_bits and the symbol), else the level (no length
//                field); for a complete code (every codebook of two or more
//                symbols) this is the compacted form of
//                Codebook.decode_luts (ops/decode_table.py)
//   dual (u8)    0x80 | len for a resolved slot, else the level; the rank
//                is (v >> (32 - len)) + offsets[len], computed from the
//                window, since HuffWord ranks do not fit an entry (up to
//                the vocabulary's size, above 65,535 for large ones)
//
// Each block builds its tables from the decode's own fc_lj / offsets (and
// symtab), so the wrappers pass nothing new and launch nothing more:
// building Codebook.decode_luts' table with tensor ops on the card cost
// 1.3-1.6 ms of host dispatch a call (PERF.md).  On the byte benchmark
// corpus 10-12 bits resolve ~99% of codes; on the HuffWord one a word table
// of 11 bits resolves ~70% of words and one of 14 bits ~85%, and the
// separators' table resolves every code (PERF.md).  Shifts stay below 32:
// the rank's shift is (32 - len) & 31, as in the scan.

#pragma once

#include <cstdint>

namespace glz {

constexpr int kMaxTableBits = 12;      // the byte table
constexpr int kMaxDualTableBits = 14;  // each dual table (2^14 u8 entries: 16 KiB)
constexpr int kCodeLevels = 34;        // fc_lj / offsets entries (MAX_CODE_LEN + 2)

// One canonical codebook's scan tables.
struct Canon {
  uint32_t fc[kCodeLevels];
  uint32_t offs[kCodeLevels];
  int min_len;
  int max_len;
  int monotone;  // fc[l] non-increasing over [min_len, max_len]
};

struct DecodeTable {
  uint16_t lut[1 << kMaxTableBits];
  Canon c;
  uint32_t symtab[256];
  int shift;  // 32 - table_bits
};

// The dual decode's two codebooks (set 0 for even tokens); their u8 tables
// lie in dynamic shared memory, table p at lut + base[p].
struct DualTable {
  Canon c[2];
  int shift[2];  // 32 - table p's bits
  int base[2];
};

// The canonical scan from level lo: len = lo + sum_{l in [lo, max_len)}
// [v < fc[l]], the offset selected by the same compares in *off.
__device__ __forceinline__ uint32_t scan_from(const Canon& c, uint32_t v, uint32_t lo,
                                              uint32_t* off) {
  uint32_t ln = lo;
  uint32_t o = c.offs[lo];
  for (int l = static_cast<int>(lo); l < c.max_len; ++l) {
    const bool less = v < c.fc[l];
    ln += less ? 1u : 0u;
    o = less ? c.offs[l + 1] : o;
  }
  *off = o;
  return ln;
}

// An escape's length and offset from its slot's level.  Where fc is
// non-increasing (every complete code), the compares that hold are a prefix
// of the levels, so the scan stops at the first that fails and its offset
// is that level's: the same length and offset in ~1-2 levels instead of
// all of them to max_len.
__device__ __forceinline__ uint32_t escape(const Canon& c, uint32_t v, uint32_t lo,
                                           uint32_t* off) {
  if (!c.monotone) return scan_from(c, v, lo, off);
  uint32_t ln = lo;
  while (static_cast<int>(ln) < c.max_len && v < c.fc[ln]) ++ln;
  *off = c.offs[ln];
  return ln;
}

// All threads of the block; the caller synchronises before using c.
__device__ __forceinline__ void load_canon(Canon& c, const uint32_t* __restrict__ fc_g,
                                           const uint32_t* __restrict__ off_g, int min_len,
                                           int max_len) {
  for (int i = threadIdx.x; i < kCodeLevels; i += blockDim.x) {
    c.fc[i] = fc_g[i];
    c.offs[i] = off_g[i];
  }
  if (threadIdx.x == 0) {
    c.min_len = min_len;
    c.max_len = max_len;
    int mono = 1;
    for (int l = min_len; l < max_len; ++l) mono &= fc_g[l] >= fc_g[l + 1];
    c.monotone = mono;
  }
}

// Slot s of a table of `bits` bits: its level, and whether it is resolved,
// with its length and the rank of its largest window.
struct Slot {
  uint32_t level, len, rank;
  bool resolved;
};

__device__ __forceinline__ Slot probe_slot(const Canon& c, uint32_t s, int bits) {
  const int shift = 32 - bits;
  const uint32_t v_lo = s << shift;
  const uint32_t v_hi = v_lo | ((1u << shift) - 1u);
  uint32_t lo = static_cast<uint32_t>(c.min_len);
  while (static_cast<int>(lo) < c.max_len && v_hi < c.fc[lo]) ++lo;
  uint32_t off_lo, off_hi;
  const uint32_t len_lo = scan_from(c, v_lo, lo, &off_lo);
  const uint32_t len_hi = scan_from(c, v_hi, lo, &off_hi);
  return {lo, len_hi, (v_hi >> ((32u - len_hi) & 31u)) + off_hi,
          len_lo == len_hi && len_hi <= static_cast<uint32_t>(bits)};
}

// All threads of the block; synchronises before returning.
__device__ __forceinline__ void build_decode_table(
    DecodeTable& t, int table_bits, const uint32_t* __restrict__ fc_g,
    const uint32_t* __restrict__ off_g, const uint32_t* __restrict__ symtab_g, int min_len,
    int max_len) {
  load_canon(t.c, fc_g, off_g, min_len, max_len);
  for (int i = threadIdx.x; i < 256; i += blockDim.x) t.symtab[i] = symtab_g[i];
  if (threadIdx.x == 0) t.shift = 32 - table_bits;
  __syncthreads();
  for (int s = threadIdx.x; s < (1 << table_bits); s += blockDim.x) {
    const Slot e = probe_slot(t.c, static_cast<uint32_t>(s), table_bits);
    t.lut[s] = static_cast<uint16_t>(e.resolved ? (e.len << 8) | t.symtab[e.rank & 255u]
                                                : e.level);
  }
  __syncthreads();
}

// Length of the code at the top of the 32-bit window v; its symbol in *sym.
__device__ __forceinline__ uint32_t decode_one(const DecodeTable& t, uint32_t v,
                                               uint32_t* sym) {
  const uint32_t e = t.lut[v >> t.shift];
  if (e >> 8) {
    *sym = e & 255u;
    return e >> 8;
  }
  uint32_t off;
  const uint32_t ln = escape(t.c, v, e, &off);
  *sym = t.symtab[((v >> ((32u - ln) & 31u)) + off) & 255u];
  return ln;
}

// Bits of dual table p: the word table's table_bits, no more than the
// codebook's longest code (the separators' table is small), at least 1.
__host__ __device__ __forceinline__ int dual_bits(int table_bits, int max_len) {
  const int b = max_len < table_bits ? max_len : table_bits;
  return b > 0 ? b : 1;
}

// All threads of the block; lut is dynamic shared memory of
// 2^dual_bits(table_bits, max0) + 2^dual_bits(table_bits, max1) bytes.
// Synchronises before returning.
__device__ __forceinline__ void build_dual_table(
    DualTable& t, uint8_t* lut, int table_bits, const uint32_t* __restrict__ fc_g,
    const uint32_t* __restrict__ off_g, int min0, int max0, int min1, int max1) {
  load_canon(t.c[0], fc_g, off_g, min0, max0);
  load_canon(t.c[1], fc_g + kCodeLevels, off_g + kCodeLevels, min1, max1);
  const int b0 = dual_bits(table_bits, max0), b1 = dual_bits(table_bits, max1);
  if (threadIdx.x == 0) {
    t.shift[0] = 32 - b0;
    t.shift[1] = 32 - b1;
    t.base[0] = 0;
    t.base[1] = 1 << b0;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < (1 << b0) + (1 << b1); s += blockDim.x) {
    const int p = s >= (1 << b0);
    const Slot e = probe_slot(t.c[p], static_cast<uint32_t>(p ? s - (1 << b0) : s),
                              p ? b1 : b0);
    lut[s] = static_cast<uint8_t>(e.resolved ? 0x80u | e.len : e.level);
  }
  __syncthreads();
}

// Length of the code at the top of the 32-bit window v under codebook p
// (0 for an empty dictionary's (0, 0) codebook); its rank in *rank.
__device__ __forceinline__ uint32_t decode_dual(const DualTable& t, const uint8_t* lut,
                                                uint32_t v, int p, uint32_t* rank) {
  const Canon& c = t.c[p];
  const uint32_t e = lut[t.base[p] + (v >> t.shift[p])];
  uint32_t ln, off;
  if (e & 0x80u) {
    ln = e & 0x7Fu;
    off = c.offs[ln];
  } else {
    ln = escape(c, v, e, &off);
  }
  *rank = (v >> ((32u - ln) & 31u)) + off;
  return ln;
}

// ---- the reference's two decoders without a table ----------------------------
//
// The stream decodes' other strategies, as glz_tpu's host decoders run them
// (glz_tpu/core/host_codec.py, glz_tpu/models/huffword.py:_decode_tokens_host),
// each a step over the Canon alone:
//
//   decode_bitwalk  CanonicalHuffDecoder (canonical_huff_encoder.cc:377-419):
//                   v = v << 1 | bit, one bit of the window at a time, until
//                   the first len in [min_len, max_len] with v >= first_code[len]
//                   (= fc[len] >> (32 - len) for every codebook of Kraft sum
//                   <= 1, the only ones an encoder writes)
//   decode_fast     FastCanonicalHuffDecoder (cc:422-461): len from min_len up
//                   while the window is below fc[len]
//
// Both give the rank (v >> (32 - len)) + offs[len], the index into the
// codebook's symbols, and flag a code that matches nothing: no len in
// [min_len, max_len] (fc is 0 past max_len, so the fast scan stops there
// anyway), or a rank not below the codebook's n_codes, where glz_tpu's
// decoders index past their symbols.  A flagged code's length is max_len
// (at least 1), so a guess that meets one moves on.
constexpr int kTable = 0;    // a stream decode's strategies
constexpr int kBitwalk = 1;
constexpr int kFast = 2;

// One decoded code: its length, its output (a rank, or a byte decode's
// symbol) and whether it matches no codeword.
struct Code {
  uint32_t len, out;
  bool bad;
};

__device__ __forceinline__ Code checked(const Canon& c, uint32_t n_codes, uint32_t v,
                                        int len) {
  if (len > c.max_len) return {c.max_len > 0 ? static_cast<uint32_t>(c.max_len) : 1u, 0u, true};
  const uint32_t rank = (v >> ((32 - len) & 31)) + c.offs[len];
  return {static_cast<uint32_t>(len), rank, rank >= n_codes};
}

__device__ __forceinline__ Code decode_bitwalk(const Canon& c, uint32_t n_codes, uint32_t w) {
  uint32_t v = 0u;
  int len = 1;
  for (; len <= c.max_len; ++len) {
    v = v << 1 | ((w >> (32 - len)) & 1u);
    if (len >= c.min_len && v >= c.fc[len] >> ((32 - len) & 31)) break;
  }
  return checked(c, n_codes, w, len);
}

__device__ __forceinline__ Code decode_fast(const Canon& c, uint32_t n_codes, uint32_t v) {
  int len = c.min_len > 0 ? c.min_len : 1;
  while (len <= c.max_len && v < c.fc[len]) ++len;
  return checked(c, n_codes, v, len);
}

template <int kStrategy>
__device__ __forceinline__ Code decode_untabled(const Canon& c, uint32_t n_codes, uint32_t v) {
  static_assert(kStrategy == kBitwalk || kStrategy == kFast, "a strategy without a table");
  return kStrategy == kBitwalk ? decode_bitwalk(c, n_codes, v) : decode_fast(c, n_codes, v);
}

// ---- the byte strategies' levels in registers ---------------------------------
//
// decode_bitwalk and decode_fast take one level at a time: a shared-memory
// load of fc[len], a compare and a branch that the next level's load waits
// on, and a warp runs as many levels as its longest code.  The byte forms'
// kernels (ByteLevels) take levels 1..kRegLevels from registers instead,
// every one of them for every code, with no load and no branch:
//
//   len = min_len + sum_{l = 1..kRegLevels} [x_l < lim[l]]
//
// x_l is the window v (fast), or the code accumulated over the window's
// first l bits, acc = acc << 1 | bit (bit-walk); lim[l] is fc[l] (fast) or
// first_code[l] = fc[l] >> (32 - l) (bit-walk) for l in [min_len, max_len],
// and 0 (a compare that never holds) elsewhere.  Each compare is its
// strategy's own at that level: [v < fc[l]] the fast scan's "go on",
// [acc < first_code[l]] the bit-walk's "no match yet".  Where fc is
// non-increasing over [min_len, max_len] and no fc[l] has a bit below its
// top l (every table an encoder writes: ByteCanon's `counted`), the
// compares that hold are a prefix of the levels from min_len, so their
// count gives the level at which the strategy's loop stops, and so its
// length.  A length past kRegLevels goes on from there, from shared memory,
// as the loop does; any other table runs the loop.  The compares are
// independent, so a code costs the same few instructions in every lane and
// the warp no longer runs to its longest code.
//
// Each level is two or three instructions, one of them on the count's
// chain: the compare is the sign of x_l - lim[l] on values below 2^31
// (the bit-walk's acc and first_code[l] have l bits; the fast scan
// compares v >> 1 with fc[l] >> 1, the same compare where fc[l]'s low bit
// is 0), added to the count in one step; the bit-walk's accumulation is one
// funnel shift (acc << 1 | the window's next bit, the window shifted off
// the chain), where the compiler makes acc << 1 | bit a shift and a merge,
// both on acc's chain (PERF.md has each form's time).
constexpr int kRegLevels = 12;
static_assert(kRegLevels >= 1 && kRegLevels <= 31, "acc and first_code stay below 2^31");

// The codebook of the byte strategies without a table, with its symbols
// and its register levels' limits (the dual form's pair: DualCanon, below).
template <int kStrategy>
struct ByteCanon {
  Canon c;
  uint32_t n_codes;
  uint32_t symtab[256];
  uint32_t lim[kRegLevels];  // level l's at lim[l - 1]
  int counted;               // the compares that hold are a prefix of the levels
};

// Level l's limit for strategy kStrategy (above), from the codebook's fc:
// first_code[l] (bit-walk) or fc[l] >> 1 (fast).
template <int kStrategy>
__device__ __forceinline__ uint32_t level_limit(const uint32_t* __restrict__ fc, int l,
                                                int min_len, int max_len) {
  if (l < min_len || l > max_len) return 0u;
  return kStrategy == kBitwalk ? fc[l] >> ((32 - l) & 31) : fc[l] >> 1;
}

// Whether the strategy's compares that hold are a prefix of the levels from
// min_len, and each is the one the count takes: fc non-increasing over
// [min_len, max_len], and each fc[l] without bits below its top l (then
// acc_l >= first_code[l] exactly where v >= fc[l], and v >> 1 < fc[l] >> 1
// exactly where v < fc[l]).
template <int kStrategy>
__device__ __forceinline__ int counted_levels(const uint32_t* __restrict__ fc, int min_len,
                                              int max_len) {
  int ok = 1;
  for (int l = min_len; l < max_len; ++l) ok &= fc[l] >= fc[l + 1];
  for (int l = min_len; l <= max_len && l < 32; ++l) ok &= (fc[l] << l) == 0u;
  return ok;
}

// All threads of the block; synchronises before returning.
template <int kStrategy>
__device__ __forceinline__ void build_byte_canon(ByteCanon<kStrategy>& t,
                                                 const uint32_t* __restrict__ fc_g,
                                                 const uint32_t* __restrict__ off_g,
                                                 const uint32_t* __restrict__ symtab_g,
                                                 uint32_t n_codes, int min_len, int max_len) {
  load_canon(t.c, fc_g, off_g, min_len, max_len);
  for (int i = threadIdx.x; i < 256; i += blockDim.x) t.symtab[i] = symtab_g[i];
  for (int l = threadIdx.x; l < kRegLevels; l += blockDim.x)
    t.lim[l] = level_limit<kStrategy>(fc_g, l + 1, min_len, max_len);
  if (threadIdx.x == 0) {
    t.n_codes = n_codes;
    t.counted = counted_levels<kStrategy>(fc_g, min_len, max_len);
  }
  __syncthreads();
}

// A thread's copy of the register levels, made at the start of each run of
// codes (a guess, a round or a write), and its decode of one code.
template <int kStrategy>
struct ByteLevels {
  const ByteCanon<kStrategy>& t;
  uint32_t lim[kRegLevels];
  uint32_t n_codes;
  int min_len, max_len;
  bool counted;

  __device__ __forceinline__ explicit ByteLevels(const ByteCanon<kStrategy>& b)
      : t(b), n_codes(b.n_codes), min_len(b.c.min_len), max_len(b.c.max_len),
        counted(b.counted != 0) {
#pragma unroll
    for (int l = 0; l < kRegLevels; ++l) lim[l] = b.lim[l];
  }

  // decode_untabled<kStrategy>(t.c, n_codes, w), with the levels above
  __device__ __forceinline__ Code decode(uint32_t w) const {
    if (!counted) return decode_untabled<kStrategy>(t.c, n_codes, w);
    int len = min_len;
    uint32_t acc = 0u;
#pragma unroll
    for (int l = 1; l <= kRegLevels; ++l) {
      if (kStrategy == kBitwalk) acc = __funnelshift_l(w << (l - 1), acc, 1);  // acc << 1 | bit
      len += ((kStrategy == kBitwalk ? acc : w >> 1) - lim[l - 1]) >> 31;  // [x_l < lim[l]]
    }
    if (len > kRegLevels) {  // the deeper levels, one at a time from shared memory
      if (kStrategy == kBitwalk) {
        for (len = kRegLevels + 1; len <= max_len; ++len) {
          acc = acc << 1 | ((w >> (32 - len)) & 1u);
          if (len >= min_len && acc >= t.c.fc[len] >> ((32 - len) & 31)) break;
        }
      } else {
        while (len <= max_len && w < t.c.fc[len]) ++len;
      }
    }
    if (len > max_len) return {static_cast<uint32_t>(max_len), 0u, true};  // max_len >= 1
    const uint32_t rank = (w >> ((32 - len) & 31)) + t.c.offs[len];
    return {static_cast<uint32_t>(len), rank, rank >= n_codes};
  }
};

// ---- the dual strategies' levels in registers -----------------------------------
//
// The dual form's tokens alternate between two codebooks by parity, so the
// lanes of a warp stand at different parities.  A run of codes (a guess, a
// round or a write) therefore steps in parity pairs: one code of the
// shallow set first where the run starts at its parity, then pairs of a
// deep-set code and a shallow-set code, the end test and the write's count
// checked between the two.  Each code of a pair takes its own set's levels
// from registers (SetLevels, ByteLevels' count on one set), so no lane
// selects between the sets level by level.  The deep set is the one with
// the longer longest code (the words: 3-19 bits on the HuffWord benchmark,
// ties to the even tokens' set), held to kDeepLevels levels; the other
// (the separators: 1-3 bits) to kShallowLevels.  A set's levels are
// ByteLevels': levels 1..k counted with no load and no branch where the
// set's table is `counted`, deeper ones from shared memory, any other
// table (and an empty dictionary's (0, 0) codebook, which a guess of the
// wrong parity can reach) through the strategy's loop.  Every code ends in
// `checked`, so a code that matches nothing has the loops' length,
// max(max_len, 1), and is flagged.  18 and 3 levels at 7 blocks an SM were
// the fastest of the depths 12-20, 2-4 and 6-8 blocks tried (PERF.md).
constexpr int kDeepLevels = 18;
constexpr int kShallowLevels = 3;
static_assert(kDeepLevels <= 31 && kShallowLevels >= 1, "acc and first_code stay below 2^31");

// The dual strategies' two codebooks (set p for the tokens of parity p),
// with the deep and the shallow set's level limits.
template <int kStrategy>
struct DualCanon {
  Canon c[2];
  uint32_t n_codes[2];
  uint32_t lim_deep[kDeepLevels];  // level l's at [l - 1]
  uint32_t lim_shallow[kShallowLevels];
  int counted[2];  // set p's compares that hold are a prefix of its levels
  int deep;        // the parity of the deep set
};

// All threads of the block; synchronises before returning.  fc_g, off_g:
// [2][kCodeLevels], set 0 first.
template <int kStrategy>
__device__ __forceinline__ void build_dual_canon(DualCanon<kStrategy>& t,
                                                 const uint32_t* __restrict__ fc_g,
                                                 const uint32_t* __restrict__ off_g, int min0,
                                                 int max0, int min1, int max1, uint32_t n0,
                                                 uint32_t n1) {
  load_canon(t.c[0], fc_g, off_g, min0, max0);
  load_canon(t.c[1], fc_g + kCodeLevels, off_g + kCodeLevels, min1, max1);
  const int deep = max1 > max0;
  const uint32_t* fc_deep = fc_g + deep * kCodeLevels;
  const uint32_t* fc_shallow = fc_g + (deep ^ 1) * kCodeLevels;
  const int min_d = deep ? min1 : min0, max_d = deep ? max1 : max0;
  const int min_s = deep ? min0 : min1, max_s = deep ? max0 : max1;
  for (int l = threadIdx.x; l < kDeepLevels; l += blockDim.x)
    t.lim_deep[l] = level_limit<kStrategy>(fc_deep, l + 1, min_d, max_d);
  for (int l = threadIdx.x; l < kShallowLevels; l += blockDim.x)
    t.lim_shallow[l] = level_limit<kStrategy>(fc_shallow, l + 1, min_s, max_s);
  if (threadIdx.x == 0) {
    t.n_codes[0] = n0;
    t.n_codes[1] = n1;
    t.counted[0] = max0 >= 1 && counted_levels<kStrategy>(fc_g, min0, max0);
    t.counted[1] = max1 >= 1 && counted_levels<kStrategy>(fc_g + kCodeLevels, min1, max1);
    t.deep = deep;
  }
  __syncthreads();
}

// One set's register levels, copied from the block's DualCanon at the start
// of each run of codes, and its decode of one code.
template <int kStrategy, int kLevels>
struct SetLevels {
  const Canon& c;
  uint32_t lim[kLevels];
  uint32_t n_codes;
  int min_len;
  bool counted;

  __device__ __forceinline__ SetLevels(const Canon& cs, const uint32_t* lim_s, uint32_t n,
                                       int cnt)
      : c(cs), n_codes(n), min_len(cs.min_len), counted(cnt != 0) {
#pragma unroll
    for (int l = 0; l < kLevels; ++l) lim[l] = lim_s[l];
  }

  // decode_untabled<kStrategy>(c, n_codes, w), with the levels above
  __device__ __forceinline__ Code decode(uint32_t w) const {
    if (!counted) return decode_untabled<kStrategy>(c, n_codes, w);
    int len = min_len;
    uint32_t acc = 0u;
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {  // level l + 1, as ByteLevels counts it
      if (kStrategy == kBitwalk) acc = __funnelshift_l(w << l, acc, 1);
      len += ((kStrategy == kBitwalk ? acc : w >> 1) - lim[l]) >> 31;
    }
    if (len > kLevels) {  // the deeper levels, one at a time from shared memory
      if (kStrategy == kBitwalk) {
        for (len = kLevels + 1; len <= c.max_len; ++len) {
          acc = acc << 1 | ((w >> (32 - len)) & 1u);
          if (len >= min_len && acc >= c.fc[len] >> ((32 - len) & 31)) break;
        }
      } else {
        while (len <= c.max_len && w < c.fc[len]) ++len;
      }
    }
    return checked(c, n_codes, w, len);
  }
};

// A thread's copy of both sets' levels for a run of codes.
template <int kStrategy>
struct DualLevels {
  SetLevels<kStrategy, kDeepLevels> deep;
  SetLevels<kStrategy, kShallowLevels> shallow;
  int deep_par;

  __device__ __forceinline__ explicit DualLevels(const DualCanon<kStrategy>& t)
      : deep(t.c[t.deep], t.lim_deep, t.n_codes[t.deep], t.counted[t.deep]),
        shallow(t.c[t.deep ^ 1], t.lim_shallow, t.n_codes[t.deep ^ 1], t.counted[t.deep ^ 1]),
        deep_par(t.deep) {}
};

}  // namespace glz
