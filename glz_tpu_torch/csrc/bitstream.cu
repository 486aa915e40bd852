// Bitstream (layout-0) codec kernels for Hopper (sm_90a).
//
//   K7 lookup_lj_lens_kernel     <- glz_tpu/ops/pallas_lut.py:_lut256_kernel, as
//                                   glz_tpu/ops/encode.py:lookup_lj_lens calls it
//      pack_scan_kernel,         <- the XLA cumsum and scatter of
//      pack_tiles_kernel            glz_tpu/ops/encode.py:pack_lj
//      decode_streams_sync_kernel<false, ..., kTable>
//                                <- the XLA loop of glz_tpu/ops/decode.py:decode_block
//                                   (byte mode)
//      decode_streams_sync_kernel<true, ..., kTable>
//                                <- the host dual-dictionary decode of
//                                   glz_tpu/models/huffword.py (HuffWord)
//      decode_streams_sync_kernel<false, ..., kBitwalk | kFast>
//                                <- glz_tpu/core/host_codec.py:decode_stream_bitwalk,
//                                   decode_stream_fast (byte mode)
//      decode_streams_sync_kernel<true, ..., kBitwalk | kFast>
//                                <- the bitwalk and fast branches of
//                                   glz_tpu/models/huffword.py:_decode_tokens_host
//
// A layout-0 payload is one MSB-first bit stream in u32 words (word w holds
// stream bits [32w, 32w + 32)); stream k holds symbols [k*S, (k+1)*S) and
// starts at a recorded bit offset.  All symbol, bit and word offsets are
// 64-bit.  Shifts by 32 are undefined in CUDA: every shift whose amount can
// reach 32 is selected around or done in 64 bits.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "decode_table.cuh"

namespace {

constexpr int kCodeTable = glz::kCodeLevels;

__device__ __forceinline__ int64_t grid_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

__device__ __forceinline__ int64_t global_thread() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// ---------------------------------------------------------------------------
// K7: lj[i] = lj_tbl[sym[i]], lens[i] = len_tbl[sym[i]], both 0 for
// i >= n_valid.  The TPU kernel is an in-vreg lane gather over a 2 x 128
// table, one table per launch (two launches when codes exceed 26 bits);
// here both 256-entry tables sit in shared memory and one launch writes both
// outputs.  Bound by bytes (1 byte in, 8 bytes out per symbol): each thread
// reads 4 symbols with one 4-byte load and writes 16 bytes to each output.
// ---------------------------------------------------------------------------
constexpr int kLookupThreads = 256;

__global__ void __launch_bounds__(kLookupThreads) lookup_lj_lens_kernel(
    const uint8_t* __restrict__ sym, int64_t n, int64_t n_valid,
    const uint32_t* __restrict__ lj_g, const uint32_t* __restrict__ len_g,
    uint32_t* __restrict__ lj, uint32_t* __restrict__ lens) {
  __shared__ uint32_t lj_t[256];
  __shared__ uint32_t len_t[256];
  lj_t[threadIdx.x] = lj_g[threadIdx.x];
  len_t[threadIdx.x] = len_g[threadIdx.x];
  __syncthreads();
  const int64_t n4 = (n + 3) / 4;
  for (int64_t q = global_thread(); q < n4; q += grid_stride()) {
    const int64_t i0 = 4 * q;
    if (i0 + 4 <= n) {
      const uint32_t b = reinterpret_cast<const uint32_t*>(sym)[q];
      uint32_t a[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t s = (b >> (8 * j)) & 255u;
        const bool valid = i0 + j < n_valid;
        a[j] = valid ? lj_t[s] : 0u;
        l[j] = valid ? len_t[s] : 0u;
      }
      reinterpret_cast<uint4*>(lj)[q] = make_uint4(a[0], a[1], a[2], a[3]);
      reinterpret_cast<uint4*>(lens)[q] = make_uint4(l[0], l[1], l[2], l[3]);
    } else {
      for (int64_t i = i0; i < n; ++i) {
        const bool valid = i < n_valid;
        lj[i] = valid ? lj_t[sym[i]] : 0u;
        lens[i] = valid ? len_t[sym[i]] : 0u;
      }
    }
  }
}

// A reader of the payload's bits from any bit position.  A 64-bit buffer
// holds the next 32..64 bits left-justified, and its top half is the 32-bit
// window; below 32 bits it takes the next word, loaded one refill ahead so
// its latency overlaps ~32/len codes.  Words past the payload read `fill`
// (0; all ones for the byte bit-walk, whose reference reads 1 bits past
// its payload's bytes).  (A reader that double-buffers 16-byte chunks, to
// give each load ~29 codes, spilled registers at 256 threads x 4 blocks and
// ran slower, PERF.md.)
struct BitReader {
  const uint32_t* words;
  int64_t n_words, wpos;
  uint64_t buf;
  int nbits;
  uint32_t next;
  uint32_t fill;

  __device__ __forceinline__ uint32_t load(int64_t i) const {
    return (i >= 0 && i < n_words) ? __ldg(words + i) : fill;
  }
  __device__ __forceinline__ BitReader(const uint32_t* w, int64_t n, int64_t pos,
                                       uint32_t fill_word)
      : words(w), n_words(n), wpos(pos >> 5), fill(fill_word) {
    const uint32_t phase = static_cast<uint32_t>(pos) & 31u;
    buf = ((static_cast<uint64_t>(load(wpos)) << 32) | load(wpos + 1)) << phase;
    nbits = 64 - static_cast<int>(phase);
    wpos += 2;
    next = load(wpos);
  }
  __device__ __forceinline__ uint32_t window() {
    if (nbits < 32) {
      buf |= static_cast<uint64_t>(next) << (32 - nbits);
      nbits += 32;
      next = load(++wpos);
    }
    return static_cast<uint32_t>(buf >> 32);
  }
  __device__ __forceinline__ void skip(uint32_t len) {  // len <= 32 <= nbits
    buf <<= len;
    nbits -= static_cast<int>(len);
  }
};

// ---------------------------------------------------------------------------
// The stream decodes: several self-synchronising decoders per stream
// (Weissenberger and Schmidt, "Massively Parallel Huffman Decoding on GPUs",
// ICPP 2018), one kernel template for both modes:
//   kDual = false  byte mode, one codebook, symtab[rank & 255] as u8
//   kDual = true   HuffWord, two codebooks alternating by token parity:
//                  token j of stream k scans codebook (k*S + j) & 1 (set 0
//                  is the even tokens'), and the output is the u32 rank
// and for each of the reference's three strategies (kStrategy): kTable
// takes each code from decode tables each block builds in shared memory;
// kBitwalk and kFast build none and run decode_table.cuh's decode_bitwalk
// and decode_fast on the codebook alone.  Those two also check each code of
// the write (step 3): one that matches no codeword sets *err, which the
// wrapper turns into an error (a guess may start anywhere, so its codes are
// not checked).  They compute the table's function on the same bytes, so
// share its bound.  Neither runs the loops' dependent shared-memory load a
// level: the byte forms take the levels up to glz::kRegLevels from
// registers, all of them for every code with no load and no branch
// (glz::ByteLevels), so every lane's code costs the same few instructions;
// the dual forms step in parity pairs, each code of a pair on its own
// set's register levels (glz::DualLevels: the deep set's kDeepLevels, the
// shallow set's kShallowLevels), so no lane selects between the sets
// (PERF.md).
// A decoder's state is its bit position and, in the dual form, its next
// token's parity (state = window-relative position << 1 | parity; the byte
// form's parity is always 0).  Stream k's bits are [starts[k], starts[k+1])
// (the last stream's run to the payload's end; a span is clamped to [0, 32
// * count] bits).  The span is cut into subsequences of T bits (T a
// multiple of 32) measured from starts[k], and subsequence i decodes the
// codes that start in [starts[k] + iT, starts[k] + (i+1)T):
//   1. guess: subsequence 0 starts at (starts[k], (k*S) & 1), every other at
//      its first bit with the stream's first parity (a guess of one parity
//      only: a chain of the wrong parity is a chain from a wrong position,
//      and meets the true one as any other does); each records its exit
//      state (at the first code boundary at or past its end), its code
//      count and its meeting point (below) in shared memory;
//   2. synchronise: while some subsequence i's start state differs from
//      subsequence i-1's exit state, each such i decodes again from that
//      exit.  A start that equals a true code boundary (and parity) stays
//      one, so this ends within as many rounds as there are subsequences,
//      exactly; on varied code lengths decoders meet the true chain within
//      a few codes and it takes one round (PERF.md).  The guess records its
//      first boundary kMeetBits into the subsequence (its meeting point)
//      and its codes from there on, so a round decodes only up to the
//      meeting point: if the new chain lands on it with the same parity,
//      the guess's exit and count from there on stand; if not (the chains
//      have not met), it decodes the rest.  Cutting at multiples of 32
//      bits from the stream's start also synchronises uniform 8-bit byte
//      codes at once;
//   3. write: an exclusive block scan of the counts gives each
//      subsequence's first symbol index, and each decodes once more from
//      its synchronised start, writing the symbols whose index is below the
//      stream's count min(S, n_symbols - k*S).
// The stream's last subsequence has no end: it decodes until the stream
// has its count, past the recorded end if need be, as the serial walk does
// (so a dispatch's word-alignment pad and any other span give the plain
// version's output).  A stream longer than kThreads * kSubs subsequences is
// done in windows of that many, each starting at the previous one's exact
// exit state.  Codes come from the shared decode tables (decode_table.cuh).
// The write knows each subsequence's count and gathers its outputs into
// 16-byte stores (write_run, write_ranks): each thread writes its own run,
// far from its warp's other threads, where 4-byte stores would cost a
// 32-byte sector transaction for every few bytes.  Bound by bytes (the
// payload read once, the output written once); the subsequences spread
// each stream's serial chain over a block and the streams over all SMs.
//
// Geometry.  Byte mode: one block of 256 threads x 8 subsequences per
// stream (2^18-symbol streams are ~2,300 subsequences of 1,024 bits).  The
// dual form's streams are short (16,384 tokens, ~87,000 bits on the
// HuffWord benchmark: ~230 subsequences of 384 bits), so its blocks are 128
// threads x 2 subsequences, as many as fit on the card (8 an SM; 7 for the
// strategies without a table, whose register levels take 70 registers),
// each building its tables once and walking the streams with a stride.  An
// empty dictionary's codebook is (0, 0) and decodes a length of 0: no
// valid token uses it, but a guess of the wrong parity can, so the guess
// and the rounds advance by at least one bit and never stand still.
// ---------------------------------------------------------------------------
constexpr int kMeetBits = 128;  // a guess's meeting point: its first boundary this far in

// Exclusive prefix of x over the block (thread order); the block total in
// *total.  The caller synchronises before warp_tot is used again.
template <int kThreads>
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int wt = lane < kThreads / 32 ? warp_tot[lane] : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, wt, o);
    if (lane >= o) wt += y;
  }
  const int before = __shfl_sync(0xffffffffu, wt, (warp + 31) & 31);
  *total = __shfl_sync(0xffffffffu, wt, 31);
  return (warp ? before : 0) + inc - x;
}

// ---------------------------------------------------------------------------
// The bit pack: glz_tpu/ops/encode.py:pack_lj's function.  Codes lj[i]
// (left-justified, u32) of lens[i] bits are laid end to end from bit phase0
// (< 32) of words[0]; stream k's bits are those of codes [k*S, (k+1)*S).
// Two kernels and a cumsum between them:
//   pack_scan_kernel   tile_end[b] = the bits of tile b (4,096 codes)
//   torch.cumsum       tile_end[b] = the bits of tiles 0..b (n/4,096 values)
//   pack_tiles_kernel  the words, and each stream's first bit
// Bound by bytes: the function reads 8 bytes a code and writes the words
// once (4.4 bits a code on the byte corpus: ~0.55 bytes).  The first port
// (PERF.md) ran a torch int64 cumsum, a subtraction and a per-stream sum
// over all n codes, read the 8-byte offsets, and did one or two atomicOr a
// code in L2, where ~7 codes share a word and their atomics serialise.
// Here each block packs one tile: a thread takes 16 consecutive codes (four
// 16-byte loads each of lj and lens), a block scan of the threads' bit
// counts places its run, and it lays its codes into the tile's words in
// shared memory: whole words with plain stores (no other thread touches a
// word that starts and ends inside its run), its first and last word with
// a shared-memory atomicOr.  Then the block writes the tile's words out in
// order (coalesced), plain stores but for the tile's first and last word,
// which it shares with the neighbouring tiles and ORs into the zeroed
// output.  The only traffic past the function's is the second read of lens
// by pack_scan_kernel and the output's zero fill.  Shifts stay below 32.
// ---------------------------------------------------------------------------
constexpr int kPackThreads = 256;
constexpr int kPackRun = 16;                        // codes a thread
constexpr int kPackTile = kPackThreads * kPackRun;  // codes a block
constexpr int kPackTileWords = kPackTile + 1;       // 32-bit codes from any phase

// The 16 values of a thread's run (0 past n), in 16-byte loads where the
// run is whole (src 16-byte aligned; first is a multiple of 16).
__device__ __forceinline__ void load_run(const uint32_t* __restrict__ src, int64_t first,
                                         int64_t n, uint32_t (&v)[kPackRun]) {
  if (first + kPackRun <= n) {
    const uint4* p = reinterpret_cast<const uint4*>(src + first);
#pragma unroll
    for (int q = 0; q < kPackRun / 4; ++q) {
      const uint4 x = __ldcs(p + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPackRun; ++i) v[i] = first + i < n ? src[first + i] : 0u;
  }
}

__global__ void __launch_bounds__(kPackThreads) pack_scan_kernel(
    const uint32_t* __restrict__ lens, int64_t n, int64_t* __restrict__ tile_bits) {
  __shared__ int warp_sum[kPackThreads / 32];
  uint32_t l[kPackRun];
  load_run(lens, static_cast<int64_t>(blockIdx.x) * kPackTile + threadIdx.x * kPackRun, n, l);
  int s = 0;
#pragma unroll
  for (int i = 0; i < kPackRun; ++i) s += static_cast<int>(l[i]);
  s = __reduce_add_sync(0xffffffffu, s);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < kPackThreads / 32; ++w) t += warp_sum[w];
    tile_bits[blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(kPackThreads) pack_tiles_kernel(
    const uint32_t* __restrict__ lj, const uint32_t* __restrict__ lens, int64_t n,
    const int64_t* __restrict__ tile_end, int phase0, int64_t S, uint32_t* __restrict__ words,
    int64_t n_words, int64_t* __restrict__ starts) {
  __shared__ uint32_t tile_words[kPackTileWords];
  __shared__ int warp_tot[kPackThreads / 32];
  const int64_t b = blockIdx.x;
  const int64_t first = b * kPackTile + threadIdx.x * kPackRun;
  uint32_t l[kPackRun], c[kPackRun];
  load_run(lens, first, n, l);
  load_run(lj, first, n, c);
  int run = 0;
#pragma unroll
  for (int i = 0; i < kPackRun; ++i) run += static_cast<int>(l[i]);
  int total;
  const int pre = block_exclusive_scan<kPackThreads>(run, warp_tot, &total);
  const int64_t tile_bit = b ? tile_end[b - 1] : 0;  // the tile's first bit, in the dispatch
  const int64_t lo = tile_bit + phase0;               // ... and in the words
  const int64_t w0 = lo >> 5;                         // the tile's first word
  const int span = total ? static_cast<int>(((lo + total - 1) >> 5) - w0 + 1) : 0;
  for (int i = threadIdx.x; i < span; i += kPackThreads) tile_words[i] = 0u;
  // the first bit of each stream that starts in this run
  for (int64_t at = (first + S - 1) / S * S; at < first + kPackRun && at < n; at += S) {
    int part = 0;
#pragma unroll
    for (int i = 0; i < kPackRun; ++i) part += i < at - first ? static_cast<int>(l[i]) : 0;
    starts[at / S] = tile_bit + pre + part;
  }
  if (b == gridDim.x - 1 && threadIdx.x == 0) starts[n / S] = tile_end[b];
  __syncthreads();
  // this run's codes into the tile's words; bit positions from word w0's first
  const int pos = static_cast<int>(lo & 31) + pre;
  const int first_w = pos >> 5;
  int wi = first_w;
  uint32_t ph = static_cast<uint32_t>(pos) & 31u;
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < kPackRun; ++i) {
    const uint32_t ln = l[i];
    if (ln == 0u) continue;
    acc |= c[i] >> ph;
    if (ph + ln >= 32u) {  // the word is full: whole inside the run unless it is the first
      if (wi == first_w) atomicOr(tile_words + wi, acc); else tile_words[wi] = acc;
      ++wi;
      acc = ph ? c[i] << (32u - ph) : 0u;
      ph = ph + ln - 32u;
    } else {
      ph += ln;
    }
  }
  if (ph) atomicOr(tile_words + wi, acc);  // the run's last word, shared with the next run
  __syncthreads();
  for (int i = threadIdx.x; i < span; i += kPackThreads) {
    const int64_t w = w0 + i;
    const uint32_t v = tile_words[i];
    if (w >= n_words) break;
    if (i == 0 || i == span - 1) {
      if (v) atomicOr(words + w, v);
    } else {
      words[w] = v;
    }
  }
}

// The decode's tables for each form and strategy, and what sets them apart.
template <bool kDual, int kStrategy>
using TableOf = std::conditional_t<
    kStrategy == glz::kTable, std::conditional_t<kDual, glz::DualTable, glz::DecodeTable>,
    std::conditional_t<kDual, glz::DualCanon<kStrategy>, glz::ByteCanon<kStrategy>>>;

template <class Table>
constexpr bool kIsDual = false;
template <>
constexpr bool kIsDual<glz::DualTable> = true;
template <int kStrategy>
constexpr bool kIsDual<glz::DualCanon<kStrategy>> = true;

// The word a reader sees past the payload: all ones for the byte bit-walk.
template <class Table>
constexpr uint32_t kFill = 0u;
template <>
constexpr uint32_t kFill<glz::ByteCanon<glz::kBitwalk>> = 0xFFFFFFFFu;

// One code of either form and strategy at the window v, in parity par: its
// length, its output (symbol or rank) and whether it matches no codeword
// (never, for the tables); the advance a guess or a round takes for it (at
// least one bit in the dual form).
__device__ __forceinline__ glz::Code decode_code(const glz::DecodeTable& t, const uint8_t*,
                                                 uint32_t v, int) {
  uint32_t sym;
  const uint32_t ln = glz::decode_one(t, v, &sym);
  return {ln, sym, false};
}

__device__ __forceinline__ glz::Code decode_code(const glz::DualTable& t, const uint8_t* lut,
                                                 uint32_t v, int par) {
  uint32_t rank;
  const uint32_t ln = glz::decode_dual(t, lut, v, par, &rank);
  return {ln, rank, false};
}

template <int kStrategy>
__device__ __forceinline__ glz::Code decode_code(const glz::ByteLevels<kStrategy>& d,
                                                 const uint8_t*, uint32_t v, int) {
  const glz::ByteCanon<kStrategy>& t = d.t;
  glz::Code c = d.decode(v);
  c.out = t.symtab[c.out & 255u];
  return c;
}

// What a run of codes (decode_span, write_run) decodes with: the table
// itself, or for the byte strategies a register copy of its levels
// (glz::ByteLevels), made once a run (the dual strategies' runs, below,
// make glz::DualLevels).
template <class Table>
__device__ __forceinline__ const Table& levels(const Table& t) { return t; }
template <int kStrategy>
__device__ __forceinline__ glz::ByteLevels<kStrategy> levels(const glz::ByteCanon<kStrategy>& t) {
  return glz::ByteLevels<kStrategy>(t);
}

template <class Table>
__device__ __forceinline__ uint32_t advance(const Table&, uint32_t ln) { return ln; }
__device__ __forceinline__ uint32_t advance(const glz::DualTable&, uint32_t ln) {
  return ln ? ln : 1u;
}

// Decodes the codes from bit *pos while *pos < end; returns their count
// and leaves *pos at the next code boundary and *par at its parity.
template <class Table>
__device__ __forceinline__ int64_t decode_span(const Table& t, const uint8_t* lut,
                                               const uint32_t* __restrict__ words,
                                               int64_t n_words, int64_t* pos, int* par,
                                               int64_t end) {
  BitReader r(words, n_words, *pos, kFill<Table>);
  const auto& d = levels(t);
  int64_t p = *pos, n = 0;
  int q = *par;
  while (p < end) {
    const uint32_t ln = advance(t, decode_code(d, lut, r.window(), q).len);
    r.skip(ln);
    p += ln;
    if constexpr (kIsDual<Table>) q ^= 1;
    ++n;
  }
  *pos = p;
  *par = q & 1;
  return n;
}

// decode_span for the dual strategies, in parity pairs: a shallow-set code
// first where the run starts at its parity, then (deep, shallow) pairs.
// It and the dual strategies' write_run are called, not inlined: the kernel
// runs decode_span from eight places (the guess's two runs and a round's
// two, for each of a thread's two subsequences) and write_run from two, and
// ten inlined copies of the register decodes outgrow the instruction cache
// (PERF.md: the bit-walk 1.304 ms inlined, 0.958 called).
template <int kStrategy>
__device__ __noinline__ int64_t decode_span(const glz::DualCanon<kStrategy>& t,
                                               const uint8_t*, const uint32_t* __restrict__ words,
                                               int64_t n_words, int64_t* pos, int* par,
                                               int64_t end) {
  BitReader r(words, n_words, *pos, kFill<glz::DualCanon<kStrategy>>);
  const glz::DualLevels<kStrategy> d(t);
  int64_t p = *pos, n = 0;
  int q = *par;
  if (p < end && q != d.deep_par) {
    const uint32_t ln = d.shallow.decode(r.window()).len;
    r.skip(ln);
    p += ln;
    ++n;
    q = d.deep_par;
  }
  while (p < end) {
    uint32_t ln = d.deep.decode(r.window()).len;
    r.skip(ln);
    p += ln;
    ++n;
    if (p >= end) {
      q = d.deep_par ^ 1;
      break;
    }
    ln = d.shallow.decode(r.window()).len;
    r.skip(ln);
    p += ln;
    ++n;
  }
  *pos = p;
  *par = q;
  return n;
}

// Stores bytes [lo, hi] of the 16-byte piece at out + piece, whose words
// are p0..p3: whole words where they lie inside [lo, hi], else bytes.
__device__ __forceinline__ void store_piece_part(uint8_t* __restrict__ out, int64_t piece,
                                                 uint32_t p0, uint32_t p1, uint32_t p2,
                                                 uint32_t p3, int64_t lo, int64_t hi) {
  for (int64_t b = lo; b <= hi;) {
    const int64_t q = (b - piece) >> 2;
    const uint32_t w = q == 0 ? p0 : q == 1 ? p1 : q == 2 ? p2 : p3;
    if ((b & 3) == 0 && b + 3 <= hi) {
      *reinterpret_cast<uint32_t*>(out + b) = w;
      b += 4;
    } else {
      out[b] = static_cast<uint8_t>(w >> (8 * (b & 3)));
      ++b;
    }
  }
}

// Decodes the c codes from bit pos into out[g0, g0 + c) in 16-byte stores
// on 16-byte boundaries (the pieces at the run's two ends, which it shares
// with its neighbours, go out in words and bytes).  The loop starts at the
// 16-byte boundary at or below g0 and decodes from g0 on, so every thread
// of a warp is at the same place in its piece on every step: the word and
// piece boundaries fall on the same steps for all of them.  A code that
// matches no codeword sets *err.
template <class Table, std::enable_if_t<!kIsDual<Table>, int> = 0>
__device__ __forceinline__ void write_run(const Table& t, const uint8_t* lut,
                                          const uint32_t* __restrict__ words, int64_t n_words,
                                          int64_t pos, int, int64_t c, void* out_v,
                                          int64_t g0, int* __restrict__ err) {
  uint8_t* __restrict__ out = static_cast<uint8_t*>(out_v);
  BitReader r(words, n_words, pos, kFill<Table>);
  const auto& d = levels(t);
  const int64_t g_end = g0 + c;
  uint32_t acc = 0u, q0 = 0u, q1 = 0u, q2 = 0u;  // the word being filled; the piece's words
  int64_t g = g0 & ~int64_t{15};
  for (; g < g_end; ++g) {
    uint32_t sym = 0u;
    if (g >= g0) {
      const glz::Code k = decode_code(d, lut, r.window(), 0);
      r.skip(k.len);
      sym = k.out;
      if (k.bad) *err = 1;
    }
    acc |= sym << (8 * (g & 3));
    if ((g & 3) == 3) {
      if ((g & 15) == 15) {
        if (g - 15 >= g0)
          *reinterpret_cast<uint4*>(out + g - 15) = make_uint4(q0, q1, q2, acc);
        else
          store_piece_part(out, g - 15, q0, q1, q2, acc, g0, g);
      } else {
        q0 = q1;
        q1 = q2;
        q2 = acc;
      }
      acc = 0u;
    }
  }
  if (g & 15) {  // the last piece: its whole words are the queue's last ones
    const int64_t piece = g & ~int64_t{15};
    const int w = static_cast<int>((g & 15) >> 2);
    const uint32_t p0 = w == 0 ? acc : w == 1 ? q2 : w == 2 ? q1 : q0;
    const uint32_t p1 = w == 1 ? acc : w == 2 ? q2 : q1;
    const uint32_t p2 = w == 2 ? acc : q2;
    store_piece_part(out, piece, p0, p1, p2, acc, piece > g0 ? piece : g0, g - 1);
  }
}

// The dual form of write_run: the c ranks from bit pos (parity par) into
// out[g0, g0 + c), four ranks to a 16-byte store on 16-byte boundaries
// (the pieces at the run's ends go out in u32 stores).  The loop starts at
// the piece boundary at or below g0, as write_run's does.
template <class Table, std::enable_if_t<std::is_same_v<Table, glz::DualTable>, int> = 0>
__device__ __forceinline__ void write_run(const Table& t, const uint8_t* lut,
                                          const uint32_t* __restrict__ words, int64_t n_words,
                                          int64_t pos, int par, int64_t c, void* out_v,
                                          int64_t g0, int* __restrict__ err) {
  uint32_t* __restrict__ out = static_cast<uint32_t*>(out_v);
  BitReader r(words, n_words, pos, kFill<Table>);
  const int64_t g_end = g0 + c;
  uint32_t q0 = 0u, q1 = 0u, q2 = 0u;  // the piece's ranks so far
  int64_t g = g0 & ~int64_t{3};
  for (; g < g_end; ++g) {
    uint32_t rank = 0u;
    if (g >= g0) {
      const glz::Code k = decode_code(t, lut, r.window(), par);
      r.skip(k.len);
      rank = k.out;
      if (k.bad) *err = 1;
      par ^= 1;
    }
    if ((g & 3) == 3) {
      if (g - 3 >= g0) {
        *reinterpret_cast<uint4*>(out + g - 3) = make_uint4(q0, q1, q2, rank);
      } else {
        if (g - 2 >= g0) out[g - 2] = q1;
        if (g - 1 >= g0) out[g - 1] = q2;
        out[g] = rank;
      }
    } else {
      q0 = q1;
      q1 = q2;
      q2 = rank;
    }
  }
  const int w = static_cast<int>(g & 3);  // the last piece's ranks: the queue's last w
  if (w >= 3 && g - 3 >= g0) out[g - 3] = q0;
  if (w >= 2 && g - 2 >= g0) out[g - 2] = q1;
  if (w >= 1 && g - 1 >= g0) out[g - 1] = q2;
}

// write_run for the dual strategies: the same stores, from g0 on, with the
// codes in decode_span's parity pairs.  A code that matches no codeword
// sets *err.
template <int kStrategy>
__device__ __noinline__ void write_run(const glz::DualCanon<kStrategy>& t, const uint8_t*,
                                          const uint32_t* __restrict__ words, int64_t n_words,
                                          int64_t pos, int par, int64_t c, void* out_v,
                                          int64_t g0, int* __restrict__ err) {
  uint32_t* __restrict__ out = static_cast<uint32_t*>(out_v);
  BitReader r(words, n_words, pos, kFill<glz::DualCanon<kStrategy>>);
  const glz::DualLevels<kStrategy> d(t);
  const int64_t g_end = g0 + c;
  uint32_t q0 = 0u, q1 = 0u, q2 = 0u;  // ranks g - 3, g - 2 and g - 1 of the piece
  int64_t g = g0;
  auto put = [&](const glz::Code& k) {  // rank g, then the next
    r.skip(k.len);
    if (k.bad) *err = 1;
    if ((g & 3) == 3) {
      if (g - 3 >= g0) {
        *reinterpret_cast<uint4*>(out + g - 3) = make_uint4(q0, q1, q2, k.out);
      } else {
        if (g - 2 >= g0) out[g - 2] = q1;
        if (g - 1 >= g0) out[g - 1] = q2;
        out[g] = k.out;
      }
    } else {
      q0 = q1;
      q1 = q2;
      q2 = k.out;
    }
    ++g;
  };
  if (par != d.deep_par) put(d.shallow.decode(r.window()));  // c >= 1
  while (g < g_end) {
    put(d.deep.decode(r.window()));
    if (g >= g_end) break;
    put(d.shallow.decode(r.window()));
  }
  const int left = static_cast<int>(g & 3);  // the last piece's: the queue's last ones
  if (left >= 3 && g - 3 >= g0) out[g - 3] = q0;
  if (left >= 2 && g - 2 >= g0) out[g - 2] = q1;
  if (left >= 1 && g - 1 >= g0) out[g - 1] = q2;
}

// The decode's codebooks: fc_lj / offsets ([2][34] u32 in the dual form,
// set 0 for even tokens), the byte form's symtab, each set's length range
// and (for the strategies without a table) its count of codes.
struct Codebooks {
  const uint32_t* fc;
  const uint32_t* offs;
  const uint32_t* symtab;
  int min_len[2], max_len[2];
  int table_bits;
  uint32_t n_codes[2];
};

// All threads of the block; each builds its tables (or loads its
// codebooks) and synchronises.
__device__ __forceinline__ void build(glz::DecodeTable& t, uint8_t*, const Codebooks& cbs) {
  glz::build_decode_table(t, cbs.table_bits, cbs.fc, cbs.offs, cbs.symtab, cbs.min_len[0],
                          cbs.max_len[0]);
}

__device__ __forceinline__ void build(glz::DualTable& t, uint8_t* lut, const Codebooks& cbs) {
  glz::build_dual_table(t, lut, cbs.table_bits, cbs.fc, cbs.offs, cbs.min_len[0],
                        cbs.max_len[0], cbs.min_len[1], cbs.max_len[1]);
}

template <int kStrategy>
__device__ __forceinline__ void build(glz::ByteCanon<kStrategy>& t, uint8_t*,
                                      const Codebooks& cbs) {
  glz::build_byte_canon(t, cbs.fc, cbs.offs, cbs.symtab, cbs.n_codes[0], cbs.min_len[0],
                        cbs.max_len[0]);
}

template <int kStrategy>
__device__ __forceinline__ void build(glz::DualCanon<kStrategy>& t, uint8_t*,
                                      const Codebooks& cbs) {
  glz::build_dual_canon(t, cbs.fc, cbs.offs, cbs.min_len[0], cbs.max_len[0], cbs.min_len[1],
                        cbs.max_len[1], cbs.n_codes[0], cbs.n_codes[1]);
}

template <bool kDual, int kThreads, int kSubs, int kMinBlocks, int kStrategy>
__global__ void __launch_bounds__(kThreads, kMinBlocks) decode_streams_sync_kernel(
    const uint32_t* __restrict__ words, int64_t n_words,
    const int64_t* __restrict__ starts, int64_t n_streams, int64_t n_symbols, int64_t S,
    const Codebooks cbs, int T, void* __restrict__ out, int* __restrict__ err) {
  constexpr int kWindowSubs = kThreads * kSubs;
  using Table = TableOf<kDual, kStrategy>;
  __shared__ Table tbl;
  extern __shared__ uint8_t dual_lut[];     // the dual tables' entries
  __shared__ uint32_t exit_s[kWindowSubs];  // window-relative exit state; then first index
  __shared__ uint32_t meet_s[kWindowSubs];  // the guess's meeting point, window-relative state
  __shared__ uint16_t cnt_s[kWindowSubs];
  __shared__ uint16_t tail_s[kWindowSubs];  // the guess's codes from its meeting point on
  __shared__ int warp_tot[kThreads / 32];
  build(tbl, dual_lut, cbs);
  constexpr int64_t kNoEnd = INT64_MAX;

  for (int64_t k = blockIdx.x; k < n_streams; k += gridDim.x) {
    const int64_t first_sym = k * S;
    const int64_t left = n_symbols - first_sym;
    const int64_t count = left <= 0 ? 0 : (left < S ? left : S);
    if (count == 0) continue;
    const int64_t start = starts[k];
    const int64_t stop = k + 1 < n_streams ? starts[k + 1] : 32 * n_words;
    const int64_t cap = stop - start < 32 * count ? stop - start : 32 * count;
    const int64_t span = cap > 0 ? cap : 0;
    const int64_t n_sub = span > T ? (span + T - 1) / T : 1;
    const uint32_t guess_par = kDual ? static_cast<uint32_t>(first_sym & 1) : 0u;
    int64_t done = 0;                   // symbols of the stream before this window
    int64_t p0 = start;                 // the window's first code boundary
    uint32_t par0 = guess_par;          // and its parity

    for (int64_t w0 = 0; w0 < n_sub; w0 += kWindowSubs) {
      const int nw = static_cast<int>(n_sub - w0 < kWindowSubs ? n_sub - w0 : kWindowSubs);
      const bool final_window = w0 + nw == n_sub;
      const int bounded = final_window ? nw - 1 : nw;  // subsequences with an end
      const int64_t base = start + w0 * T;
      auto end_of = [&](int i) {
        return i < bounded ? base + static_cast<int64_t>(i + 1) * T : kNoEnd;
      };
      auto state = [&](int64_t pos, int par) {
        return static_cast<uint32_t>(pos - base) << 1 | static_cast<uint32_t>(par);
      };
      // ---- 1. guess, in two runs split at the meeting point
      uint32_t st[kSubs];
#pragma unroll
      for (int j = 0; j < kSubs; ++j) {
        const int i = threadIdx.x + j * kThreads;
        st[j] = i == 0 ? state(p0, par0) : state(base + static_cast<int64_t>(i) * T, guess_par);
        if (i < bounded) {
          int64_t pos = base + (st[j] >> 1);
          int par = st[j] & 1;
          const int64_t reach = base + static_cast<int64_t>(i) * T + kMeetBits;
          const int64_t meet = reach < end_of(i) ? reach : end_of(i);
          const int64_t head = decode_span(tbl, dual_lut, words, n_words, &pos, &par, meet);
          meet_s[i] = state(pos, par);
          const int64_t tail = decode_span(tbl, dual_lut, words, n_words, &pos, &par, end_of(i));
          tail_s[i] = static_cast<uint16_t>(tail);
          cnt_s[i] = static_cast<uint16_t>(head + tail);
          exit_s[i] = state(pos, par);
        }
      }
      __syncthreads();
      // ---- 2. synchronise
      for (;;) {
        uint32_t want[kSubs];
#pragma unroll
        for (int j = 0; j < kSubs; ++j) {
          const int i = threadIdx.x + j * kThreads;
          want[j] = (i > 0 && i < nw) ? exit_s[i - 1] : st[j];
        }
        __syncthreads();
        int changed = 0;
#pragma unroll
        for (int j = 0; j < kSubs; ++j) {
          const int i = threadIdx.x + j * kThreads;
          if (i < nw && want[j] != st[j]) {
            st[j] = want[j];
            changed = 1;
            if (i < bounded) {
              // decode up to the guess's meeting point: where the chains
              // meet, the guess's exit and its codes from there on stand
              int64_t pos = base + (st[j] >> 1);
              int par = st[j] & 1;
              const uint32_t meet = meet_s[i];
              int64_t n = decode_span(tbl, dual_lut, words, n_words, &pos, &par,
                                      base + (meet >> 1));
              if (state(pos, par) == meet) {
                n += tail_s[i];
              } else {
                n += decode_span(tbl, dual_lut, words, n_words, &pos, &par, end_of(i));
                exit_s[i] = state(pos, par);
                meet_s[i] = 0u;  // never met: later rounds decode the whole subsequence
              }
              cnt_s[i] = static_cast<uint16_t>(n);
            }
          }
        }
        if (!__syncthreads_or(changed)) break;
      }
      // ---- 3. first index of each subsequence: exclusive scan of the counts
      // (thread t sums subsequences [t*kSubs, (t+1)*kSubs))
      const uint32_t next = final_window ? 0u : exit_s[nw - 1];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < kSubs; ++j) {
        const int i = threadIdx.x * kSubs + j;
        sum += i < bounded ? cnt_s[i] : 0;
      }
      int total;
      int pre = block_exclusive_scan<kThreads>(sum, warp_tot, &total);
#pragma unroll
      for (int j = 0; j < kSubs; ++j) {
        const int i = threadIdx.x * kSubs + j;
        if (i < bounded) {
          exit_s[i] = static_cast<uint32_t>(pre);
          pre += cnt_s[i];
        }
      }
      __syncthreads();
      // ---- write
#pragma unroll
      for (int j = 0; j < kSubs; ++j) {
        const int i = threadIdx.x + j * kThreads;
        if (i < nw) {
          const int64_t f = done + (i < bounded ? exit_s[i] : total);
          const int64_t c = i < bounded && cnt_s[i] < count - f ? cnt_s[i] : count - f;
          if (c > 0)
            write_run(tbl, dual_lut, words, n_words, base + (st[j] >> 1),
                      static_cast<int>(st[j] & 1), c, out, first_sym + f, err);
        }
      }
      done += total;
      p0 = base + (next >> 1);
      par0 = next & 1;
      __syncthreads();
    }
  }
}

// The byte form: 2,048-subsequence windows, 4 blocks an SM.
constexpr int kSyncThreads = 256;
constexpr int kSyncSubs = 8;
// The dual form: 256-subsequence windows, 8 blocks an SM (the strategies
// without a table: kDualStrategyBlocks).
constexpr int kDualThreads = 128;
constexpr int kDualSubs = 2;
constexpr int kDualStrategyBlocks = 7;

int blocks_for(int64_t items, int threads) {
  const int64_t want = (items + threads - 1) / threads;
  return static_cast<int>(want < 132 * 32 ? want : 132 * 32);
}

bool bad_geometry(long long n_streams, long long S, long long n_symbols) {
  return n_streams <= 0 || S <= 0 || n_symbols <= 0 || n_streams * S < n_symbols;
}

// A subsequence's bits: a multiple of 32 whose count of codes fits a u16.
bool bad_subsequence(int T) { return T < 32 || T % 32 != 0 || T > 65504; }

bool bad_range(int lo, int hi, bool empty_ok) {
  return !((empty_ok && lo == 0 && hi == 0) || (1 <= lo && lo <= hi && hi <= kCodeTable - 2));
}

template <int kStrategy>
int launch_bytes(const void* words, long long n_words, const void* starts, long long n_streams,
                 long long n_symbols, long long S, const Codebooks& cbs, int T, void* out,
                 int* err, void* stream) {
  const unsigned grid = static_cast<unsigned>(n_streams < (1 << 20) ? n_streams : (1 << 20));
  decode_streams_sync_kernel<false, kSyncThreads, kSyncSubs, 4, kStrategy>
      <<<grid, kSyncThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(words), n_words, static_cast<const int64_t*>(starts),
          n_streams, n_symbols, S, cbs, T, out, err);
  return static_cast<int>(cudaGetLastError());
}

// smem: the dual tables' bytes (0 for the strategies without a table).
template <int kStrategy>
int launch_dual(const void* words, long long n_words, const void* starts, long long n_streams,
                long long n_symbols, long long S, const Codebooks& cbs, int T, void* out,
                int* err, size_t smem, void* stream) {
  auto kernel = decode_streams_sync_kernel<true, kDualThreads, kDualSubs,
                                           kStrategy == glz::kTable ? 8 : kDualStrategyBlocks,
                                           kStrategy>;
  // as many blocks as fit on the card at once, each walking the streams
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDualThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(n_streams < resident ? n_streams : resident);
  kernel<<<grid, kDualThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<const int64_t*>(starts),
      n_streams, n_symbols, S, cbs, T, out, err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).

// sym 4-byte aligned; lj, lens 16-byte aligned; tables u32[256].
int glz_lookup_lj_lens(const void* sym, long long n, long long n_valid, const void* lj_tbl,
                       const void* len_tbl, void* lj, void* lens, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  lookup_lj_lens_kernel<<<blocks_for((n + 3) / 4, kLookupThreads), kLookupThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sym), n, n_valid, static_cast<const uint32_t*>(lj_tbl),
      static_cast<const uint32_t*>(len_tbl), static_cast<uint32_t*>(lj),
      static_cast<uint32_t*>(lens));
  return static_cast<int>(cudaGetLastError());
}

// lens 16-byte aligned; tile_bits: ceil(n / 4096) int64.
int glz_pack_scan(const void* lens, long long n, void* tile_bits, void* stream) {
  if (n <= 0 || reinterpret_cast<uintptr_t>(lens) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  pack_scan_kernel<<<static_cast<unsigned>((n + kPackTile - 1) / kPackTile), kPackThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<const uint32_t*>(lens), n,
                                                          static_cast<int64_t*>(tile_bits));
  return static_cast<int>(cudaGetLastError());
}

// lj, lens 16-byte aligned, n a multiple of S; tile_end: the inclusive
// cumsum of glz_pack_scan's tile bits; words: n_words u32, zeroed by the
// caller; starts: n / S + 1 int64 (each stream's first bit, then the total).
int glz_pack_tiles(const void* lj, const void* lens, long long n, const void* tile_end,
                   int phase0, long long S, void* words, long long n_words, void* starts,
                   void* stream) {
  if (n <= 0 || S <= 0 || n % S != 0 || phase0 < 0 || phase0 > 31 || n_words < 0 ||
      reinterpret_cast<uintptr_t>(lj) % 16 != 0 || reinterpret_cast<uintptr_t>(lens) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  pack_tiles_kernel<<<static_cast<unsigned>((n + kPackTile - 1) / kPackTile), kPackThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lj), static_cast<const uint32_t*>(lens), n,
      static_cast<const int64_t*>(tile_end), phase0, S, static_cast<uint32_t*>(words), n_words,
      static_cast<int64_t*>(starts));
  return static_cast<int>(cudaGetLastError());
}

// fc, offsets: u32[34]; symtab: u32[256]; 1 <= min_len <= max_len <= 32;
// table_bits in [1, 12]; T bits per subsequence, a multiple of 32 in [32,
// 65504].
int glz_decode_streams(const void* words, long long n_words, const void* starts,
                       long long n_streams, long long n_symbols, long long S, int table_bits,
                       const void* fc, const void* offsets, const void* symtab, int min_len,
                       int max_len, int T, void* out, void* stream) {
  if (bad_geometry(n_streams, S, n_symbols) || bad_range(min_len, max_len, false) ||
      !(1 <= table_bits && table_bits <= glz::kMaxTableBits) || bad_subsequence(T))
    return static_cast<int>(cudaErrorInvalidValue);
  const Codebooks cbs{static_cast<const uint32_t*>(fc), static_cast<const uint32_t*>(offsets),
                      static_cast<const uint32_t*>(symtab), {min_len, 0}, {max_len, 0},
                      table_bits, {0u, 0u}};
  return launch_bytes<glz::kTable>(words, n_words, starts, n_streams, n_symbols, S, cbs, T, out,
                                   nullptr, stream);
}

// The byte decode without a table: strategy 1 (the bit-walk) or 2 (the fast
// scan), n_codes the codebook's symbols (at most 256), the rest as for
// glz_decode_streams.  err: one int32, zeroed by the caller; set to 1 where
// a code of the output matches no codeword.
int glz_decode_streams_strategy(int strategy, const void* words, long long n_words,
                                const void* starts, long long n_streams, long long n_symbols,
                                long long S, const void* fc, const void* offsets,
                                const void* symtab, int min_len, int max_len, int n_codes,
                                int T, void* err, void* out, void* stream) {
  if (bad_geometry(n_streams, S, n_symbols) || bad_range(min_len, max_len, false) ||
      n_codes < 0 || n_codes > 256 || bad_subsequence(T) || err == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Codebooks cbs{static_cast<const uint32_t*>(fc), static_cast<const uint32_t*>(offsets),
                      static_cast<const uint32_t*>(symtab), {min_len, 0}, {max_len, 0}, 0,
                      {static_cast<uint32_t>(n_codes), 0u}};
  int* e = static_cast<int*>(err);
  if (strategy == glz::kBitwalk)
    return launch_bytes<glz::kBitwalk>(words, n_words, starts, n_streams, n_symbols, S, cbs, T,
                                       out, e, stream);
  if (strategy == glz::kFast)
    return launch_bytes<glz::kFast>(words, n_words, starts, n_streams, n_symbols, S, cbs, T,
                                    out, e, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// fc, offsets: [2][34] u32, set 0 for even tokens.  A codebook's length range
// is [0, 0] (an empty dictionary) or within [1, 32].  table_bits in [1, 14]
// (the word table's; dual_bits); T as for glz_decode_streams.  out: n_symbols
// u32, 16-byte aligned.
int glz_decode_streams_dual(const void* words, long long n_words, const void* starts,
                            long long n_streams, long long n_symbols, long long S,
                            int table_bits, const void* fc, const void* offsets, int min0,
                            int max0, int min1, int max1, int T, void* out, void* stream) {
  if (bad_geometry(n_streams, S, n_symbols) || bad_range(min0, max0, true) ||
      bad_range(min1, max1, true) ||
      !(1 <= table_bits && table_bits <= glz::kMaxDualTableBits) || bad_subsequence(T) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Codebooks cbs{static_cast<const uint32_t*>(fc), static_cast<const uint32_t*>(offsets),
                      nullptr, {min0, min1}, {max0, max1}, table_bits, {0u, 0u}};
  const size_t smem = (size_t{1} << glz::dual_bits(table_bits, max0)) +
                      (size_t{1} << glz::dual_bits(table_bits, max1));
  return launch_dual<glz::kTable>(words, n_words, starts, n_streams, n_symbols, S, cbs, T, out,
                                  nullptr, smem, stream);
}

// The dual decode without a table: strategy 1 (the bit-walk) or 2 (the fast
// scan); n0, n1 each codebook's codes (0 for an empty dictionary), below
// 2^32; err as for glz_decode_streams_strategy; the rest as for
// glz_decode_streams_dual.
int glz_decode_streams_dual_strategy(int strategy, const void* words, long long n_words,
                                     const void* starts, long long n_streams,
                                     long long n_symbols, long long S, const void* fc,
                                     const void* offsets, int min0, int max0, int min1,
                                     int max1, long long n0, long long n1, int T, void* err,
                                     void* out, void* stream) {
  if (bad_geometry(n_streams, S, n_symbols) || bad_range(min0, max0, true) ||
      bad_range(min1, max1, true) || n0 < 0 || n1 < 0 || n0 > 0xFFFFFFFFll ||
      n1 > 0xFFFFFFFFll || bad_subsequence(T) || err == nullptr ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Codebooks cbs{static_cast<const uint32_t*>(fc), static_cast<const uint32_t*>(offsets),
                      nullptr, {min0, min1}, {max0, max1}, 0,
                      {static_cast<uint32_t>(n0), static_cast<uint32_t>(n1)}};
  int* e = static_cast<int*>(err);
  if (strategy == glz::kBitwalk)
    return launch_dual<glz::kBitwalk>(words, n_words, starts, n_streams, n_symbols, S, cbs, T,
                                      out, e, 0, stream);
  if (strategy == glz::kFast)
    return launch_dual<glz::kFast>(words, n_words, starts, n_streams, n_symbols, S, cbs, T, out,
                                   e, 0, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
