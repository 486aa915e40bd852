// Bitstream (layout-0) codec kernels for Hopper (sm_90a).
//
//   K7 lookup_lj_lens_kernel     <- glz_tpu/ops/pallas_lut.py:_lut256_kernel, as
//                                   glz_tpu/ops/encode.py:lookup_lj_lens calls it
//      pack_lj_kernel            <- the XLA scatter of glz_tpu/ops/encode.py:pack_lj
//      decode_streams_sync_kernel <- the XLA loop of glz_tpu/ops/decode.py:decode_block
//                                   (byte mode)
//      decode_streams_dual_kernel <- the host dual-dictionary decode of
//                                   glz_tpu/models/huffword.py (HuffWord)
//
// A layout-0 payload is one MSB-first bit stream in u32 words (word w holds
// stream bits [32w, 32w + 32)); stream k holds symbols [k*S, (k+1)*S) and
// starts at a recorded bit offset.  All symbol, bit and word offsets are
// 64-bit.  Shifts by 32 are undefined in CUDA: every shift whose amount can
// reach 32 is selected around or done in 64 bits.

#include <cstdint>
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

// ---------------------------------------------------------------------------
// The bit pack: one thread per code.  With o = offsets[i] and ph = o & 31,
//   words[o >> 5]     |= lj[i] >> ph
//   words[o >> 5 + 1] |= lj[i] << (32 - ph)        only when ph > 0
// by atomicOr into a zeroed buffer (zero values and words past n_words are
// skipped).  The XLA version is a cumsum plus a scatter-add; the cumsum stays
// in PyTorch (int64), this is the scatter.  Bound by bytes (4 + 8 bytes in
// per code, the words out once); neighbouring codes share words, so the
// atomics to one word serialise in L2.
// ---------------------------------------------------------------------------
constexpr int kPackThreads = 256;

__global__ void __launch_bounds__(kPackThreads) pack_lj_kernel(
    const uint32_t* __restrict__ lj, const int64_t* __restrict__ offsets, int64_t n,
    uint32_t* __restrict__ words, int64_t n_words) {
  for (int64_t i = global_thread(); i < n; i += grid_stride()) {
    const uint32_t c = lj[i];
    if (c == 0u) continue;
    const int64_t o = offsets[i];
    const uint32_t ph = static_cast<uint32_t>(o) & 31u;
    const int64_t w = o >> 5;
    const uint32_t lo = c >> ph;
    const uint32_t hi = ph ? (c << (32u - ph)) : 0u;
    if (lo && w < n_words) atomicOr(words + w, lo);
    if (hi && w + 1 < n_words) atomicOr(words + w + 1, hi);
  }
}

// A reader of the payload's bits from any bit position.  A 64-bit buffer
// holds the next 32..64 bits left-justified, and its top half is the 32-bit
// window; below 32 bits it takes the next word, loaded one refill ahead so
// its latency overlaps ~32/len codes.  Words past the payload read 0.  (A
// reader that double-buffers 16-byte chunks, to give each load ~29 codes,
// spilled registers at 256 threads x 4 blocks and ran slower, PERF.md.)
struct BitReader {
  const uint32_t* words;
  int64_t n_words, wpos;
  uint64_t buf;
  int nbits;
  uint32_t next;

  __device__ __forceinline__ uint32_t load(int64_t i) const {
    return (i >= 0 && i < n_words) ? __ldg(words + i) : 0u;
  }
  __device__ __forceinline__ BitReader(const uint32_t* w, int64_t n, int64_t pos)
      : words(w), n_words(n), wpos(pos >> 5) {
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
// The byte stream decode: several self-synchronising decoders per stream
// (Weissenberger and Schmidt, "Massively Parallel Huffman Decoding on GPUs",
// ICPP 2018).  One block per stream k, whose bits are [starts[k],
// starts[k+1]) (the last stream's run to the payload's end; a span is
// clamped to [0, 32 * count] bits).  The span is cut into subsequences of T
// bits (T a multiple of 32) measured from starts[k], and subsequence i
// decodes the codes that start in [starts[k] + iT, starts[k] + (i+1)T):
//   1. guess: subsequence 0 starts at starts[k], every other at its first
//      bit; each records its exit (the first code boundary at or past its
//      end), its code count and its meeting point (below) in shared
//      memory;
//   2. synchronise: while some subsequence i's start differs from
//      subsequence i-1's exit, each such i decodes again from that exit.
//      A start that equals a true code boundary stays one, so this ends
//      within as many rounds as there are subsequences, exactly; on varied
//      code lengths decoders meet the true boundaries within a few codes
//      and it takes one round (measured: 1.00 a stream at the main shape).
//      The guess records its first boundary kMeetBits into the
//      subsequence (its meeting point) and its codes from there on, so a
//      round decodes only up to the meeting point: if the new chain lands
//      on it, the guess's exit and count from there on stand; if not (the
//      chains have not met), it decodes the rest.  Cutting at multiples of
//      32 bits from the stream's start also synchronises uniform 8-bit
//      codes (all 256 byte values equally likely) at once;
//   3. write: an exclusive block scan of the counts gives each
//      subsequence's first symbol index, and each decodes once more from
//      its synchronised start, writing the symbols whose index is below the
//      stream's count min(S, n_symbols - k*S).
// The stream's last subsequence has no end: it decodes until the stream
// has its count, past the recorded end if need be, as the serial walk does
// (so a dispatch's word-alignment pad and any other span give the plain
// version's output).  A stream longer than kWindowSubs subsequences is done
// in windows of kWindowSubs, each starting at the previous one's exact exit.
// Codes come from the shared decode table (decode_table.cuh).  The write
// knows each subsequence's count and gathers its symbols into 16-byte
// stores (write_run): each thread writes its own run of ~T/4.4 bytes, far
// from its warp's other threads, where 4-byte stores would cost a 32-byte
// sector transaction for every four bytes.  Bound by bytes (the payload
// read once, the output written once); the subsequences spread each
// stream's serial chain over a block and the streams over all SMs.
// ---------------------------------------------------------------------------
constexpr int kSyncThreads = 256;
constexpr int kSubsPerThread = 8;
constexpr int kWindowSubs = kSyncThreads * kSubsPerThread;
constexpr int kMeetBits = 128;  // a guess's meeting point: its first boundary this far in

// Exclusive prefix of x over the block (thread order); the block total in
// *total.  The caller synchronises before warp_tot is used again.
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
  int wt = lane < kSyncThreads / 32 ? warp_tot[lane] : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, wt, o);
    if (lane >= o) wt += y;
  }
  const int before = __shfl_sync(0xffffffffu, wt, (warp + 31) & 31);
  *total = __shfl_sync(0xffffffffu, wt, 31);
  return (warp ? before : 0) + inc - x;
}

// Decodes the codes from bit *pos while *pos < end; returns their count
// and leaves *pos at the next code boundary.
__device__ __forceinline__ int64_t decode_span(const glz::DecodeTable& t,
                                               const uint32_t* __restrict__ words,
                                               int64_t n_words, int64_t* pos, int64_t end) {
  BitReader r(words, n_words, *pos);
  int64_t p = *pos, n = 0;
  while (p < end) {
    uint32_t sym;
    const uint32_t ln = glz::decode_one(t, r.window(), &sym);
    r.skip(ln);
    p += ln;
    ++n;
  }
  *pos = p;
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
// piece boundaries fall on the same steps for all of them.
__device__ __forceinline__ void write_run(const glz::DecodeTable& t,
                                          const uint32_t* __restrict__ words, int64_t n_words,
                                          int64_t pos, int64_t c, uint8_t* __restrict__ out,
                                          int64_t g0) {
  BitReader r(words, n_words, pos);
  const int64_t g_end = g0 + c;
  uint32_t acc = 0u, q0 = 0u, q1 = 0u, q2 = 0u;  // the word being filled; the piece's words
  int64_t g = g0 & ~int64_t{15};
  for (; g < g_end; ++g) {
    uint32_t sym = 0u;
    if (g >= g0) r.skip(glz::decode_one(t, r.window(), &sym));
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

__global__ void __launch_bounds__(kSyncThreads, 4) decode_streams_sync_kernel(
    const uint32_t* __restrict__ words, int64_t n_words,
    const int64_t* __restrict__ starts, int64_t n_streams, int64_t n_symbols, int64_t S,
    int table_bits, const uint32_t* __restrict__ fc_g, const uint32_t* __restrict__ off_g,
    const uint32_t* __restrict__ symtab_g, int min_len, int max_len, int T,
    uint8_t* __restrict__ out) {
  __shared__ glz::DecodeTable tbl;
  __shared__ uint32_t exit_s[kWindowSubs];  // window-relative exit; then first index
  __shared__ uint32_t meet_s[kWindowSubs];  // the guess's meeting point, window-relative
  __shared__ uint16_t cnt_s[kWindowSubs];
  __shared__ uint16_t tail_s[kWindowSubs];  // the guess's codes from its meeting point on
  __shared__ int warp_tot[kSyncThreads / 32];
  glz::build_decode_table(tbl, table_bits, fc_g, off_g, symtab_g, min_len, max_len);
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
    int64_t done = 0;   // symbols of the stream before this window
    int64_t p0 = start; // the window's first code boundary

    for (int64_t w0 = 0; w0 < n_sub; w0 += kWindowSubs) {
      const int nw = static_cast<int>(n_sub - w0 < kWindowSubs ? n_sub - w0 : kWindowSubs);
      const bool final_window = w0 + nw == n_sub;
      const int bounded = final_window ? nw - 1 : nw;  // subsequences with an end
      const int64_t base = start + w0 * T;
      auto end_of = [&](int i) {
        return i < bounded ? base + static_cast<int64_t>(i + 1) * T : kNoEnd;
      };
      // ---- 1. guess, in two runs split at the meeting point
      uint32_t st[kSubsPerThread];
#pragma unroll
      for (int j = 0; j < kSubsPerThread; ++j) {
        const int i = threadIdx.x + j * kSyncThreads;
        st[j] = i == 0 ? static_cast<uint32_t>(p0 - base) : static_cast<uint32_t>(i) * T;
        if (i < bounded) {
          int64_t pos = base + st[j];
          const int64_t reach = base + static_cast<int64_t>(i) * T + kMeetBits;
          const int64_t meet = reach < end_of(i) ? reach : end_of(i);
          const int64_t head = decode_span(tbl, words, n_words, &pos, meet);
          meet_s[i] = static_cast<uint32_t>(pos - base);
          const int64_t tail = decode_span(tbl, words, n_words, &pos, end_of(i));
          tail_s[i] = static_cast<uint16_t>(tail);
          cnt_s[i] = static_cast<uint16_t>(head + tail);
          exit_s[i] = static_cast<uint32_t>(pos - base);
        }
      }
      __syncthreads();
      // ---- 2. synchronise
      for (;;) {
        uint32_t want[kSubsPerThread];
#pragma unroll
        for (int j = 0; j < kSubsPerThread; ++j) {
          const int i = threadIdx.x + j * kSyncThreads;
          want[j] = (i > 0 && i < nw) ? exit_s[i - 1] : st[j];
        }
        __syncthreads();
        int changed = 0;
#pragma unroll
        for (int j = 0; j < kSubsPerThread; ++j) {
          const int i = threadIdx.x + j * kSyncThreads;
          if (i < nw && want[j] != st[j]) {
            st[j] = want[j];
            changed = 1;
            if (i < bounded) {
              // decode up to the guess's meeting point: where the chains
              // meet, the guess's exit and its codes from there on stand
              int64_t pos = base + st[j];
              const int64_t meet = base + meet_s[i];
              int64_t n = decode_span(tbl, words, n_words, &pos, meet);
              if (pos == meet) {
                n += tail_s[i];
              } else {
                n += decode_span(tbl, words, n_words, &pos, end_of(i));
                exit_s[i] = static_cast<uint32_t>(pos - base);
                meet_s[i] = 0u;  // never met: later rounds decode the whole subsequence
              }
              cnt_s[i] = static_cast<uint16_t>(n);
            }
          }
        }
        if (!__syncthreads_or(changed)) break;
      }
      // ---- 3. first index of each subsequence: exclusive scan of the counts
      // (thread t sums subsequences [t*kSubsPerThread, (t+1)*kSubsPerThread))
      const int64_t next_p0 = final_window ? 0 : base + exit_s[nw - 1];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < kSubsPerThread; ++j) {
        const int i = threadIdx.x * kSubsPerThread + j;
        sum += i < bounded ? cnt_s[i] : 0;
      }
      int total;
      int pre = block_exclusive_scan(sum, warp_tot, &total);
#pragma unroll
      for (int j = 0; j < kSubsPerThread; ++j) {
        const int i = threadIdx.x * kSubsPerThread + j;
        if (i < bounded) {
          exit_s[i] = static_cast<uint32_t>(pre);
          pre += cnt_s[i];
        }
      }
      __syncthreads();
      // ---- write
#pragma unroll
      for (int j = 0; j < kSubsPerThread; ++j) {
        const int i = threadIdx.x + j * kSyncThreads;
        if (i < nw) {
          const int64_t f = done + (i < bounded ? exit_s[i] : total);
          const int64_t c = i < bounded && cnt_s[i] < count - f ? cnt_s[i] : count - f;
          if (c > 0) write_run(tbl, words, n_words, base + st[j], c, out, first_sym + f);
        }
      }
      done += total;
      p0 = next_p0;
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// The HuffWord stream decode: one thread per stream, its tokens in order
// (the first port's decode_streams_kernel<true>, unchanged).  A 64-bit bit buffer
// holds the next 32..64 stream bits left-justified; the 32-bit window v is
// its top half.  After a code of len bits the buffer shifts by len (<= 32,
// a 64-bit shift) and, below 32 bits, takes the next word, which was loaded
// one refill ahead.  Words past the payload read 0.  The code length and rank come
// from the canonical scan over fc_lj / offsets in shared memory (every
// thread of a warp reads the same entry: broadcast):
//   len = min_len + sum_{l in [min_len, max_len)} [v < fc_lj[l]], off by the
//   same scan, rank = (v >> (32 - len)) + off (no shift when len = 32).
// It writes the u32 rank and scans codebook (k*S + j) & 1 for token j of
// stream k; set 0 is the even tokens' codebook, and an empty dictionary's
// (0, 0) codebook is scanned by no valid token.  The format gives one
// serial chain per stream (2,991 chains of 16,384 steps on the HuffWord
// main path), so the kernel is latency-bound: each step waits on the
// previous step's length.  Blocks are one warp, to spread the chains over
// all SMs.
// ---------------------------------------------------------------------------
constexpr int kStreamThreads = 32;

__global__ void __launch_bounds__(kStreamThreads) decode_streams_dual_kernel(
    const uint32_t* __restrict__ words, int64_t n_words,
    const int64_t* __restrict__ starts, int64_t n_streams, int64_t n_symbols, int64_t S,
    const uint32_t* __restrict__ fc_g, const uint32_t* __restrict__ off_g,
    int min0, int max0, int min1, int max1, uint32_t* __restrict__ out32) {
  __shared__ uint32_t fc[2][kCodeTable];
  __shared__ uint32_t offs[2][kCodeTable];
  for (int i = threadIdx.x; i < 2 * kCodeTable; i += blockDim.x) {
    fc[i / kCodeTable][i % kCodeTable] = fc_g[i];
    offs[i / kCodeTable][i % kCodeTable] = off_g[i];
  }
  __syncthreads();

  const int64_t k = global_thread();
  if (k >= n_streams) return;
  const int64_t first = k * S;
  const int64_t left = n_symbols - first;
  const int64_t count = left <= 0 ? 0 : (left < S ? left : S);
  if (count == 0) return;

  auto load = [&](int64_t i) -> uint32_t {
    return (i >= 0 && i < n_words) ? words[i] : 0u;
  };
  const int64_t start = starts[k];
  int64_t wpos = start >> 5;
  const uint32_t phase = static_cast<uint32_t>(start) & 31u;
  uint64_t buf = (static_cast<uint64_t>(load(wpos)) << 32) | load(wpos + 1);
  buf <<= phase;
  int nbits = 64 - static_cast<int>(phase);
  wpos += 2;
  uint32_t next = load(wpos);

  int p = static_cast<int>(first & 1);
  for (int64_t j = 0; j < count; ++j) {
    if (nbits < 32) {
      buf |= static_cast<uint64_t>(next) << (32 - nbits);
      nbits += 32;
      next = load(++wpos);
    }
    const uint32_t v = static_cast<uint32_t>(buf >> 32);
    const int set = p;
    const int lo = set ? min1 : min0;
    const int hi = set ? max1 : max0;
    const uint32_t* fcs = fc[set];
    const uint32_t* ofs = offs[set];
    uint32_t ln = static_cast<uint32_t>(lo);
    uint32_t off = ofs[lo];
    for (int l = lo; l < hi; ++l) {
      const bool c = v < fcs[l];
      ln += c ? 1u : 0u;
      off = c ? ofs[l + 1] : off;
    }
    const uint32_t rank = (v >> ((32u - ln) & 31u)) + off;
    buf <<= ln;
    nbits -= static_cast<int>(ln);
    out32[first + j] = rank;
    p ^= 1;
  }
}

int blocks_for(int64_t items, int threads) {
  const int64_t want = (items + threads - 1) / threads;
  return static_cast<int>(want < 132 * 32 ? want : 132 * 32);
}

bool bad_geometry(long long n_streams, long long S, long long n_symbols) {
  return n_streams <= 0 || S <= 0 || n_symbols <= 0 || n_streams * S < n_symbols;
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

// words: n_words u32, zeroed by the caller.
int glz_pack_lj(const void* lj, const void* offsets, long long n, void* words,
                long long n_words, void* stream) {
  if (n <= 0 || n_words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pack_lj_kernel<<<blocks_for(n, kPackThreads), kPackThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lj), static_cast<const int64_t*>(offsets), n,
      static_cast<uint32_t*>(words), n_words);
  return static_cast<int>(cudaGetLastError());
}

// fc, offsets: u32[34]; symtab: u32[256]; 1 <= min_len <= max_len <= 32;
// table_bits in [1, 12]; T bits per subsequence, a multiple of 32 in [32,
// 65504].
int glz_decode_streams(const void* words, long long n_words, const void* starts,
                       long long n_streams, long long n_symbols, long long S, int table_bits,
                       const void* fc, const void* offsets, const void* symtab, int min_len,
                       int max_len, int T, void* out, void* stream) {
  if (bad_geometry(n_streams, S, n_symbols) ||
      !(1 <= min_len && min_len <= max_len && max_len <= kCodeTable - 2) ||
      !(1 <= table_bits && table_bits <= glz::kMaxTableBits) ||
      T < 32 || T % 32 != 0 || T > 65504)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(n_streams < (1 << 20) ? n_streams : (1 << 20));
  decode_streams_sync_kernel<<<grid, kSyncThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<const int64_t*>(starts),
      n_streams, n_symbols, S, table_bits, static_cast<const uint32_t*>(fc),
      static_cast<const uint32_t*>(offsets),
      static_cast<const uint32_t*>(symtab), min_len, max_len, T, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// fc, offsets: [2][34] u32, set 0 for even tokens.  A codebook's length range
// is [0, 0] (an empty dictionary) or within [1, 32].
int glz_decode_streams_dual(const void* words, long long n_words, const void* starts,
                            long long n_streams, long long n_symbols, long long S,
                            const void* fc, const void* offsets, int min0, int max0,
                            int min1, int max1, void* out, void* stream) {
  auto bad_range = [](int lo, int hi) {
    return !((lo == 0 && hi == 0) || (1 <= lo && lo <= hi && hi <= kCodeTable - 2));
  };
  if (bad_geometry(n_streams, S, n_symbols) || bad_range(min0, max0) || bad_range(min1, max1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want = (n_streams + kStreamThreads - 1) / kStreamThreads;
  if (want > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  decode_streams_dual_kernel<<<static_cast<unsigned>(want), kStreamThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<const int64_t*>(starts),
      n_streams, n_symbols, S, static_cast<const uint32_t*>(fc),
      static_cast<const uint32_t*>(offsets), min0, max0, min1, max1,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
