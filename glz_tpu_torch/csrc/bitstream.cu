// Bitstream (layout-0) codec kernels for Hopper (sm_90a).
//
//   K7 lookup_lj_lens_kernel   <- glz_tpu/ops/pallas_lut.py:_lut256_kernel, as
//                                 glz_tpu/ops/encode.py:lookup_lj_lens calls it
//      pack_lj_kernel          <- the XLA scatter of glz_tpu/ops/encode.py:pack_lj
//      decode_streams_kernel   <- the XLA loop of glz_tpu/ops/decode.py:decode_block
//                                 (byte mode) and the host dual-dictionary decode
//                                 of glz_tpu/models/huffword.py (HuffWord)
//
// A layout-0 payload is one MSB-first bit stream in u32 words (word w holds
// stream bits [32w, 32w + 32)); stream k holds symbols [k*S, (k+1)*S) and
// starts at a recorded bit offset.  All symbol, bit and word offsets are
// 64-bit.  Shifts by 32 are undefined in CUDA: every shift whose amount can
// reach 32 is selected around or done in 64 bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCodeTable = 34;  // fc_lj / offsets entries (MAX_CODE_LEN + 2)

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

// ---------------------------------------------------------------------------
// The stream decode: one thread per stream, its symbols in order.  A 64-bit
// bit buffer holds the next 32..64 stream bits left-justified; the 32-bit
// window v is its top half.  After a code of len bits the buffer shifts by
// len (<= 32, a 64-bit shift) and, below 32 bits, takes the next word, which
// was loaded one refill ahead so its latency overlaps ~32/len symbols of
// work.  Words past the payload read 0.  The code length and rank come from
// the canonical scan over fc_lj / offsets in shared memory (every thread of
// a warp reads the same entry: broadcast):
//   len = min_len + sum_{l in [min_len, max_len)} [v < fc_lj[l]], off by the
//   same scan, rank = (v >> (32 - len)) + off (no shift when len = 32).
// Byte mode (kDual false) writes symtab[rank & 255], packing a stream's
// symbols into 4-byte stores on 4-byte boundaries (bytes at a stream's two
// ends, which share a word with the next stream, are stored singly).
// kDual writes the u32 rank and scans codebook (k*S + j) & 1 for token j of
// stream k; set 0 is the even tokens' codebook, and an empty dictionary's
// (0, 0) codebook is scanned by no valid token.
// The format gives one serial chain per stream (2,048 chains of 2^18 steps
// on the byte main path), so the kernel is latency-bound: each step waits on
// the previous step's length.  Blocks are one warp, to spread the chains
// over all SMs.
// ---------------------------------------------------------------------------
constexpr int kStreamThreads = 32;

template <bool kDual>
__global__ void __launch_bounds__(kStreamThreads) decode_streams_kernel(
    const uint32_t* __restrict__ words, int64_t n_words,
    const int64_t* __restrict__ starts, int64_t n_streams, int64_t n_symbols, int64_t S,
    const uint32_t* __restrict__ fc_g, const uint32_t* __restrict__ off_g,
    const uint32_t* __restrict__ symtab_g, int min0, int max0, int min1, int max1,
    void* __restrict__ out) {
  constexpr int kSets = kDual ? 2 : 1;
  __shared__ uint32_t fc[kSets][kCodeTable];
  __shared__ uint32_t offs[kSets][kCodeTable];
  __shared__ uint32_t symtab[kDual ? 1 : 256];
  for (int i = threadIdx.x; i < kSets * kCodeTable; i += blockDim.x) {
    fc[i / kCodeTable][i % kCodeTable] = fc_g[i];
    offs[i / kCodeTable][i % kCodeTable] = off_g[i];
  }
  if (!kDual)
    for (int i = threadIdx.x; i < 256; i += blockDim.x) symtab[i] = symtab_g[i];
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
  uint8_t* out8 = static_cast<uint8_t*>(out);
  uint32_t* out32 = static_cast<uint32_t*>(out);
  uint32_t acc = 0u;  // byte mode: the 4-byte word being filled
  for (int64_t j = 0; j < count; ++j) {
    if (nbits < 32) {
      buf |= static_cast<uint64_t>(next) << (32 - nbits);
      nbits += 32;
      next = load(++wpos);
    }
    const uint32_t v = static_cast<uint32_t>(buf >> 32);
    const int set = kDual ? p : 0;
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
    if (kDual) {
      out32[first + j] = rank;
      p ^= 1;
    } else {
      const int64_t g = first + j;
      acc |= symtab[rank & 255u] << (8 * (g & 3));
      if ((g & 3) == 3 || j == count - 1) {
        const int64_t base = g & ~static_cast<int64_t>(3);
        if ((g & 3) == 3 && base >= first) {
          *reinterpret_cast<uint32_t*>(out8 + base) = acc;
        } else {
          for (int64_t b = base > first ? base : first; b <= g; ++b)
            out8[b] = static_cast<uint8_t>(acc >> (8 * (b & 3)));
        }
        acc = 0u;
      }
    }
  }
}

int blocks_for(int64_t items, int threads) {
  const int64_t want = (items + threads - 1) / threads;
  return static_cast<int>(want < 132 * 32 ? want : 132 * 32);
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

static int decode_streams(const void* words, long long n_words, const void* starts,
                          long long n_streams, long long n_symbols, long long S,
                          const void* fc, const void* offsets, const void* symtab,
                          int min0, int max0, int min1, int max1, void* out,
                          void* stream, bool dual) {
  if (n_streams <= 0 || S <= 0 || n_symbols <= 0 || n_streams * S < n_symbols)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want = (n_streams + kStreamThreads - 1) / kStreamThreads;
  if (want > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(want));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GLZ_DECODE_STREAMS(DUAL)                                                       \
  decode_streams_kernel<DUAL><<<grid, kStreamThreads, 0, st>>>(                        \
      static_cast<const uint32_t*>(words), n_words, static_cast<const int64_t*>(starts), \
      n_streams, n_symbols, S, static_cast<const uint32_t*>(fc),                         \
      static_cast<const uint32_t*>(offsets), static_cast<const uint32_t*>(symtab), min0, \
      max0, min1, max1, out)
  if (dual) {
    GLZ_DECODE_STREAMS(true);
  } else {
    GLZ_DECODE_STREAMS(false);
  }
#undef GLZ_DECODE_STREAMS
  return static_cast<int>(cudaGetLastError());
}

// fc, offsets: u32[34]; symtab: u32[256]; 1 <= min_len <= max_len <= 32.
int glz_decode_streams(const void* words, long long n_words, const void* starts,
                       long long n_streams, long long n_symbols, long long S,
                       const void* fc, const void* offsets, const void* symtab, int min_len,
                       int max_len, void* out, void* stream) {
  if (!(1 <= min_len && min_len <= max_len && max_len <= kCodeTable - 2))
    return static_cast<int>(cudaErrorInvalidValue);
  return decode_streams(words, n_words, starts, n_streams, n_symbols, S, fc, offsets, symtab,
                        min_len, max_len, 0, 0, out, stream, false);
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
  if (bad_range(min0, max0) || bad_range(min1, max1))
    return static_cast<int>(cudaErrorInvalidValue);
  return decode_streams(words, n_words, starts, n_streams, n_symbols, S, fc, offsets,
                        nullptr, min0, max0, min1, max1, out, stream, true);
}

}  // extern "C"
