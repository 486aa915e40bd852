// The byte histogram for Hopper (sm_90a).
//
//   histogram_kernel  <- glz_tpu/ops/histogram.py:histogram_scatter and
//                        histogram_matmul (XLA code there: a scatter-add, or
//                        one-hot matmuls on the MXU over 2^19-byte chunks)
//
// u8 [n] -> int64 [256], exact, any n (no padding, no chunk multiple).  The
// function reads each byte once and does one increment per byte, so it is
// bound by bytes: n / 3.35 TB/s (0.160 ms at 512 MiB).
//
// Design.  The codec's byte laws are skewed (the main corpus, the AND of
// three uniform draws, is 34% zero bytes), so shared-memory atomics on one
// bin would serialise a warp.  Each thread instead owns one u8 counter per
// bin in shared memory (256 bins x 256 threads = 64 KiB a block), so no
// two threads ever write the same byte and no atomic is needed; the
// counters are laid out so that the 32 lanes of a warp touch 32 different
// banks whatever their bins (slot()).  A thread counts at most 240 bytes
// (15 16-byte vectors) before the block folds the counters: thread b sums
// bin b's 256 counters (16-byte loads, two bytes summed per 16-bit half),
// adds them to its 64-bit total and clears the row.  The 15 vector loads of
// a chunk are issued before any is counted, so each thread keeps 240 bytes
// in flight; warps read 512 contiguous bytes a load.  Blocks walk the
// 61,440-byte chunks grid-stride, as many blocks as the card holds at once,
// and each adds its 256 totals to the output with one 64-bit atomic a bin.
// An unaligned start is read from the 16-byte boundary below it, and bytes
// outside [start, start + n) are not counted.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 256;                  // one thread per bin in the fold
constexpr int kHistVecs = 15;                      // 16-byte loads a thread per chunk
constexpr int kHistChunkVecs = kHistThreads * kHistVecs;       // 3,840 (61,440 bytes)
constexpr int kHistSmem = 256 * kHistThreads;      // u8 counters, 64 KiB
constexpr int kMaxDevices = 64;

// Thread t's counter of bin b is byte b*256 + slot(t).  Its 32-bit word is
// (b*256 + slot)/4, whose bank ((slot/4) mod 32) is the thread's lane: a
// warp's 32 increments hit 32 banks for any bins.
__device__ __forceinline__ int slot(int t) {
  const int lane = t & 31, warp = t >> 5;
  return (lane << 2) | (warp & 3) | ((warp >> 2) << 7);
}

// Add the 16 bytes of v that lie in [lo, hi) (v holds bytes [base, base+16)).
template <bool kChecked>
__device__ __forceinline__ void count16(uint8_t* row, uint4 v, int64_t base, int64_t lo,
                                        int64_t hi) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (kChecked && (base + k < lo || base + k >= hi)) continue;
    const uint32_t b = (w[k >> 2] >> (8 * (k & 3))) & 0xFF;
    row[b << 8] += 1;
  }
}

__global__ void __launch_bounds__(kHistThreads, 3) histogram_kernel(
    const uint4* __restrict__ vecs, int64_t lo, int64_t hi,
    unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t counts[];
  const int t = threadIdx.x;
  uint8_t* row = counts + slot(t);          // this thread's counter of bin 0
  uint4* mine = reinterpret_cast<uint4*>(counts + t * kHistThreads);  // bin t's row
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < 16; ++j) mine[j] = zero;
  __syncthreads();

  const int64_t n_vecs = (hi + 15) >> 4;
  const int64_t n_chunks = (n_vecs + kHistChunkVecs - 1) / kHistChunkVecs;
  unsigned long long total = 0;             // bin t
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int64_t v0 = c * kHistChunkVecs + t;
    uint4 v[kHistVecs];
#pragma unroll
    for (int k = 0; k < kHistVecs; ++k) {
      const int64_t i = v0 + k * kHistThreads;
      v[k] = i < n_vecs ? vecs[i] : zero;
    }
#pragma unroll
    for (int k = 0; k < kHistVecs; ++k) {
      const int64_t base = (v0 + k * kHistThreads) << 4;
      if (base >= lo && base + 16 <= hi)
        count16<false>(row, v[k], base, lo, hi);
      else if (base + 16 > lo && base < hi)
        count16<true>(row, v[k], base, lo, hi);
    }
    __syncthreads();
    // fold: bin t's 256 counters, each <= 240, summed in 16-bit halves
    // (at most 128 x 240 a half); lanes start at different vectors so a
    // quarter-warp's 16-byte loads hit different banks
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int jj = (j + t) & 15;
      const uint4 q = mine[jj];
      mine[jj] = zero;
      acc += (q.x & 0x00FF00FFu) + ((q.x >> 8) & 0x00FF00FFu);
      acc += (q.y & 0x00FF00FFu) + ((q.y >> 8) & 0x00FF00FFu);
      acc += (q.z & 0x00FF00FFu) + ((q.z >> 8) & 0x00FF00FFu);
      acc += (q.w & 0x00FF00FFu) + ((q.w >> 8) & 0x00FF00FFu);
    }
    total += (acc & 0xFFFFu) + (acc >> 16);
    __syncthreads();
  }
  if (total) atomicAdd(out + t, total);
}

}  // namespace

extern "C" {

// out: int64 [256], zeroed by the caller; counts are added to it.  data may
// start anywhere: it is read from the 16-byte boundary below it.
int glz_histogram(const void* data, long long n, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t p = reinterpret_cast<uintptr_t>(data);
  const int64_t lo = static_cast<int64_t>(p & 15);
  const int64_t hi = lo + n;
  cudaError_t e = cudaFuncSetAttribute(histogram_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kHistSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // as many blocks as the card holds at once (queried once per card)
  static std::atomic<int> cache[kMaxDevices];
  int device = 0;
  e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int resident = device < kMaxDevices ? cache[device].load(std::memory_order_relaxed) : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, histogram_kernel,
                                                        kHistThreads, kHistSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = sms * per_sm;
    if (device < kMaxDevices) cache[device].store(resident, std::memory_order_relaxed);
  }
  const int64_t n_chunks = ((hi + 15) / 16 + kHistChunkVecs - 1) / kHistChunkVecs;
  const int blocks = static_cast<int>(n_chunks < resident ? n_chunks : resident);
  histogram_kernel<<<blocks, kHistThreads, kHistSmem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(p - lo), lo, hi, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
