// Lockstep (layout-2) codec kernels for Hopper (sm_90a).
//
// Each kernel replaces one TPU kernel of the JAX package and computes the
// same function:
//
//   K1 lane_totals_kernel          <- glz_tpu/ops/pallas_encode.py:make_totals_kernel
//   K1e lane_totals_entries_kernel <- glz_tpu/ops/pallas_encode.py:prepare_entry_words
//                                     (XLA code there; the HuffWord form of K1)
//   K2 encode_kernel<LPT>          <- glz_tpu/ops/pallas_encode.py:make_encode_kernel
//                                     (byte-LUT mode)
//   K4 encode_entries_kernel<C>    <- the same factory, u32-entry mode
//                                     (a cluster of C = rows/8 blocks per group)
//   K3 decode_kernel               <- glz_tpu/ops/pallas_decode.py:make_decode_kernel
//   K5 decode_dual_kernel          <- glz_tpu/ops/pallas_decode.py:make_decode_kernel_dual
//                                     (one block, or a cluster of blocks, per group)
//   K6 lut_gather_kernel           <- glz_tpu/ops/pallas_lut.py:_lut_big_kernel_factory
//                                     with its callers' index math (models/huffword.py)
//
// Symbols (bytes, or u32 lj|len entry words on the HuffWord path) are read
// in file order (lane-major: lane l of group g owns symbols
// [(g*G + l)*S, (g*G + l + 1)*S)); the TPU's step-major transpose is folded
// into the indexing.  All symbol and word offsets are 64-bit.
//
// Group coupling.  All G = rows*128 lanes of a group share one payload
// cursor, and every step's exclusive rank over the lanes that load (decode)
// or emit (encode) a word couples them.  In K2 and K3 one block of 1024
// threads runs one group (K4 spreads it over a cluster of rows/8 blocks,
// one lane a thread, and K5 may spread it over a cluster of blocks); each
// thread owns LPT = rows/8 *contiguous* lanes, so a lane's rank
// is the block's exclusive prefix over threads plus the thread-local prefix
// and flat lane order is kept.  The block prefix is a warp shuffle scan plus
// a scan of the 32 warp totals, double-buffered in shared memory so each
// step costs one __syncthreads.  Lane state lives in registers (4 u32 per
// lane); at rows=64 that is 32 registers a thread before temporaries, so
// the compiler may spill some of it (see ptxas -v).
//
// Shifts by 32 are undefined in CUDA: every site where the JAX kernels
// select around a 32-bit shift keeps that select.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "decode_table.cuh"

namespace {

constexpr int kLanes = 128;        // lanes per group row
constexpr int kThreads = 1024;     // a lockstep kernel's block
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kLenMask = 63;  // entry word = lj | len (len <= 26)
constexpr int kCodeTable = glz::kCodeLevels;  // fc_lj / offsets entries

// Exclusive prefix of `x` over the block's threads (thread order); writes the
// block total to *total.  `warp_tot` is one of two shared buffers of 32 ints
// that the caller alternates between consecutive calls: a warp can only
// reach the call after next by passing the next call's barrier, which every
// warp reaches after its reads of this call's buffer.
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
  int wt = warp_tot[lane];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, wt, o);
    if (lane >= o) wt += y;
  }
  const int before = __shfl_sync(0xffffffffu, wt, (warp + 31) & 31);
  *total = __shfl_sync(0xffffffffu, wt, 31);
  return (warp ? before : 0) + inc - x;
}

// Valid symbols of a lane whose first symbol sits at flat index `first`.
__device__ __forceinline__ int lane_count(int64_t limit, int64_t first, int S) {
  const int64_t r = limit - first;
  return r <= 0 ? 0 : (r >= S ? S : static_cast<int>(r));
}

// The sum of `x` over aligned segments of `seg` threads of a warp (seg a
// power of two, at most 32), in every thread of the segment.
__device__ __forceinline__ int segment_sum(int x, int seg) {
  if (seg == 32) return __reduce_add_sync(0xffffffffu, x);  // 8% faster than the shuffles (probe)
  for (int o = seg >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A lane's refill word count from its bit total and its last code's length.
__device__ __forceinline__ int refill_words(int tot, int last) {
  return tot > 0 ? (tot - last + 31) / 32 + 1 : 0;
}

// ---------------------------------------------------------------------------
// K1: per-lane bit totals and per-group refill word counts.
//   ctot[g, l] = sum_t len(sym_t), len = tbl[b] & 63, 0 where the flat index
//                (g*G + l)*S + t >= n_valid;
//   gw[g]     += sum_l [ctot > 0] * ((ctot - len_last + 31) / 32 + 1).
// Bound by reading the n symbol bytes once.  Timed apart on an H100
// (tools/k1_phases.py, PERF.md), the first port (a thread a lane, reading
// it 16 bytes at a time, so a warp load touched 32 lines S bytes apart)
// lost 0.63 of 0.75 ms to its loads and 0.35 to a validity test on every
// byte; the length table's bank conflicts cost nothing measurable.  So:
//   * loads: the threads of a warp read consecutive 16-byte chunks (a warp
//     load is 512 contiguous bytes), four rows of 512 bytes in flight a
//     thread; a lane's total is a segmented shuffle reduction within a row
//     (min(S/16, 32) threads a lane), summed over the lane's rows where
//     S > 512.  A warp takes whole lanes (units of max(S, 2048) bytes), so
//     the thread holding a lane's last chunk ends up with the total and the
//     last byte's length, and stores the total;
//   * validity: tested once a chunk; a chunk wholly below n_valid sums its
//     16 lengths unmasked.
// A block's units lie in one group: each warp adds its lanes' word counts
// to gw with one atomic at the end (gw must be zero on entry; a block sum
// and one atomic a block measured no faster).
// ---------------------------------------------------------------------------
constexpr int kTotThreads = 512;
constexpr int kTotWarps = kTotThreads / 32;
constexpr int kTotRows = 4;  // 512-byte rows a warp loads at once

__global__ void __launch_bounds__(kTotThreads) lane_totals_kernel(
    const uint8_t* __restrict__ sym, const uint32_t* __restrict__ tbl,
    int64_t n_valid, int S, int G, int32_t* __restrict__ ctot,
    int32_t* __restrict__ gw) {
  __shared__ uint8_t lens[256];
  if (threadIdx.x < 256) lens[threadIdx.x] = static_cast<uint8_t>(tbl[threadIdx.x] & kLenMask);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x;
  const int s_log = __ffs(S) - 1;                 // S is a power of two
  const int seg = min(S >> 4, 32);                // threads a lane within a row
  const int unit = max(S, kTotRows * 512);        // bytes a warp takes at a time
  const int n_units = static_cast<int>(static_cast<int64_t>(G) * S / unit);
  const int64_t group_first = static_cast<int64_t>(g) * G * S;
  int words = 0;
  for (int u = blockIdx.y * kTotWarps + warp; u < n_units; u += gridDim.y * kTotWarps) {
    int acc = 0;  // the running total of the lane whose rows this warp is in
    for (int r0 = 0; r0 < unit; r0 += kTotRows * 512) {
      const int64_t row0 = group_first + static_cast<int64_t>(u) * unit + r0;
      uint4 q[kTotRows];
#pragma unroll
      for (int r = 0; r < kTotRows; ++r)
        q[r] = *reinterpret_cast<const uint4*>(sym + row0 + r * 512 + lane * 16);
#pragma unroll
      for (int r = 0; r < kTotRows; ++r) {
        const int64_t f = row0 + r * 512 + lane * 16;  // this thread's chunk
        const uint32_t w[4] = {q[r].x, q[r].y, q[r].z, q[r].w};
        const int64_t valid = n_valid - f;
        int sum = 0, last = 0;
        if (valid >= 16) {
#pragma unroll
          for (int k = 0; k < 16; ++k) sum += lens[(w[k >> 2] >> (8 * (k & 3))) & 255u];
          last = lens[w[3] >> 24];
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k)
            sum += k < valid ? lens[(w[k >> 2] >> (8 * (k & 3))) & 255u] : 0;
        }
        acc += segment_sum(sum, seg);
        if (((f + 16) & (S - 1)) == 0) {  // the lane's last chunk
          ctot[f >> s_log] = acc;
          words += refill_words(acc, last);
        }
        if (((row0 + (r + 1) * 512) & (S - 1)) == 0) acc = 0;  // the row ends a lane
      }
    }
  }
  words = __reduce_add_sync(0xffffffffu, words);
  if (lane == 0) atomicAdd(gw + g, words);
}

// ---------------------------------------------------------------------------
// K1e, K1 on the HuffWord path: the symbols are u32 lj|len entry words, already
// 0 past the valid token count, so a length is the entry's low 6 bits and
// no validity test is needed.  Bound by reading the 4n entry bytes once.
// The first port (a thread a lane, reading it 16 bytes at a time) had K1's
// strided loads: the threads of a warp were 4S bytes apart.  So it has
// K1's design: a warp load is 512 contiguous bytes (128 entries), four
// rows in flight a thread; a lane is min(S/4, 32) threads of a row, or
// several rows where S > 128; a warp takes whole lanes (units of max(S,
// 512) entries), so the thread holding a lane's last chunk holds its total
// and its last entry.  The grid is K1's.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kTotThreads) lane_totals_entries_kernel(
    const uint32_t* __restrict__ ent, int S, int G, int32_t* __restrict__ ctot,
    int32_t* __restrict__ gw) {
  constexpr int kRow = 128;                       // entries a warp loads at once
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x;
  const int s_log = __ffs(S) - 1;                 // S is a power of two
  const int seg = min(S >> 2, 32);                // threads a lane within a row
  const int unit = max(S, kTotRows * kRow);       // entries a warp takes at a time
  const int n_units = static_cast<int>(static_cast<int64_t>(G) * S / unit);
  const int64_t group_first = static_cast<int64_t>(g) * G * S;
  int words = 0;
  for (int u = blockIdx.y * kTotWarps + warp; u < n_units; u += gridDim.y * kTotWarps) {
    int acc = 0;  // the running total of the lane whose rows this warp is in
    for (int r0 = 0; r0 < unit; r0 += kTotRows * kRow) {
      const int64_t row0 = group_first + static_cast<int64_t>(u) * unit + r0;
      uint4 q[kTotRows];
#pragma unroll
      for (int r = 0; r < kTotRows; ++r)
        q[r] = *reinterpret_cast<const uint4*>(ent + row0 + r * kRow + lane * 4);
#pragma unroll
      for (int r = 0; r < kTotRows; ++r) {
        const int64_t f = row0 + r * kRow + lane * 4;  // this thread's chunk
        const int sum = static_cast<int>((q[r].x & kLenMask) + (q[r].y & kLenMask) +
                                         (q[r].z & kLenMask) + (q[r].w & kLenMask));
        acc += segment_sum(sum, seg);
        if (((f + 4) & (S - 1)) == 0) {  // the lane's last chunk
          ctot[f >> s_log] = acc;
          words += refill_words(acc, static_cast<int>(q[r].w & kLenMask));
        }
        if (((row0 + (r + 1) * kRow) & (S - 1)) == 0) acc = 0;  // the row ends a lane
      }
    }
  }
  words = __reduce_add_sync(0xffffffffu, words);
  if (lane == 0) atomicAdd(gw + g, words);
}

// The blocks of a kernel of kTotThreads threads that the current card holds
// at once, queried once a card into `cache` (one array a kernel).
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, std::atomic<int>* cache, int* blocks) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const bool cached = device < kMaxDevices;
  *blocks = cached ? cache[device].load(std::memory_order_relaxed) : 0;
  if (*blocks > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTotThreads, 0);
  if (e != cudaSuccess) return e;
  *blocks = sms * per_sm;
  if (cached) cache[device].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// The grid of K1 and its HuffWord form: as many blocks as the card holds at
// once, spread over the groups, but no more a group than it has warp units.
dim3 totals_grid(int resident, int n_groups, int64_t units) {
  const int64_t most = (units + kTotWarps - 1) / kTotWarps;  // blocks a group can use
  int64_t per_group = resident / n_groups;
  per_group = per_group < 1 ? 1 : (per_group > most ? most : per_group);
  return dim3(n_groups, static_cast<unsigned>(per_group));
}

// ---------------------------------------------------------------------------
// K2: the reverse-sweep encode.  Per lane, t = S-1 .. 0:
//   * the word the forward decoder loads at step t+1 is emitted (never at
//     t = S-1): the 32-bit word at the next 32-bit boundary of the 64-bit
//     window (w0, w1) = bits [c(t), c(t)+64) of the lane's stream;
//   * symbol t's left-justified code is prepended to the window.
// Emitted words go to a descending group cursor that starts at gw[g]: the
// step's k words in lane order fill [cursor-k, cursor), so the finished
// segment is in forward consumption order (ascending step, then lane).  The
// last emission is forward step 0's word for every lane with a step-0
// symbol.  The cursor is floored at 0 for addressing, writes outside
// [0, gw[g]) are dropped, and the unfloored final cursor goes to
// cursor_end[g]: exactly 0 in every group when gw is the exact count.
// Its roofline bound is bytes (n symbol bytes in, ~0.56 n payload bytes out
// on text-like data), but the sweep is serial in t and every step needs the
// whole group's emission count, so a block barrier per step with one group
// per SM is what limits it.  The design spends that step on register work
// only: lane state stays in registers and emitted words go straight to
// their final payload slot.  Timed apart on an H100 (tools/k2_phases.py,
// PERF.md), the first port's step lost most to its input loads (4 bytes a
// lane every fourth step, at a stride of S bytes, used in the step that
// issued them: over half its time), then to the entry lookups, the block
// scan and the emission stores.  So:
//   * input: each thread stages its lanes' next 16 bytes (16 steps) in
//     shared memory, one 16-byte cp.async a lane into one 16-byte slot.
//     The copy is issued the step after the slot's last word was read and
//     waited for three steps later, when the next 16 steps begin, so it
//     never stands in the step that issued it.  A thread reads back only
//     its own staging, so this needs no barrier (slots rotated by thread so
//     a warp's reads spread over 8 banks).  This alone took the kernel to
//     what the probe's kernel without loads takes;
//   * lookups: each lane's entry is looked up once a step and held across
//     the step's barrier (looking it up on both sides of the barrier, to
//     save eight registers, measured slower).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Dynamic shared memory of K2 at LPT lanes a thread: the staged input.
template <int LPT>
constexpr size_t encode_smem() {
  return sizeof(uint4) * kThreads * LPT;
}

template <int LPT>
__global__ void __launch_bounds__(kThreads, 1) encode_kernel(
    const uint8_t* __restrict__ sym, const uint32_t* __restrict__ tbl,
    int64_t n_valid, const int32_t* __restrict__ ctot,
    const int32_t* __restrict__ gw, const int32_t* __restrict__ grow, int S,
    uint32_t* __restrict__ out, int32_t* __restrict__ cursor_end) {
  extern __shared__ uint4 enc_smem[];
  uint4* stage = enc_smem + threadIdx.x * LPT;  // this thread's LPT x 16 staged bytes
  __shared__ uint32_t ent[256];
  __shared__ int warp_tot[2][kWarps];
  if (threadIdx.x < 256) ent[threadIdx.x] = tbl[threadIdx.x];
  __syncthreads();

  constexpr int G = LPT * kThreads;
  const int g = blockIdx.x;
  const int64_t lane0 = static_cast<int64_t>(g) * G + threadIdx.x * LPT;
  const int64_t first = lane0 * S;
  // valid symbols of this thread's LPT lanes, lane j: clamp(rem - j*S, 0, S)
  const int rem = lane_count(n_valid, first, LPT * S);
  const uint8_t* byte_src = sym + first;
  // lane j's 16-byte chunk at byte offset c goes to slot (j + thread) % LPT
  auto stage_chunk = [&](int c) {
#pragma unroll
    for (int j = 0; j < LPT; ++j)
      cp_async16(stage + ((j + threadIdx.x) & (LPT - 1)),
                 byte_src + static_cast<int64_t>(j) * S + c);
    cp_async_commit();
  };
  stage_chunk(S - 16);

  uint32_t w0[LPT], w1[LPT], q[LPT];
  int cur[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    w0[j] = 0u;
    w1[j] = 0u;
    q[j] = 0u;
    cur[j] = ctot[lane0 + j];
  }
  const int gwords = gw[g];
  int cursor = gwords;
  uint32_t* dst = out + static_cast<int64_t>(grow[g]) * kLanes;
  int parity = 0;
  uint32_t step0 = 0u;  // lanes with a step-0 symbol

  for (int t = S - 1; t >= 0; --t) {
    const int sh = 8 * (t & 3);
    if ((t & 15) == 15) cp_async_wait<0>();
    if ((t & 3) == 3) {
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        q[j] = reinterpret_cast<const uint32_t*>(stage + ((j + threadIdx.x) & (LPT - 1)))
            [(t & 15) >> 2];
    }
    // the chunk's last word was read (and used) a step ago: stage the next
    if ((t & 15) == 2 && t > 16) stage_chunk((t & ~15) - 16);
    // entry of lane j's symbol t (0 past the lane's valid count), looked up
    // once and held across the step's barrier
    uint32_t e[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j)
      e[j] = (t < min(max(rem - j * S, 0), S)) ? ent[(q[j] >> sh) & 255u] : 0u;
    if (t != S - 1) {
      // ---- emission for forward step t+1
      uint32_t need = 0u;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int cp = cur[j] - static_cast<int>(e[j] & kLenMask);
        if (((cur[j] + 31) >> 5) > ((cp + 31) >> 5)) need |= 1u << j;
      }
      int total;
      const int pre = block_exclusive_scan(__popc(need), warp_tot[parity], &total);
      parity ^= 1;
      cursor -= total;
      int pos = max(cursor, 0) + pre;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        if (need & (1u << j)) {
          const uint32_t d = (32u - (static_cast<uint32_t>(cur[j]) & 31u)) & 31u;
          const uint32_t word = d ? ((w0[j] << d) | (w1[j] >> (32u - d))) : w0[j];
          if (pos < gwords) dst[pos] = word;
          ++pos;
        }
      }
    }
    // ---- prepend symbol t's code: shift the window right by ln
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const uint32_t ln = e[j] & kLenMask;
      if (ln > 0u) {
        const uint32_t lj = e[j] & ~kLenMask;
        const bool big = ln >= 32u;
        const uint32_t lnc = ln & 31u;
        const uint32_t sl = (32u - ln) & 31u;
        const uint32_t rs1 = big ? 0u : (w1[j] >> lnc);
        const uint32_t rs0 = big ? 0u : (w0[j] >> lnc);
        w1[j] = (w0[j] << sl) | rs1;
        w0[j] = lj | rs0;
      }
      cur[j] -= static_cast<int>(ln);
      if (t == 0 && ln > 0u) step0 |= 1u << j;
    }
  }
  // ---- forward step 0: word 0 of every lane with a step-0 symbol
  int total;
  const int pre = block_exclusive_scan(__popc(step0), warp_tot[parity], &total);
  cursor -= total;
  int pos = max(cursor, 0) + pre;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    if (step0 & (1u << j)) {
      if (pos < gwords) dst[pos] = w0[j];
      ++pos;
    }
  }
  if (threadIdx.x == 0) cursor_end[g] = cursor;
}

// ---------------------------------------------------------------------------
// K4: K2's reverse sweep on the HuffWord path, whose symbols are u32 lj|len
// entry words gathered by K6 (0 past the valid token count, so n_valid is
// not needed): the same function as encode_kernel, bound by bytes as well
// (4n entry bytes in, the payload out).  Timed apart on an H100
// (tools/k4_phases.py, PERF.md), the first port's body (K2's sweep reading
// one entry a lane a step at a stride of 4S bytes, in the step that used
// it) lost 1.01 of 1.76 ms to those loads and 0.40 to the block scan every
// step; with both gone and the stores folded, the steps' work alone took
// 0.53 ms on the 24 SMs of the HuffWord cell's 24 groups.  But which steps
// of a lane emit a word depends only on the lane's own code lengths, so K4
// sweeps in rounds of kEntRound steps, with no barrier inside a round:
//   * phase A walks the round's lengths and stores each warp's count of
//     emitting lanes at each step in shared memory;
//   * one exchange a round: after a block barrier, warp i scans step i's
//     warp counts into each warp's offset within the block, the block's
//     step totals go into every block of the cluster's shared memory
//     (map_shared_rank) and the cluster synchronises; then each warp has,
//     per step, the group cursor (which descends by the cluster's total, as
//     in encode_kernel) and the emissions of the blocks before its own;
//   * phase B sweeps the round again (the windows, the words, their
//     stores), a word's position its warp's offset plus its lane's rank
//     among the warp's emitting lanes.
// The forward step 0 words (every lane with a step-0 symbol) take one more
// exchange, of one step.  Input: the round's entries are staged in shared
// memory with cp.async (16 bytes, 4 steps, a copy) and both phases read them
// there; the next round's copies are issued after the barrier that ends
// this round's phase A, so they land while this round is swept.  A thread
// reads back only its own lane's entries, in a layout where a warp's
// 16-byte reads are consecutive.
// Geometry.  A group of G = rows*128 lanes is a cluster of C = rows/8
// blocks of 1,024 threads (one block at rows 8), block b owning lanes
// [b*G/C, (b+1)*G/C), one lane a thread.  tools/k4_phases.py timed this
// on an H100 against one block a group with rows/8 lanes a thread (its own
// copy of that kernel, PERF.md): the cluster was faster at rows 16, 32 and
// 64, by 1.7x, 3.1x and 6.1x.
// ---------------------------------------------------------------------------
// Steps a round (rounds of 8, twice the exchanges, measured 8% slower), and
// the staged entries of two rounds: 128 KiB a block.
constexpr int kEntRound = 16;
constexpr int kEntChunks = kEntRound / 4;  // staged 16-byte chunks a lane a round
constexpr size_t kEntSmem = sizeof(uint4) * 2 * kEntChunks * kThreads;

// Entry k (0-3, ascending step) of a staged 16-byte chunk.
__device__ __forceinline__ uint32_t chunk_entry(const uint4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1) encode_entries_kernel(
    const uint32_t* __restrict__ ent, const int32_t* __restrict__ ctot,
    const int32_t* __restrict__ gw, const int32_t* __restrict__ grow, int S,
    uint32_t* __restrict__ out, int32_t* __restrict__ cursor_end) {
  constexpr int W = kEntRound;
  extern __shared__ uint4 enc_smem[];  // [2][kEntChunks][kThreads]
  __shared__ int cnt[W][kWarps];  // warp w's emitting lanes at step i, then its offset
  __shared__ int xch[2][W][C];    // each block's emissions at each step, by round parity

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;  // the warp's threads before this one
  int cta = 0;
  if constexpr (C > 1) cta = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  constexpr int G = C * kThreads;
  const int g = blockIdx.x / C;
  const int64_t flat_lane =
      static_cast<int64_t>(g) * G + cta * kThreads + static_cast<int>(threadIdx.x);
  const uint32_t* src = ent + flat_lane * S;
  // the entries of steps [t_lo, t_lo + W) of this thread's lane into buffer b
  auto stage_round = [&](int b, int t_lo) {
#pragma unroll
    for (int c = 0; c < kEntChunks; ++c)
      cp_async16(enc_smem + (b * kEntChunks + c) * kThreads + threadIdx.x, src + t_lo + 4 * c);
    cp_async_commit();
  };
  stage_round(0, S - W);

  uint32_t w0 = 0u, w1 = 0u;
  int cur = ctot[flat_lane], cur_a = cur;  // the bit counts of phase B and of phase A
  const int gwords = gw[g];
  int cursor = gwords;
  uint32_t* dst = out + static_cast<int64_t>(grow[g]) * kLanes;
  // every block of the cluster has started before any writes another's
  // shared memory
  if constexpr (C > 1) cooperative_groups::this_cluster().sync();

  // Called by every thread once every warp has stored its counts of `steps`
  // steps in cnt (and passed a block barrier).  cnt[i][w] becomes warp w's
  // offset among the block's emissions at step i, and lane i < steps
  // returns step i's base: the cursor after step i, floored at 0, plus the
  // emissions of the cluster's blocks before this one.  The cursor descends
  // by the steps' total.
  auto exchange = [&](int steps, int par) -> int {
    if (warp < steps) {
      const int v = cnt[warp][lane];
      int inc = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      cnt[warp][lane] = inc - v;
      const int tot = __shfl_sync(0xffffffffu, inc, 31);
      if constexpr (C > 1) {
        if (lane < C)
          cooperative_groups::this_cluster().map_shared_rank(&xch[par][warp][0], lane)[cta] = tot;
      } else if (lane == 0) {
        xch[par][warp][0] = tot;
      }
    }
    if constexpr (C > 1) cooperative_groups::this_cluster().sync(); else __syncthreads();
    int all = 0, before = 0;
    if (lane < steps) {
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const int v = xch[par][lane][r];
        all += v;
        before += r < cta ? v : 0;
      }
    }
    int cum = all;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, cum, o);
      if (lane >= o) cum += y;
    }
    const int base = max(cursor - cum, 0) + before;
    cursor -= __shfl_sync(0xffffffffu, cum, 31);
    return base;
  };

  const int rounds = S / W;
  bool step0 = false;  // the lane has a step-0 symbol
  for (int k = 0; k < rounds; ++k) {
    const int t_lo = S - (k + 1) * W;  // the round's steps, t_lo + W - 1 down to t_lo
    const int b = k & 1;
    cp_async_wait<0>();
    // this thread's chunk c at stage[c * kThreads]
    const uint4* stage = enc_smem + b * kEntChunks * kThreads + threadIdx.x;
    uint4 q;
    // ---- phase A: each warp's count of emitting lanes at each step
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int p = W - 1 - i;  // step t_lo + p
      if ((p & 3) == 3) q = stage[(p >> 2) * kThreads];
      const int cp = cur_a - static_cast<int>(chunk_entry(q, p & 3) & kLenMask);
      bool need = ((cur_a + 31) >> 5) > ((cp + 31) >> 5);
      cur_a = cp;
      if (k == 0 && i == 0) need = false;  // step S-1 emits nothing
      const int n = __reduce_add_sync(0xffffffffu, need ? 1 : 0);
      if (lane == 0) cnt[i][warp] = n;
    }
    __syncthreads();
    if (k + 1 < rounds) stage_round(b ^ 1, t_lo - W);
    const int base = exchange(W, k & 1);
    // ---- phase B: the sweep, each word stored at its known position
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int p = W - 1 - i;
      if ((p & 3) == 3) q = stage[(p >> 2) * kThreads];
      const uint32_t e = chunk_entry(q, p & 3);
      const int cp = cur - static_cast<int>(e & kLenMask);
      bool need = ((cur + 31) >> 5) > ((cp + 31) >> 5);
      if (k == 0 && i == 0) need = false;
      // ---- emission for forward step t_lo + p + 1
      const int pos = __shfl_sync(0xffffffffu, base, i) + cnt[i][warp] +
                      __popc(__ballot_sync(0xffffffffu, need) & below);
      if (need) {
        const uint32_t d = (32u - (static_cast<uint32_t>(cur) & 31u)) & 31u;
        const uint32_t word = d ? ((w0 << d) | (w1 >> (32u - d))) : w0;
        if (pos < gwords) dst[pos] = word;
      }
      // ---- prepend the step's code: shift the window right by ln
      const uint32_t ln = e & kLenMask;
      if (ln > 0u) {
        const uint32_t lj = e & ~kLenMask;
        const bool big = ln >= 32u;
        const uint32_t lnc = ln & 31u;
        const uint32_t sl = (32u - ln) & 31u;
        const uint32_t rs1 = big ? 0u : (w1 >> lnc);
        const uint32_t rs0 = big ? 0u : (w0 >> lnc);
        w1 = (w0 << sl) | rs1;
        w0 = lj | rs0;
      }
      cur -= static_cast<int>(ln);
      if (p == 0 && t_lo == 0 && ln > 0u) step0 = true;
    }
  }
  // ---- forward step 0: word 0 of every lane with a step-0 symbol
  const uint32_t mask0 = __ballot_sync(0xffffffffu, step0);
  if (lane == 0) cnt[0][warp] = __popc(mask0);
  __syncthreads();
  const int base0 = exchange(1, rounds & 1);
  const int pos = __shfl_sync(0xffffffffu, base0, 0) + cnt[0][warp] + __popc(mask0 & below);
  if (step0 && pos < gwords) dst[pos] = w0;
  if (cta == 0 && threadIdx.x == 0) cursor_end[g] = cursor;
}

// ---------------------------------------------------------------------------
// K3: lockstep decode.  Per group, G lanes decode one symbol each per step
// for S steps.  Lanes whose refill flag is set take the payload words at
// start + base + (exclusive rank among refilling lanes), and base advances
// by the step's count k.  The 32-bit window v comes from registers (a, b)
// and the bit phase; the code's length and symbol come from the shared
// decode table (decode_table.cuh), which equals the canonical scan
// len = min_len + sum_l [v < fc_lj[l]], sym = symtab[((v >> (32-len)) +
// offsets[len]) & 255].  Lanes past their symbol count decode nothing and
// write 0.  Loads past the payload read 0.
// Bound by bytes (the payload read once, the output written once), but
// serial in t with a block barrier per step and one block per SM.  Timed
// apart on an H100 (tools/k3_phases.py, PERF.md), the first port's step lost most to
// its stores (4-byte stores at a stride of S bytes, four useful bytes per
// 32-byte sector), then to the ~20-level canonical scan, then to refill
// loads that waited in the step that issued them.  So:
//   * stores: each thread stages its lanes' output in shared memory, 4
//     bytes every 4 steps, and writes each lane's 16 bytes with one 16-byte
//     store every 16 steps (a thread reads back only its own staging, so
//     this needs no barrier; slots and words are rotated by thread so a
//     warp's staging stores hit distinct banks);
//   * the table: one shared-memory probe instead of the level scan;
//   * refills: a group's refill words are one contiguous segment consumed
//     in order, so a ring of kRingWords words in shared memory is filled
//     with 16-byte cp.async copies up to kRingWords words past the step's
//     cursor, and lanes read their word from the ring.  A copy issued at
//     step t is waited for at the end of step t + 1 and read from step
//     t + 2 on (the next step's barrier makes it visible to all threads);
//     a word not yet in the ring (steps where most lanes refill) is read
//     from the payload directly.
// ---------------------------------------------------------------------------
constexpr int kRingWords = 1 << 14;  // 64 KiB of refill words
constexpr int kStageSteps = 16;      // output steps staged per lane

// Start the copies of payload words [from, to) (multiples of 4) into their
// ring slots, zeros past n_words; the block's threads share the chunks.
__device__ __forceinline__ void fill_ring(uint32_t* ring, const uint32_t* __restrict__ payload,
                                         int64_t n_words, int64_t from, int64_t to) {
  for (int64_t c = from + 4 * static_cast<int64_t>(threadIdx.x); c < to; c += 4 * kThreads) {
    uint32_t* dst = ring + (c & (kRingWords - 1));
    if (c + 4 <= n_words) {
      cp_async16(dst, payload + c);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[q] = c + q < n_words ? payload[c + q] : 0u;
    }
  }
}

template <int LPT>
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(
    const uint32_t* __restrict__ payload, int64_t n_words,
    const int64_t* __restrict__ gstart, const int32_t* __restrict__ gcount,
    int table_bits, const uint32_t* __restrict__ fc_g, const uint32_t* __restrict__ off_g,
    const uint32_t* __restrict__ symtab_g, int min_len, int max_len, int S,
    uint8_t* __restrict__ out) {
  extern __shared__ uint4 dyn_smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(dyn_smem);      // kRingWords
  uint32_t* stage = ring + kRingWords + threadIdx.x * LPT * 4;  // this thread's LPT x 16 B
  __shared__ glz::DecodeTable tbl;
  __shared__ int warp_tot[2][kWarps];
  glz::build_decode_table(tbl, table_bits, fc_g, off_g, symtab_g, min_len, max_len);

  constexpr int G = LPT * kThreads;
  const int g = blockIdx.x;
  const int lane_in_group = threadIdx.x * LPT;
  const int rem = lane_count(gcount[g], static_cast<int64_t>(lane_in_group) * S, LPT * S);
  uint8_t* dst = out + (static_cast<int64_t>(g) * G + lane_in_group) * S;
  const uint32_t rot = (threadIdx.x >> 3) & 3u;  // staging word rotation

  int64_t base = gstart[g];
  int64_t issued = (base & ~static_cast<int64_t>(3)) + kRingWords;
  fill_ring(ring, payload, n_words, issued - kRingWords, issued);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  int64_t avail = issued, pending = issued;  // words below avail are in the ring

  // per lane: window words a, b; packed output acc; pq = phase | qm << 8
  uint32_t a[LPT], b[LPT], acc[LPT], pq[LPT];
  uint32_t need = 0u;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    a[j] = 0u;
    b[j] = 0u;
    acc[j] = 0u;
    pq[j] = 31u << 8;
    if (min(max(rem - j * S, 0), S) > 0) need |= 1u << j;
  }
  int parity = 0;

  for (int t = 0; t < S; ++t) {
    // ---- refill: refilling lanes take sequential words in lane order
    int total;
    const int pre = block_exclusive_scan(__popc(need), warp_tot[parity], &total);
    parity ^= 1;
    int64_t idx = base + pre;
    const int64_t target = (base & ~static_cast<int64_t>(3)) + kRingWords;
    base += total;
    if (target > issued) {
      fill_ring(ring, payload, n_words, issued, target);
      issued = target;
    }
    cp_async_commit();
    uint32_t next_need = 0u;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const uint32_t phase = pq[j] & 31u;
      const uint32_t qm = pq[j] >> 8;
      if (need & (1u << j)) {
        const uint32_t w = idx < avail ? ring[idx & (kRingWords - 1)]
                                       : (idx < n_words ? payload[idx] : 0u);
        ++idx;
        if (phase == 0u) a[j] = w; else b[j] = w;
      }
      // ---- 32-bit window, left-justified; one table probe
      const uint32_t v = phase ? ((a[j] << phase) | (b[j] >> (32u - phase))) : a[j];
      uint32_t s;
      uint32_t ln = glz::decode_one(tbl, v, &s);
      if (t >= min(max(rem - j * S, 0), S)) {  // inactive lane
        ln = 0u;
        s = 0u;
      }
      acc[j] |= s << (8 * (t & 3));
      if ((t & 3) == 3) {
        stage[((j + threadIdx.x) & (LPT - 1)) * 4 + ((((t >> 2) & 3) + rot) & 3u)] = acc[j];
        acc[j] = 0u;
      }
      // ---- advance
      if (phase + ln >= 32u) a[j] = b[j];
      if (qm + ln >= 32u) next_need |= 1u << j;
      pq[j] = ((phase + ln) & 31u) | (((qm + ln) & 31u) << 8);
    }
    need = next_need;
    if ((t & (kStageSteps - 1)) == kStageSteps - 1) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const uint4 w = reinterpret_cast<const uint4*>(stage)[(j + threadIdx.x) & (LPT - 1)];
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
        uint32_t o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t at = (q + rot) & 3u;
          o[q] = at == 0u ? ws[0] : at == 1u ? ws[1] : at == 2u ? ws[2] : ws[3];
        }
        *reinterpret_cast<uint4*>(dst + j * S + t - (kStageSteps - 1)) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
    cp_async_wait<1>();
    avail = pending;
    pending = issued;
  }
}

// ---------------------------------------------------------------------------
// K5: the HuffWord lockstep decode: K3 with two codebooks that alternate by
// step parity.  S is even and lane starts are multiples of S, so step
// parity is token parity, and step t decodes with codebook t & 1 (set 0 is
// the even tokens' dictionary).  The output is the token's canonical rank
// (v >> (32-len)) + offsets[len], one u32 per token in file order; K6 maps
// ranks to token ids.  Inactive tokens write rank 0.  A codebook of an
// empty dictionary has min_len = max_len = 0 and is only ever used by
// inactive tokens.  Bound by bytes (the payload read once, the ranks
// written once), but serial in t with the group's refill scan every step.
// Timed apart on an H100 (tools/k5_phases.py, PERF.md), the first port's
// step lost most to its 4-byte rank stores at a stride of 4S bytes, then
// its canonical scan, its refill loads and the block scan, as K3's did.  So
// K5 takes K3's design:
//   * codes: one probe of the dual tables each block builds
//     (decode_table.cuh: build_dual_table, decode_dual); the rank comes
//     from the window and offsets[len], so ranks above 65,535 need nothing
//     more;
//   * ranks: each lane's ranks go to shared memory and leave as 16-byte
//     stores every dual_stage<LPT>() steps (a rank is 4 bytes): every 8
//     steps, a whole 32-byte sector, where a thread has one lane, else every
//     4; the staging is step-major (step, lane, thread), so a warp's
//     staging stores and its reads back are to consecutive words;
//   * refills: K3's ring of kRingWords words filled with cp.async ahead of
//     the group's cursor.
// Geometry.  A group of G = rows*128 lanes is one block of 1,024 threads
// with LPT = rows/8 lanes each (C = 1, as K3 runs), or a cluster of C =
// rows/8 blocks, each owning a contiguous 1/C of the lanes with one lane a
// thread.  A cluster spreads a group over C SMs (the HuffWord benchmark's
// 24 groups of rows 32 take 96 SMs instead of 24), and pays for it each
// step: every block writes its refill count into every block's shared
// memory and the cluster synchronises, so each block knows the counts
// before its own.  Each block of a cluster fills its own ring with the
// group's whole word stream (the other blocks' words come from L2).  The
// entry launches the faster geometry at each rows, as tools/k5_phases.py
// timed both on an H100 (PERF.md): one block at rows 8 and 16, the cluster
// at rows 32 and 64.  Shared memory a block: the 64 KiB ring, 32 KiB of
// staged ranks and the two tables (2 x 4 KiB at 12 bits).
// ---------------------------------------------------------------------------
// Steps of ranks staged per lane.
template <int LPT>
__host__ __device__ constexpr int dual_stage() {
  return LPT == 1 ? 8 : 4;
}

// Dynamic shared memory of K5 before its tables: the ring and the staging.
template <int LPT>
constexpr size_t dual_smem() {
  return sizeof(uint32_t) *
         (kRingWords + static_cast<size_t>(kThreads) * LPT * dual_stage<LPT>());
}

// Writes the ranks of steps [t0, t] of this thread's lanes, t0 = t rounded
// down to a multiple of dual_stage<LPT>(), from the staging (rank of step
// w, lane j at stage[(w * LPT + j) * kThreads + thread]): 16-byte stores
// (4-byte stores for a partial last piece, or where S % 4 != 0 leaves the
// lane unaligned).
template <int LPT>
__device__ __forceinline__ void flush_ranks(const uint32_t* stage, uint32_t* __restrict__ dst,
                                            int S, int t) {
  constexpr int kStage = dual_stage<LPT>();
  const int t0 = t & ~(kStage - 1);
  const bool whole = t - t0 == kStage - 1 && (S & 3) == 0;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    uint32_t o[kStage];
#pragma unroll
    for (int w = 0; w < kStage; ++w) o[w] = stage[(w * LPT + j) * kThreads + threadIdx.x];
    uint32_t* d = dst + j * S + t0;
    if (whole) {
#pragma unroll
      for (int q = 0; q < kStage; q += 4)
        *reinterpret_cast<uint4*>(d + q) = make_uint4(o[q], o[q + 1], o[q + 2], o[q + 3]);
    } else {
#pragma unroll
      for (int w = 0; w < kStage; ++w)
        if (w <= t - t0) d[w] = o[w];
    }
  }
}

template <int LPT, int C>
__global__ void __launch_bounds__(kThreads, 1) decode_dual_kernel(
    const uint32_t* __restrict__ payload, int64_t n_words,
    const int64_t* __restrict__ gstart, const int32_t* __restrict__ gcount, int table_bits,
    const uint32_t* __restrict__ fc_g, const uint32_t* __restrict__ off_g, int min0, int max0,
    int min1, int max1, int S, uint32_t* __restrict__ out) {
  constexpr int kStage = dual_stage<LPT>();
  extern __shared__ uint4 dyn_smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(dyn_smem);  // kRingWords
  uint32_t* stage = ring + kRingWords;                     // kStage x LPT x kThreads
  uint8_t* lut = reinterpret_cast<uint8_t*>(ring + kRingWords + kThreads * LPT * kStage);
  __shared__ glz::DualTable tbl;
  __shared__ int warp_tot[2][kWarps];
  __shared__ int cta_tot[2][C];  // the step's refill count of each block of the cluster
  glz::build_dual_table(tbl, lut, table_bits, fc_g, off_g, min0, max0, min1, max1);

  constexpr int G = C * LPT * kThreads;
  int cta = 0;
  if constexpr (C > 1) cta = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int g = blockIdx.x / C;
  const int lane_in_group = (cta * kThreads + static_cast<int>(threadIdx.x)) * LPT;
  const int rem = lane_count(gcount[g], static_cast<int64_t>(lane_in_group) * S, LPT * S);
  uint32_t* dst = out + (static_cast<int64_t>(g) * G + lane_in_group) * S;

  int64_t base = gstart[g];
  int64_t issued = (base & ~static_cast<int64_t>(3)) + kRingWords;
  fill_ring(ring, payload, n_words, issued - kRingWords, issued);
  cp_async_commit();
  cp_async_wait<0>();
  // every block of the cluster has started before any writes another's
  // shared memory
  if constexpr (C > 1) cooperative_groups::this_cluster().sync(); else __syncthreads();
  int64_t avail = issued, pending = issued;  // words below avail are in the ring

  // per lane: window words a, b; pq = phase | qm << 8
  uint32_t a[LPT], b[LPT], pq[LPT];
  uint32_t need = 0u;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    a[j] = 0u;
    b[j] = 0u;
    pq[j] = 31u << 8;
    if (min(max(rem - j * S, 0), S) > 0) need |= 1u << j;
  }
  int parity = 0;

  for (int t = 0; t < S; ++t) {
    const int p = t & 1;
    // ---- refill: refilling lanes take sequential words in lane order
    int total;
    int pre = block_exclusive_scan(__popc(need), warp_tot[parity], &total);
    if constexpr (C > 1) {
      auto cluster = cooperative_groups::this_cluster();
      if (threadIdx.x < C)
        cluster.map_shared_rank(&cta_tot[parity][0], static_cast<int>(threadIdx.x))[cta] = total;
      cluster.sync();
      int before = 0, all = 0;
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const int v = cta_tot[parity][r];
        before += r < cta ? v : 0;
        all += v;
      }
      pre += before;
      total = all;
    }
    parity ^= 1;
    int64_t idx = base + pre;
    const int64_t target = (base & ~static_cast<int64_t>(3)) + kRingWords;
    base += total;
    if (target > issued) {
      fill_ring(ring, payload, n_words, issued, target);
      issued = target;
    }
    cp_async_commit();
    uint32_t next_need = 0u;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const uint32_t phase = pq[j] & 31u;
      const uint32_t qm = pq[j] >> 8;
      if (need & (1u << j)) {
        const uint32_t word = idx < avail ? ring[idx & (kRingWords - 1)]
                                          : (idx < n_words ? payload[idx] : 0u);
        ++idx;
        if (phase == 0u) a[j] = word; else b[j] = word;
      }
      // ---- 32-bit window, left-justified; one table probe
      const uint32_t v = phase ? ((a[j] << phase) | (b[j] >> (32u - phase))) : a[j];
      uint32_t r;
      uint32_t ln = glz::decode_dual(tbl, lut, v, p, &r);
      if (t >= min(max(rem - j * S, 0), S)) {  // inactive token
        ln = 0u;
        r = 0u;
      }
      stage[((t & (kStage - 1)) * LPT + j) * kThreads + threadIdx.x] = r;
      // ---- advance
      if (phase + ln >= 32u) a[j] = b[j];
      if (qm + ln >= 32u) next_need |= 1u << j;
      pq[j] = ((phase + ln) & 31u) | (((qm + ln) & 31u) << 8);
    }
    need = next_need;
    if ((t & (kStage - 1)) == kStage - 1 || t == S - 1)
      flush_ranks<LPT>(stage, dst, S, t);
    cp_async_wait<1>();
    avail = pending;
    pending = issued;
  }
  // no block leaves while another may still write its shared memory
  if constexpr (C > 1) cooperative_groups::this_cluster().sync();
}

// ---------------------------------------------------------------------------
// K6: the vocabulary gather, with its callers' index math fused in:
//   out[i] = (lo + i < T) ? tbl[min(idx[i] + (i odd ? add_odd : add_even), V-1)] : 0
// gather_entries (token id -> lj|len entry word) adds the first
// dictionary's size on the tokens of the second; map_ranks (canonical rank
// -> token id) adds the even dictionary's size on odd tokens.  The index
// and output are u16 or u32 (Out truncates the table's u32 value).  The
// TPU kernel is a VMEM row-select chain capped at 64K entries; here one
// grid-stride loop serves every table size, the table (80 KB on the main
// path) is read through the read-only cache and stays in L2.  Bound by
// bytes: the index read and the output written once.
// ---------------------------------------------------------------------------
template <typename In, typename Out>
__global__ void __launch_bounds__(256) lut_gather_kernel(
    const In* __restrict__ idx, int64_t n, const uint32_t* __restrict__ tbl,
    int64_t v_last, int64_t lo, int64_t T, int64_t add_even, int64_t add_odd,
    Out* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t x = static_cast<int64_t>(idx[i]) + ((i & 1) ? add_odd : add_even);
    x = x < v_last ? x : v_last;
    out[i] = static_cast<Out>(lo + i < T ? __ldg(tbl + x) : 0u);
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).

// ent 16-byte aligned; S a power of two, at least 4.
int glz_lane_totals_entries(const void* ent, int n_groups, int S, int rows,
                            void* ctot, void* gw, void* stream) {
  const int G = rows * kLanes;
  if (n_groups <= 0 || S < 4 || (S & (S - 1)) != 0 || G % 256 != 0 ||
      reinterpret_cast<uintptr_t>(ent) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<int> cache[kMaxDevices];
  int resident = 0;
  const cudaError_t e = resident_blocks(lane_totals_entries_kernel, cache, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t units = static_cast<int64_t>(G) * S / (S > kTotRows * 128 ? S : kTotRows * 128);
  lane_totals_entries_kernel<<<totals_grid(resident, n_groups, units), kTotThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ent), S, G, static_cast<int32_t*>(ctot),
      static_cast<int32_t*>(gw));
  return static_cast<int>(cudaGetLastError());
}

// sym 16-byte aligned; S a power of two, at least 16.
int glz_lane_totals(const void* sym, const void* tbl, long long n_valid,
                    int n_groups, int S, int rows, void* ctot, void* gw,
                    void* stream) {
  const int G = rows * kLanes;
  if (n_groups <= 0 || S < 16 || (S & (S - 1)) != 0 || G % 256 != 0 ||
      reinterpret_cast<uintptr_t>(sym) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<int> cache[kMaxDevices];
  int resident = 0;
  const cudaError_t e = resident_blocks(lane_totals_kernel, cache, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t units = static_cast<int64_t>(G) * S / (S > kTotRows * 512 ? S : kTotRows * 512);
  lane_totals_kernel<<<totals_grid(resident, n_groups, units), kTotThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sym), static_cast<const uint32_t*>(tbl),
      n_valid, S, G, static_cast<int32_t*>(ctot), static_cast<int32_t*>(gw));
  return static_cast<int>(cudaGetLastError());
}

// sym 16-byte aligned; S a multiple of 16.
int glz_encode_groups(const void* sym, const void* tbl, long long n_valid,
                      const void* ctot, const void* gw, const void* grow,
                      int n_groups, int S, int rows, void* out,
                      void* cursor_end, void* stream) {
  if (n_groups <= 0 || S % 16 != 0 || reinterpret_cast<uintptr_t>(sym) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // K2 stages its input in dynamic shared memory
#define GLZ_ENCODE(LPT)                                                        \
  {                                                                            \
    const int smem = static_cast<int>(encode_smem<LPT>());                     \
    const cudaError_t e = cudaFuncSetAttribute(                                \
        encode_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
    if (e != cudaSuccess) return static_cast<int>(e);                          \
    encode_kernel<LPT><<<n_groups, kThreads, smem, st>>>(                      \
        static_cast<const uint8_t*>(sym), static_cast<const uint32_t*>(tbl),   \
        n_valid, static_cast<const int32_t*>(ctot),                            \
        static_cast<const int32_t*>(gw), static_cast<const int32_t*>(grow), S, \
        static_cast<uint32_t*>(out), static_cast<int32_t*>(cursor_end));       \
  }
  switch (rows) {
    case 8: GLZ_ENCODE(1); break;
    case 16: GLZ_ENCODE(2); break;
    case 32: GLZ_ENCODE(4); break;
    case 64: GLZ_ENCODE(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GLZ_ENCODE
  return static_cast<int>(cudaGetLastError());
}

// ent: u32 lj|len entry words, 16-byte aligned; S a multiple of 16.
int glz_encode_entries(const void* ent, const void* ctot, const void* gw,
                       const void* grow, int n_groups, int S, int rows, void* out,
                       void* cursor_end, void* stream) {
  if (n_groups <= 0 || S % 16 != 0 || reinterpret_cast<uintptr_t>(ent) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* e_in = static_cast<const uint32_t*>(ent);
  const int32_t* ct = static_cast<const int32_t*>(ctot);
  const int32_t* gwp = static_cast<const int32_t*>(gw);
  const int32_t* gr = static_cast<const int32_t*>(grow);
  uint32_t* o = static_cast<uint32_t*>(out);
  int32_t* ce = static_cast<int32_t*>(cursor_end);
  // a cluster of rows/8 blocks a group (one block at rows 8)
#define GLZ_ENCODE_ENTRIES(C)                                                           \
  {                                                                                     \
    auto kernel = encode_entries_kernel<C>;                                             \
    const size_t smem = kEntSmem;                                                       \
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                         static_cast<int>(smem));                       \
    if (e != cudaSuccess) return static_cast<int>(e);                                   \
    cudaLaunchConfig_t config = {};                                                     \
    cudaLaunchAttribute attr[1];                                                        \
    config.gridDim = dim3(static_cast<unsigned>(n_groups) * C);                         \
    config.blockDim = dim3(kThreads);                                                   \
    config.dynamicSmemBytes = smem;                                                     \
    config.stream = st;                                                                 \
    attr[0].id = cudaLaunchAttributeClusterDimension;                                   \
    attr[0].val.clusterDim.x = C;                                                       \
    attr[0].val.clusterDim.y = 1;                                                       \
    attr[0].val.clusterDim.z = 1;                                                       \
    config.attrs = attr;                                                                \
    config.numAttrs = C > 1 ? 1 : 0;                                                    \
    e = cudaLaunchKernelEx(&config, kernel, e_in, ct, gwp, gr, S, o, ce);               \
    if (e != cudaSuccess) return static_cast<int>(e);                                   \
  }
  switch (rows) {
    case 8: GLZ_ENCODE_ENTRIES(1); break;
    case 16: GLZ_ENCODE_ENTRIES(2); break;
    case 32: GLZ_ENCODE_ENTRIES(4); break;
    case 64: GLZ_ENCODE_ENTRIES(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GLZ_ENCODE_ENTRIES
  return static_cast<int>(cudaGetLastError());
}

// fc, offsets: u32[34]; symtab: u32[256]; table_bits in [1, 12]; payload
// 16-byte aligned; S a multiple of 16.
int glz_decode_groups(const void* payload, long long n_words, const void* gstart,
                      const void* gcount, int table_bits, const void* fc, const void* offsets,
                      const void* symtab, int min_len, int max_len, int n_groups, int S,
                      int rows, void* out, void* stream) {
  if (n_groups <= 0 || S % kStageSteps != 0 || min_len < 1 || max_len >= kCodeTable - 1 ||
      min_len > max_len || table_bits < 1 || table_bits > glz::kMaxTableBits ||
      reinterpret_cast<uintptr_t>(payload) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(uint32_t) * (kRingWords + static_cast<size_t>(rows) * kLanes * 4);
#define GLZ_DECODE(LPT)                                                                  \
  {                                                                                      \
    const cudaError_t e = cudaFuncSetAttribute(                                          \
        decode_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)); \
    if (e != cudaSuccess) return static_cast<int>(e);                                    \
    decode_kernel<LPT><<<n_groups, kThreads, smem, st>>>(                                \
        static_cast<const uint32_t*>(payload), n_words, static_cast<const int64_t*>(gstart), \
        static_cast<const int32_t*>(gcount), table_bits,                                 \
        static_cast<const uint32_t*>(fc), static_cast<const uint32_t*>(offsets),        \
        static_cast<const uint32_t*>(symtab), min_len, max_len, S,                       \
        static_cast<uint8_t*>(out));                                                     \
  }
  switch (rows) {
    case 8: GLZ_DECODE(1); break;
    case 16: GLZ_DECODE(2); break;
    case 32: GLZ_DECODE(4); break;
    case 64: GLZ_DECODE(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GLZ_DECODE
  return static_cast<int>(cudaGetLastError());
}

// fc, offsets: [2][34] u32, set 0 for even tokens.  A codebook's length
// range is [0, 0] (an empty dictionary) or within [1, 32].  table_bits in
// [1, 14] (the word table's; dual_bits).  S even; payload and out 16-byte
// aligned.
int glz_decode_dual(const void* payload, long long n_words, const void* gstart,
                    const void* gcount, int table_bits, const void* fc, const void* offsets,
                    int min0, int max0, int min1, int max1, int n_groups, int S, int rows,
                    void* out, void* stream) {
  auto bad_range = [](int lo, int hi) {
    return !((lo == 0 && hi == 0) || (1 <= lo && lo <= hi && hi <= kCodeTable - 2));
  };
  if (n_groups <= 0 || S < 2 || S % 2 != 0 || bad_range(min0, max0) || bad_range(min1, max1) ||
      table_bits < 1 || table_bits > glz::kMaxDualTableBits ||
      reinterpret_cast<uintptr_t>(payload) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t luts = (size_t{1} << glz::dual_bits(table_bits, max0)) +
                      (size_t{1} << glz::dual_bits(table_bits, max1));
  const uint32_t* pw = static_cast<const uint32_t*>(payload);
  const int64_t* gs = static_cast<const int64_t*>(gstart);
  const int32_t* gc = static_cast<const int32_t*>(gcount);
  const uint32_t* f = static_cast<const uint32_t*>(fc);
  const uint32_t* o = static_cast<const uint32_t*>(offsets);
  uint32_t* ranks = static_cast<uint32_t*>(out);
  const int64_t nw = n_words;
#define GLZ_DECODE_DUAL(LPT, C)                                                         \
  {                                                                                     \
    auto kernel = decode_dual_kernel<LPT, C>;                                           \
    const size_t smem = dual_smem<LPT>() + luts;                                        \
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                         static_cast<int>(smem));                       \
    if (e != cudaSuccess) return static_cast<int>(e);                                   \
    cudaLaunchConfig_t config = {};                                                     \
    cudaLaunchAttribute attr[1];                                                        \
    config.gridDim = dim3(static_cast<unsigned>(n_groups) * C);                         \
    config.blockDim = dim3(kThreads);                                                   \
    config.dynamicSmemBytes = smem;                                                     \
    config.stream = st;                                                                 \
    attr[0].id = cudaLaunchAttributeClusterDimension;                                   \
    attr[0].val.clusterDim.x = C;                                                       \
    attr[0].val.clusterDim.y = 1;                                                       \
    attr[0].val.clusterDim.z = 1;                                                       \
    config.attrs = attr;                                                                \
    config.numAttrs = C > 1 ? 1 : 0;                                                    \
    e = cudaLaunchKernelEx(&config, kernel, pw, nw, gs, gc, table_bits, f, o, min0, max0, \
                           min1, max1, S, ranks);                                       \
    if (e != cudaSuccess) return static_cast<int>(e);                                   \
  }
  switch (rows) {
    case 8: GLZ_DECODE_DUAL(1, 1); break;
    case 16: GLZ_DECODE_DUAL(2, 1); break;
    case 32: GLZ_DECODE_DUAL(1, 4); break;
    case 64: GLZ_DECODE_DUAL(1, 8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GLZ_DECODE_DUAL
  return static_cast<int>(cudaGetLastError());
}

// idx_bits, out_bits: 16 or 32 (u16 or u32 elements); n_table >= 1.
int glz_lut_gather(const void* idx, int idx_bits, long long n, const void* tbl,
                   long long n_table, long long lo, long long T, long long add_even,
                   long long add_odd, void* out, int out_bits, void* stream) {
  if (n <= 0 || n_table <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  const uint32_t* t = static_cast<const uint32_t*>(tbl);
#define GLZ_LUT(IN, OUT)                                                       \
  lut_gather_kernel<IN, OUT><<<blocks, 256, 0, st>>>(                          \
      static_cast<const IN*>(idx), n, t, n_table - 1, lo, T, add_even, add_odd, \
      static_cast<OUT*>(out))
  if (idx_bits == 16 && out_bits == 32) GLZ_LUT(uint16_t, uint32_t);
  else if (idx_bits == 32 && out_bits == 32) GLZ_LUT(uint32_t, uint32_t);
  else if (idx_bits == 32 && out_bits == 16) GLZ_LUT(uint32_t, uint16_t);
  else if (idx_bits == 16 && out_bits == 16) GLZ_LUT(uint16_t, uint16_t);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef GLZ_LUT
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
