// Lockstep (layout-2) codec kernels for Hopper (sm_90a).
//
// Each kernel replaces one TPU kernel of the JAX package and computes the
// same function:
//
//   K1 lane_totals_kernel          <- glz_tpu/ops/pallas_encode.py:make_totals_kernel
//      lane_totals_entries_kernel  <- glz_tpu/ops/pallas_encode.py:prepare_entry_words
//                                     (XLA code there; the HuffWord form of K1)
//   K2 encode_kernel<LPT, false>   <- glz_tpu/ops/pallas_encode.py:make_encode_kernel
//                                     (byte-LUT mode)
//   K4 encode_kernel<LPT, true>    <- the same factory, u32-entry mode
//   K3 decode_kernel               <- glz_tpu/ops/pallas_decode.py:make_decode_kernel
//   K5 decode_dual_kernel          <- glz_tpu/ops/pallas_decode.py:make_decode_kernel_dual
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
// or emit (encode) a word couples them.  One block of 1024 threads runs one
// group; each thread owns LPT = rows/8 *contiguous* lanes, so a lane's rank
// is the block's exclusive prefix over threads plus the thread-local prefix
// and flat lane order is kept.  The block prefix is a warp shuffle scan plus
// a scan of the 32 warp totals, double-buffered in shared memory so each
// step costs one __syncthreads.  Lane state lives in registers (4 u32 per
// lane); at rows=64 that is 32 registers a thread before temporaries, so
// the compiler may spill some of it (see ptxas -v).
//
// Shifts by 32 are undefined in CUDA: every site where the JAX kernels
// select around a 32-bit shift keeps that select.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_table.cuh"

namespace {

constexpr int kLanes = 128;        // lanes per group row
constexpr int kThreads = 1024;     // one block per group
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

// A lane's bit total, and its refill word count added to its group's: one
// atomic per warp (gw must be zero on entry).  The lanes of a warp belong
// to one group (G is a multiple of 256).
__device__ __forceinline__ void store_lane_total(int tot, int last, int64_t flat_lane,
                                                 int g, int32_t* __restrict__ ctot,
                                                 int32_t* __restrict__ gw) {
  ctot[flat_lane] = tot;
  int words = tot > 0 ? (tot - last + 31) / 32 + 1 : 0;
  words = __reduce_add_sync(0xffffffffu, words);
  if ((threadIdx.x & 31) == 0) atomicAdd(gw + g, words);
}

// ---------------------------------------------------------------------------
// K1: per-lane bit totals and per-group refill word counts.
//   ctot[g, l] = sum_t len(sym_t), len = tbl[b] & 63, 0 where the flat index
//                (g*G + l)*S + t >= n_valid;
//   gw[g]     += sum_l [ctot > 0] * ((ctot - len_last + 31) / 32 + 1).
// Bound by reading the n symbol bytes once: each thread owns one lane and
// reads it 16 bytes at a time; the 256-entry length table is in shared
// memory; gw is reduced per warp and added with one atomic per warp (gw must
// be zero on entry).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256) lane_totals_kernel(
    const uint8_t* __restrict__ sym, const uint32_t* __restrict__ tbl,
    int64_t n_valid, int S, int G, int32_t* __restrict__ ctot,
    int32_t* __restrict__ gw) {
  __shared__ uint8_t lens[256];
  lens[threadIdx.x] = static_cast<uint8_t>(tbl[threadIdx.x] & kLenMask);
  __syncthreads();
  const int g = blockIdx.x;
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  const int64_t flat_lane = static_cast<int64_t>(g) * G + lane;
  const int64_t first = flat_lane * S;
  const int count = lane_count(n_valid, first, S);
  const uint4* src = reinterpret_cast<const uint4*>(sym + first);
  int tot = 0;
  for (int i = 0; i * 16 < count; ++i) {
    const uint4 q = src[i];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int l = lens[(w[j >> 2] >> (8 * (j & 3))) & 255u];
      tot += (i * 16 + j < count) ? l : 0;
    }
  }
  const int last = (count == S) ? lens[sym[first + S - 1]] : 0;
  store_lane_total(tot, last, flat_lane, g, ctot, gw);
}

// K1 on the HuffWord path: the symbols are u32 lj|len entry words, already
// 0 past the valid token count, so the length is the entry's low 6 bits and
// no n_valid term is needed.  Each thread reads its lane 16 bytes (4
// entries) at a time; bound by reading the 4n entry bytes once.
__global__ void __launch_bounds__(256) lane_totals_entries_kernel(
    const uint32_t* __restrict__ ent, int S, int G, int32_t* __restrict__ ctot,
    int32_t* __restrict__ gw) {
  const int g = blockIdx.x;
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  const int64_t flat_lane = static_cast<int64_t>(g) * G + lane;
  const uint4* src = reinterpret_cast<const uint4*>(ent + flat_lane * S);
  int tot = 0;
  for (int i = 0; i < S / 4; ++i) {
    const uint4 q = src[i];
    tot += static_cast<int>((q.x & kLenMask) + (q.y & kLenMask) + (q.z & kLenMask) +
                            (q.w & kLenMask));
  }
  const int last = static_cast<int>(ent[flat_lane * S + S - 1] & kLenMask);
  store_lane_total(tot, last, flat_lane, g, ctot, gw);
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
//
// K4 (kEntries) is the same sweep on the HuffWord path, whose symbols are
// u32 lj|len entry words gathered by K6 (0 past the valid token count, so
// n_valid is not needed).  It keeps the first port's body: it reads one
// entry per lane per step into the register K2 uses for 4 staged bytes, so
// both forms hold the same state.  Its bound is bytes as well (4n entry
// bytes in).
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

template <int LPT, bool kEntries>
__global__ void __launch_bounds__(kThreads, 1) encode_kernel(
    const void* __restrict__ sym, const uint32_t* __restrict__ tbl,
    int64_t n_valid, const int32_t* __restrict__ ctot,
    const int32_t* __restrict__ gw, const int32_t* __restrict__ grow, int S,
    uint32_t* __restrict__ out, int32_t* __restrict__ cursor_end) {
  extern __shared__ uint4 enc_smem[];
  uint4* stage = enc_smem + threadIdx.x * LPT;  // this thread's LPT x 16 staged bytes
  __shared__ uint32_t ent[256];
  __shared__ int warp_tot[2][kWarps];
  if (!kEntries && threadIdx.x < 256) ent[threadIdx.x] = tbl[threadIdx.x];
  __syncthreads();

  constexpr int G = LPT * kThreads;
  const int g = blockIdx.x;
  const int64_t lane0 = static_cast<int64_t>(g) * G + threadIdx.x * LPT;
  const int64_t first = lane0 * S;
  // valid symbols of this thread's LPT lanes, lane j: clamp(rem - j*S, 0, S)
  const int rem = kEntries ? 0 : lane_count(n_valid, first, LPT * S);
  const uint32_t* ent_src = static_cast<const uint32_t*>(sym) + first;
  const uint8_t* byte_src = static_cast<const uint8_t*>(sym) + first;
  // lane j's 16-byte chunk at byte offset c goes to slot (j + thread) % LPT
  auto stage_chunk = [&](int c) {
#pragma unroll
    for (int j = 0; j < LPT; ++j)
      cp_async16(stage + ((j + threadIdx.x) & (LPT - 1)),
                 byte_src + static_cast<int64_t>(j) * S + c);
    cp_async_commit();
  };
  if (!kEntries) stage_chunk(S - 16);

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
    if (kEntries) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) q[j] = ent_src[static_cast<int64_t>(j) * S + t];
    } else {
      if ((t & 15) == 15) cp_async_wait<0>();
      if ((t & 3) == 3) {
#pragma unroll
        for (int j = 0; j < LPT; ++j)
          q[j] = reinterpret_cast<const uint32_t*>(stage + ((j + threadIdx.x) & (LPT - 1)))
              [(t & 15) >> 2];
      }
      // the chunk's last word was read (and used) a step ago: stage the next
      if ((t & 15) == 2 && t > 16) stage_chunk((t & ~15) - 16);
    }
    // entry of lane j's symbol t (0 past the lane's valid count), looked up
    // once and held across the step's barrier
    uint32_t e[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j)
      e[j] = kEntries ? q[j] : (t < min(max(rem - j * S, 0), S)) ? ent[(q[j] >> sh) & 255u] : 0u;
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
// K5: the HuffWord lockstep decode.  The first port's form of K3 (the canonical scan,
// loads and stores in the step) with two canonical codebooks that
// alternate by step parity: S is even and lane starts are multiples of S,
// so step parity is token parity, and step t scans codebook t & 1 (set 0 is
// the even tokens' dictionary).  The output is the token's canonical rank
// (v >> (32-len)) + off, unmasked, one u32 per token in file order; K6 maps
// ranks to token ids.  Inactive tokens write rank 0.  A codebook of an
// empty dictionary has min_len = max_len = 0 and is only ever scanned by
// inactive tokens.  It is operation-bound (the canonical scan) and
// serial in t with a block barrier per step; both codebooks sit in shared
// memory, where every lane reads the same entry (broadcast).
// ---------------------------------------------------------------------------
template <int LPT>
__global__ void __launch_bounds__(kThreads, 1) decode_dual_kernel(
    const uint32_t* __restrict__ payload, int64_t n_words,
    const int64_t* __restrict__ gstart, const int32_t* __restrict__ gcount,
    const uint32_t* __restrict__ fc_g, const uint32_t* __restrict__ off_g,
    int min0, int max0, int min1, int max1, int S, uint32_t* __restrict__ out) {
  __shared__ uint32_t fc[2][kCodeTable];
  __shared__ uint32_t offs[2][kCodeTable];
  __shared__ int warp_tot[2][kWarps];
  if (threadIdx.x < 2 * kCodeTable) {
    fc[threadIdx.x / kCodeTable][threadIdx.x % kCodeTable] = fc_g[threadIdx.x];
    offs[threadIdx.x / kCodeTable][threadIdx.x % kCodeTable] = off_g[threadIdx.x];
  }
  __syncthreads();

  constexpr int G = LPT * kThreads;
  const int g = blockIdx.x;
  const int lane_in_group = threadIdx.x * LPT;
  const int rem = lane_count(gcount[g], static_cast<int64_t>(lane_in_group) * S, LPT * S);
  uint32_t* dst = out + (static_cast<int64_t>(g) * G + lane_in_group) * S;

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
  int64_t base = gstart[g];
  int parity = 0;

  for (int t = 0; t < S; ++t) {
    const int p = t & 1;
    const int min_len = p ? min1 : min0;
    const int max_len = p ? max1 : max0;
    const uint32_t* fcp = fc[p];
    const uint32_t* offp = offs[p];
    // ---- refill: refilling lanes take sequential words in lane order
    int total;
    const int pre = block_exclusive_scan(__popc(need), warp_tot[parity], &total);
    parity ^= 1;
    int64_t idx = base + pre;
    base += total;
    uint32_t next_need = 0u;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const uint32_t phase = pq[j] & 31u;
      const uint32_t qm = pq[j] >> 8;
      if (need & (1u << j)) {
        const uint32_t w = idx < n_words ? payload[idx] : 0u;
        ++idx;
        if (phase == 0u) a[j] = w; else b[j] = w;
      }
      // ---- 32-bit window, left-justified
      const uint32_t v = phase ? ((a[j] << phase) | (b[j] >> (32u - phase))) : a[j];
      // ---- canonical length scan + fused offset select
      uint32_t ln = static_cast<uint32_t>(min_len);
      uint32_t off = offp[min_len];
      for (int l = min_len; l < max_len; ++l) {
        const bool c = v < fcp[l];
        ln += c ? 1u : 0u;
        off = c ? offp[l + 1] : off;
      }
      const bool active = t < min(max(rem - j * S, 0), S);
      if (!active) ln = 0u;
      dst[j * S + t] = active ? (v >> ((32u - ln) & 31u)) + off : 0u;
      // ---- advance
      if (phase + ln >= 32u) a[j] = b[j];
      if (qm + ln >= 32u) next_need |= 1u << j;
      pq[j] = ((phase + ln) & 31u) | (((qm + ln) & 31u) << 8);
    }
    need = next_need;
  }
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

int glz_lane_totals_entries(const void* ent, int n_groups, int S, int rows,
                            void* ctot, void* gw, void* stream) {
  const int G = rows * kLanes;
  if (n_groups <= 0 || S % 4 != 0 || G % 256 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_groups, G / 256);
  lane_totals_entries_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ent), S, G, static_cast<int32_t*>(ctot),
      static_cast<int32_t*>(gw));
  return static_cast<int>(cudaGetLastError());
}

int glz_lane_totals(const void* sym, const void* tbl, long long n_valid,
                    int n_groups, int S, int rows, void* ctot, void* gw,
                    void* stream) {
  const int G = rows * kLanes;
  if (n_groups <= 0 || S % 16 != 0 || G % 256 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_groups, G / 256);
  lane_totals_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sym), static_cast<const uint32_t*>(tbl),
      n_valid, S, G, static_cast<int32_t*>(ctot), static_cast<int32_t*>(gw));
  return static_cast<int>(cudaGetLastError());
}

// entries != 0: `sym` holds u32 lj|len entry words (K4) and tbl/n_valid are
// unused; else u8 symbols looked up in the 256-entry tbl (K2).  sym 16-byte
// aligned; S a multiple of 16.
static int encode_groups(const void* sym, const void* tbl, long long n_valid,
                         const void* ctot, const void* gw, const void* grow,
                         int n_groups, int S, int rows, void* out,
                         void* cursor_end, void* stream, bool entries) {
  if (n_groups <= 0 || S % 16 != 0 || reinterpret_cast<uintptr_t>(sym) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // K2 stages its input in dynamic shared memory
#define GLZ_ENCODE(LPT, E)                                                     \
  {                                                                            \
    const int smem = E ? 0 : static_cast<int>(encode_smem<LPT>());             \
    const cudaError_t e = cudaFuncSetAttribute(                                \
        encode_kernel<LPT, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
    if (e != cudaSuccess) return static_cast<int>(e);                          \
    encode_kernel<LPT, E><<<n_groups, kThreads, smem, st>>>(                   \
        sym, static_cast<const uint32_t*>(tbl), n_valid,                       \
        static_cast<const int32_t*>(ctot), static_cast<const int32_t*>(gw),    \
        static_cast<const int32_t*>(grow), S, static_cast<uint32_t*>(out),     \
        static_cast<int32_t*>(cursor_end));                                    \
  }
#define GLZ_ENCODE_ROWS(E)                                                     \
  switch (rows) {                                                              \
    case 8: GLZ_ENCODE(1, E); break;                                           \
    case 16: GLZ_ENCODE(2, E); break;                                          \
    case 32: GLZ_ENCODE(4, E); break;                                          \
    case 64: GLZ_ENCODE(8, E); break;                                          \
    default: return static_cast<int>(cudaErrorInvalidValue);                   \
  }
  if (entries) {
    GLZ_ENCODE_ROWS(true)
  } else {
    GLZ_ENCODE_ROWS(false)
  }
#undef GLZ_ENCODE_ROWS
#undef GLZ_ENCODE
  return static_cast<int>(cudaGetLastError());
}

int glz_encode_groups(const void* sym, const void* tbl, long long n_valid,
                      const void* ctot, const void* gw, const void* grow,
                      int n_groups, int S, int rows, void* out,
                      void* cursor_end, void* stream) {
  return encode_groups(sym, tbl, n_valid, ctot, gw, grow, n_groups, S, rows, out,
                       cursor_end, stream, false);
}

int glz_encode_entries(const void* ent, const void* ctot, const void* gw,
                       const void* grow, int n_groups, int S, int rows, void* out,
                       void* cursor_end, void* stream) {
  return encode_groups(ent, nullptr, 0, ctot, gw, grow, n_groups, S, rows, out,
                       cursor_end, stream, true);
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
// range is [0, 0] (an empty dictionary) or within [1, 32].
int glz_decode_dual(const void* payload, long long n_words, const void* gstart,
                    const void* gcount, const void* fc, const void* offsets,
                    int min0, int max0, int min1, int max1, int n_groups, int S,
                    int rows, void* out, void* stream) {
  auto bad_range = [](int lo, int hi) {
    return !((lo == 0 && hi == 0) || (1 <= lo && lo <= hi && hi <= kCodeTable - 2));
  };
  if (n_groups <= 0 || S % 2 != 0 || bad_range(min0, max0) || bad_range(min1, max1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GLZ_DECODE_DUAL(LPT)                                                   \
  decode_dual_kernel<LPT><<<n_groups, kThreads, 0, st>>>(                     \
      static_cast<const uint32_t*>(payload), n_words,                          \
      static_cast<const int64_t*>(gstart), static_cast<const int32_t*>(gcount), \
      static_cast<const uint32_t*>(fc), static_cast<const uint32_t*>(offsets), \
      min0, max0, min1, max1, S, static_cast<uint32_t*>(out))
  switch (rows) {
    case 8: GLZ_DECODE_DUAL(1); break;
    case 16: GLZ_DECODE_DUAL(2); break;
    case 32: GLZ_DECODE_DUAL(4); break;
    case 64: GLZ_DECODE_DUAL(8); break;
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
