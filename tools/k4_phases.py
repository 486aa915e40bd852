#!/usr/bin/env python3
"""Time the phases of the HuffWord lockstep encode (K4) apart on one CUDA card.

    python3 tools/k4_phases.py            # from the repository root
    python3 tools/k4_phases.py --now      # csrc/lockstep.cu's kernel and the one-block geometry only

K4 sweeps each lane's S entry words (u32 lj|len) from the last to the
first; each step takes the group's count of the lanes that emit a word,
stores those words at the group's descending cursor and prepends each
entry's code to its lane's 64-bit window.  This script builds a copy of
the first port's kernel (encode_kernel<4, entries>: one block of 1,024
threads per group, 4 lanes a thread, each entry loaded at a stride of 4S
bytes in the step that uses it, a block scan every step) in variants that
each take one phase out, and times each at the HuffWord main path's shape
(100 MiB of word text, S 512, rows 32: 24 groups of 32 x 128 lanes, the
entry words gathered as the path gathers them) with CUDA events:

  base        the kernel as it was (checked against encode_entries_ref)
  no_load     each lane's last 4 entries loaded once and cycled through
              (the same entries, so the code lengths keep the text's law)
  no_emit     the emitted words folded into one register, stored once
  no_scan     the block scan replaced by the warp's own prefix (no
              barrier; the cursor is wrong)

and the combinations with no_load.  The time a variant saves is what its
phase costs in the base kernel.

Then the kernel of csrc/lockstep.cu as it is (`now`: a cluster of rows/8
blocks a group, one lane a thread), the same source with rounds of 8
steps instead of 16 (`round8`, twice the exchanges, at rows 32), and the
other geometry (`one_block`: one block of 1,024 threads a group, rows/8
lanes a thread), a kernel of this script's own that sweeps in the same
rounds, at rows 16, 32 and 64 (the same text, S 512), each checked
against encode_entries_ref.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from glz_tpu_torch.ops import _kernels  # noqa: E402
from glz_tpu_torch.ops import lockstep_encode as ke  # noqa: E402
from glz_tpu_torch.utils import tokenizer as tok  # noqa: E402

VARIANTS = {"base": "", "no_load": "-DK4_NO_LOAD", "no_emit": "-DK4_NO_EMIT",
            "no_scan": "-DK4_NO_SCAN",
            "no_load+no_emit": "-DK4_NO_LOAD -DK4_NO_EMIT",
            "no_load+no_scan": "-DK4_NO_LOAD -DK4_NO_SCAN",
            "no_load+no_emit+no_scan": "-DK4_NO_LOAD -DK4_NO_EMIT -DK4_NO_SCAN"}
S, ROWS = 512, 32  # the HuffWord main path's geometry
GEOMETRY_ROWS = (16, 32, 64)  # where now and one_block are timed
# rounds of 8 steps (twice the exchanges)
ROUND = "constexpr int kEntRound = 16;"
ROUND8 = "constexpr int kEntRound = 8;"

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int kThreads = 1024;
constexpr int kWarps = 32;
constexpr int kLanes = 128;
constexpr uint32_t kLenMask = 63;

__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
#ifdef K4_NO_SCAN
  *total = __shfl_sync(0xffffffffu, inc, 31) * kWarps;
  return inc - x;
#else
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
#endif
}

template <int LPT>
__global__ void __launch_bounds__(kThreads, 1) encode_kernel(
    const uint32_t* __restrict__ ent, const int32_t* __restrict__ ctot,
    const int32_t* __restrict__ gw, const int32_t* __restrict__ grow, int S,
    uint32_t* __restrict__ out, int32_t* __restrict__ cursor_end) {
  __shared__ int warp_tot[2][kWarps];
  constexpr int G = LPT * kThreads;
  const int g = blockIdx.x;
  const int64_t lane0 = static_cast<int64_t>(g) * G + threadIdx.x * LPT;
  const uint32_t* src = ent + lane0 * S;

  uint32_t w0[LPT], w1[LPT], q[LPT];
  int cur[LPT];
#ifdef K4_NO_LOAD
  uint4 stash[LPT];
#endif
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    w0[j] = 0u;
    w1[j] = 0u;
    q[j] = 0u;
    cur[j] = ctot[lane0 + j];
#ifdef K4_NO_LOAD
    stash[j] = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(j) * S + S - 4);
#endif
  }
  const int gwords = gw[g];
  int cursor = gwords;
  uint32_t* dst = out + static_cast<int64_t>(grow[g]) * kLanes;
  int parity = 0;
  uint32_t step0 = 0u;
  uint32_t fold = 0u;

  for (int t = S - 1; t >= 0; --t) {
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
#ifdef K4_NO_LOAD
      const int k = t & 3;
      q[j] = k == 0 ? stash[j].x : k == 1 ? stash[j].y : k == 2 ? stash[j].z : stash[j].w;
#else
      q[j] = src[static_cast<int64_t>(j) * S + t];
#endif
    }
    if (t != S - 1) {
      uint32_t need = 0u;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int cp = cur[j] - static_cast<int>(q[j] & kLenMask);
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
#ifdef K4_NO_EMIT
          fold ^= word + static_cast<uint32_t>(pos);
#else
          if (pos < gwords) dst[pos] = word;
#endif
          ++pos;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const uint32_t ln = q[j] & kLenMask;
      if (ln > 0u) {
        const uint32_t lj = q[j] & ~kLenMask;
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
  if (fold == 0x9E3779B9u) dst[0] = fold;
  if (threadIdx.x == 0) cursor_end[g] = cursor;
}
}  // namespace

extern "C" int k4_probe(const void* ent, const void* ctot, const void* gw, const void* grow,
                        int n_groups, int S, void* out, void* cursor_end, void* stream) {
  encode_kernel<4><<<n_groups, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ent), static_cast<const int32_t*>(ctot),
      static_cast<const int32_t*>(gw), static_cast<const int32_t*>(grow), S,
      static_cast<uint32_t*>(out), static_cast<int32_t*>(cursor_end));
  return static_cast<int>(cudaGetLastError());
}
"""


# The losing geometry: one block of 1,024 threads a group, LPT = rows/8
# lanes a thread, in csrc/lockstep.cu's rounds (a lengths-only pass, one
# block scan a round, a second pass that writes).  Two rounds of staged
# entries a block (one at LPT 8, where two would not fit).  Its entry has
# glz_encode_entries' name and arguments.
ONE_BLOCK_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int kThreads = 1024;
constexpr int kWarps = 32;
constexpr int kLanes = 128;
constexpr uint32_t kLenMask = 63;

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

template <int LPT>
__host__ __device__ constexpr int entries_round() {
  return LPT >= 8 ? 4 : 16 / LPT;
}

template <int LPT>
__host__ __device__ constexpr int entries_buffers() {
  return LPT >= 8 ? 1 : 2;
}

template <int LPT>
constexpr size_t entries_smem() {
  return sizeof(uint4) * entries_buffers<LPT>() * (entries_round<LPT>() / 4) * LPT * kThreads;
}

__device__ __forceinline__ uint32_t chunk_entry(const uint4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

// The set bits of `need` over the warp's threads before this one.
__device__ __forceinline__ int warp_rank(uint32_t need) {
  const int lane = threadIdx.x & 31;
  const int x = __popc(need);
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  return inc - x;
}

template <int LPT>
__global__ void __launch_bounds__(kThreads, 1) encode_entries_kernel(
    const uint32_t* __restrict__ ent, const int32_t* __restrict__ ctot,
    const int32_t* __restrict__ gw, const int32_t* __restrict__ grow, int S,
    uint32_t* __restrict__ out, int32_t* __restrict__ cursor_end) {
  constexpr int W = entries_round<LPT>();
  constexpr int kChunks = W / 4;
  constexpr int kBufs = entries_buffers<LPT>();
  extern __shared__ uint4 enc_smem[];  // [kBufs][kChunks][LPT][kThreads]
  __shared__ int cnt[W][kWarps];
  __shared__ int xch[2][W];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int G = LPT * kThreads;
  const int g = blockIdx.x;
  const int64_t lane0 = static_cast<int64_t>(g) * G + static_cast<int>(threadIdx.x) * LPT;
  const uint32_t* src = ent + lane0 * S;
  auto stage_round = [&](int b, int t_lo) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        cp_async16(enc_smem + ((b * kChunks + c) * LPT + j) * kThreads + threadIdx.x,
                   src + static_cast<int64_t>(j) * S + t_lo + 4 * c);
    cp_async_commit();
  };
  stage_round(0, S - W);

  uint32_t w0[LPT], w1[LPT];
  int cur[LPT], cur_a[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    w0[j] = 0u;
    w1[j] = 0u;
    cur[j] = cur_a[j] = ctot[lane0 + j];
  }
  const int gwords = gw[g];
  int cursor = gwords;
  uint32_t* dst = out + static_cast<int64_t>(grow[g]) * kLanes;

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
      if (lane == 31) xch[par][warp] = inc;
    }
    __syncthreads();
    int cum = lane < steps ? xch[par][lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, cum, o);
      if (lane >= o) cum += y;
    }
    const int base = max(cursor - cum, 0);
    cursor -= __shfl_sync(0xffffffffu, cum, 31);
    return base;
  };

  const int rounds = S / W;
  uint32_t step0 = 0u;
  for (int k = 0; k < rounds; ++k) {
    const int t_lo = S - (k + 1) * W;
    const int b = kBufs == 2 ? (k & 1) : 0;
    if constexpr (kBufs == 1) {
      if (k > 0) {
        __syncthreads();
        stage_round(0, t_lo);
      }
    }
    cp_async_wait<0>();
    const uint4* stage = enc_smem + b * kChunks * LPT * kThreads + threadIdx.x;
    uint4 q[LPT];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int p = W - 1 - i;
      if ((p & 3) == 3) {
#pragma unroll
        for (int j = 0; j < LPT; ++j) q[j] = stage[((p >> 2) * LPT + j) * kThreads];
      }
      uint32_t need = 0u;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int cp = cur_a[j] - static_cast<int>(chunk_entry(q[j], p & 3) & kLenMask);
        if (((cur_a[j] + 31) >> 5) > ((cp + 31) >> 5)) need |= 1u << j;
        cur_a[j] = cp;
      }
      if (k == 0 && i == 0) need = 0u;
      const int n = __reduce_add_sync(0xffffffffu, __popc(need));
      if (lane == 0) cnt[i][warp] = n;
    }
    __syncthreads();
    if constexpr (kBufs == 2) {
      if (k + 1 < rounds) stage_round(b ^ 1, t_lo - W);
    }
    const int base = exchange(W, k & 1);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int p = W - 1 - i;
      if ((p & 3) == 3) {
#pragma unroll
        for (int j = 0; j < LPT; ++j) q[j] = stage[((p >> 2) * LPT + j) * kThreads];
      }
      uint32_t e[LPT];
      uint32_t need = 0u;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        e[j] = chunk_entry(q[j], p & 3);
        const int cp = cur[j] - static_cast<int>(e[j] & kLenMask);
        if (((cur[j] + 31) >> 5) > ((cp + 31) >> 5)) need |= 1u << j;
      }
      if (k == 0 && i == 0) need = 0u;
      int pos = __shfl_sync(0xffffffffu, base, i) + cnt[i][warp] + warp_rank(need);
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        if (need & (1u << j)) {
          const uint32_t d = (32u - (static_cast<uint32_t>(cur[j]) & 31u)) & 31u;
          const uint32_t word = d ? ((w0[j] << d) | (w1[j] >> (32u - d))) : w0[j];
          if (pos < gwords) dst[pos] = word;
          ++pos;
        }
      }
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
        if (p == 0 && t_lo == 0 && ln > 0u) step0 |= 1u << j;
      }
    }
  }
  const int n0 = __reduce_add_sync(0xffffffffu, __popc(step0));
  if (lane == 0) cnt[0][warp] = n0;
  __syncthreads();
  const int base0 = exchange(1, rounds & 1);
  int pos = __shfl_sync(0xffffffffu, base0, 0) + cnt[0][warp] + warp_rank(step0);
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    if (step0 & (1u << j)) {
      if (pos < gwords) dst[pos] = w0[j];
      ++pos;
    }
  }
  if (threadIdx.x == 0) cursor_end[g] = cursor;
}

template <int LPT>
int launch(const void* ent, const void* ctot, const void* gw, const void* grow, int n_groups,
           int S, void* out, void* cursor_end, cudaStream_t st) {
  const int smem = static_cast<int>(entries_smem<LPT>());
  const cudaError_t e = cudaFuncSetAttribute(
      encode_entries_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  encode_entries_kernel<LPT><<<n_groups, kThreads, smem, st>>>(
      static_cast<const uint32_t*>(ent), static_cast<const int32_t*>(ctot),
      static_cast<const int32_t*>(gw), static_cast<const int32_t*>(grow), S,
      static_cast<uint32_t*>(out), static_cast<int32_t*>(cursor_end));
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" int glz_encode_entries(const void* ent, const void* ctot, const void* gw,
                                  const void* grow, int n_groups, int S, int rows, void* out,
                                  void* cursor_end, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 16: return launch<2>(ent, ctot, gw, grow, n_groups, S, out, cursor_end, st);
    case 32: return launch<4>(ent, ctot, gw, grow, n_groups, S, out, cursor_end, st);
    case 64: return launch<8>(ent, ctot, gw, grow, n_groups, S, out, cursor_end, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
"""


def _compile(tmp: pathlib.Path, name: str, text: str, flags: str = ""):
    """(nvcc process, library path) of one build of `text`."""
    stem = name.replace("+", "_")
    path = tmp / f"{stem}.cu"
    path.write_text(text)
    so = tmp / f"{stem}.so"
    return subprocess.Popen(
        [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC), "-shared",
         *flags.split(), "-o", str(so), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so


def _load(procs: dict, fn: str, argtypes, kernel: str) -> dict:
    """Wait for the builds, print each one's registers and spills for the
    kernels whose names start with `kernel`, and load the libraries."""
    libs = {}
    for name, (proc, so) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        summary = [line for line in chip_smoke.ptxas_summary(out + err)
                   if line.startswith(kernel)]
        print(f"build {name}: {'; '.join(summary)}", flush=True)
        lib = ctypes.CDLL(str(so))
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def build_first(tmp: pathlib.Path) -> dict[str, ctypes.CDLL]:
    """One library per variant of the first port's kernel, one nvcc each,
    all started together."""
    procs = {name: _compile(tmp, f"probe_{name}", SOURCE, flag)
             for name, flag in VARIANTS.items()}
    return _load(procs, "k4_probe", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p] * 3, "encode_kernel")


def build_now(tmp: pathlib.Path) -> dict[str, ctypes.CDLL]:
    """csrc/lockstep.cu as it is and with rounds of 8 steps, and this
    script's one-block kernel, one library each (glz_encode_entries only is
    called)."""
    src = (_kernels.CSRC / "lockstep.cu").read_text()
    if src.count(ROUND) != 1:
        raise RuntimeError(f"lockstep.cu no longer has the probe's marker:\n{ROUND}")
    texts = {"now": src, "one_block": ONE_BLOCK_SOURCE, "round8": src.replace(ROUND, ROUND8)}
    procs = {name: _compile(tmp, name, text) for name, text in texts.items()}
    return _load(procs, "glz_encode_entries", _kernels._SIGNATURES["glz_encode_entries"],
                 "encode_entries_kernel")


class Timer:
    """Records and prints each variant's time against a named reference."""

    def __init__(self):
        self.times: dict[str, float] = {}

    def record(self, name: str, ms: float, against: str) -> None:
        self.times[name] = ms
        diff = (f" ({self.times[against] - ms:+.3f} ms against {against})"
                if against in self.times and against != name else "")
        print(f"k4 {name}: {ms:.3f} ms{diff}", flush=True)


def first_port(inp, tmp: pathlib.Path, timer: Timer) -> None:
    """The first port's kernel and its variants at the main shape."""
    want_pay, want_end = inp.encode(ke.encode_entries_ref)
    out = torch.zeros(inp.n_words, dtype=torch.int32, device=inp.ent.device)
    cend = torch.empty(inp.padded.size, dtype=torch.int32, device=inp.ent.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    libs = build_first(tmp)

    def run(lib):
        rc = lib.k4_probe(_kernels.ptr(inp.ent), _kernels.ptr(inp.ctot), _kernels.ptr(inp.gw),
                          _kernels.ptr(inp.grow), inp.padded.size, S, _kernels.ptr(out),
                          _kernels.ptr(cend), stream)
        if rc:
            raise RuntimeError(f"k4_probe: CUDA error {rc}")

    for name, lib in libs.items():
        if name == "base":
            out.zero_()
            run(lib)
            torch.cuda.synchronize()
            if not (torch.equal(out, want_pay) and torch.equal(cend, want_end)):
                raise RuntimeError("variant base differs from encode_entries_ref")
        timer.record(name, chip_smoke.cuda_ms(lambda: run(lib), reps=5), "base")
    timer.record("base (again)", chip_smoke.cuda_ms(lambda: run(libs["base"]), reps=5), "base")


def now(text: bytes, vocabs, inp, tmp: pathlib.Path, timer: Timer) -> None:
    """csrc/lockstep.cu's K4 and the one-block geometry at rows 16, 32 and
    64, and K4 in rounds of 8 steps at rows 32."""
    dev = inp.ent.device
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    libs = build_now(tmp)
    for rows in GEOMETRY_ROWS:
        r_inp = inp if rows == ROWS else chip_smoke.HuffwordInputs(text, S, rows, dev,
                                                                   vocabs=vocabs)
        want_pay, want_end = r_inp.encode(ke.encode_entries_ref)
        out = torch.zeros(r_inp.n_words, dtype=torch.int32, device=dev)
        cend = torch.empty(r_inp.padded.size, dtype=torch.int32, device=dev)
        for name, lib in libs.items():
            if name == "round8" and rows != ROWS:
                continue

            def run(lib=lib, r_inp=r_inp, out=out, cend=cend, rows=rows):
                rc = lib.glz_encode_entries(
                    _kernels.ptr(r_inp.ent), _kernels.ptr(r_inp.ctot), _kernels.ptr(r_inp.gw),
                    _kernels.ptr(r_inp.grow), r_inp.padded.size, S, rows, _kernels.ptr(out),
                    _kernels.ptr(cend), stream)
                if rc:
                    raise RuntimeError(f"glz_encode_entries: CUDA error {rc}")

            out.zero_()
            run()
            torch.cuda.synchronize()
            if not (torch.equal(out, want_pay) and torch.equal(cend, want_end)):
                raise RuntimeError(f"encode_entries_kernel ({name}, rows {rows}) differs "
                                   f"from encode_entries_ref")
            label = f"rows {rows} ({r_inp.padded.size} groups)"
            timer.record(f"now: {name}, {label}", chip_smoke.cuda_ms(run, reps=5),
                         f"now: now, {label}")
        del r_inp, out, cend, want_pay, want_end


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_phases: no CUDA device", file=sys.stderr)
        return 2
    now_only = "--now" in sys.argv[1:]
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    text = chip_smoke.make_word_corpus(chip_smoke.HUFFWORD_BYTES)
    vocabs = tok.build_vocabs(text)
    inp = chip_smoke.HuffwordInputs(text, S, ROWS, dev, vocabs=vocabs)
    timer = Timer()
    with tempfile.TemporaryDirectory() as tmp:
        if not now_only:
            first_port(inp, pathlib.Path(tmp), timer)
        now(text, vocabs, inp, pathlib.Path(tmp), timer)
    print(f"k4 phases at 100 MiB of word text, rows {ROWS}, S {S}, {inp.T} tokens, "
          f"{inp.n_words} payload words, on {torch.cuda.get_device_name(0)} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
