#!/usr/bin/env python3
"""Time the phases of the lockstep encode (K2) apart on one CUDA card.

    python3 tools/k2_phases.py            # from the repository root

K2 sweeps each lane's S symbols from the last to the first; each step looks
the lanes' symbols up in the 256-entry lj|len table, takes a block scan of
the lanes that emit a word, stores those words at the group's descending
cursor and prepends each symbol's code to its lane's 64-bit window.  Every
fourth step each thread loads its lanes' next 4 symbol bytes.  This script
builds a copy of the first port's kernel (encode_kernel<8, bytes>, one
block of 1,024 threads per group, 4-byte loads at a stride of S bytes in
the step that uses them) in variants that each take one phase out, and
times each at the byte main path's shape (512 MiB under THROUGHPUT: 128
groups of 64 x 128 lanes, S 512) with CUDA events:

  base        the kernel as it was (checked against encode_groups_ref)
  no_load     each lane's 4 symbol bytes loaded once, then rotated by a
              byte every fourth step instead of loaded (the same byte
              values, so the code lengths keep the corpus's law)
  no_lookup   the entry made from the byte (lj = byte << 24, len = 1 +
              (byte & 7), 4.5 bits on average) without the shared table
  no_emit     the emitted words folded into one register, stored once
  no_scan     the block scan replaced by the warp's own prefix (no
              barrier; the cursor is wrong)

and the combinations with no_load.  The time a variant saves is what its
phase costs in the base kernel.  Then csrc/lockstep.cu's encode_kernel as
it is (`now`, checked against encode_groups_ref) and builds of it, by
editing a copy of the source, that each undo one of its changes (see
NOW_VARIANTS).
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
from glz_tpu_torch import config as cfg  # noqa: E402
from glz_tpu_torch.core.codebook import build_codebook, sampled_histogram  # noqa: E402
from glz_tpu_torch.ops import _kernels  # noqa: E402
from glz_tpu_torch.ops import lockstep_encode as ke  # noqa: E402

VARIANTS = {"base": "", "no_load": "-DK2_NO_LOAD", "no_lookup": "-DK2_NO_LOOKUP",
            "no_emit": "-DK2_NO_EMIT", "no_scan": "-DK2_NO_SCAN",
            "no_load+no_lookup": "-DK2_NO_LOAD -DK2_NO_LOOKUP",
            "no_load+no_emit": "-DK2_NO_LOAD -DK2_NO_EMIT",
            "no_load+no_scan": "-DK2_NO_LOAD -DK2_NO_SCAN",
            "no_load+no_lookup+no_emit": "-DK2_NO_LOAD -DK2_NO_LOOKUP -DK2_NO_EMIT",
            "no_load+no_lookup+no_emit+no_scan":
                "-DK2_NO_LOAD -DK2_NO_LOOKUP -DK2_NO_EMIT -DK2_NO_SCAN"}
# csrc/lockstep.cu edits that undo one change of the redesigned kernel:
# (marker, replacement) pairs, each marker found exactly once in its body.
K2_KERNEL = "__global__ void __launch_bounds__(kThreads, 1) encode_kernel("
STAGE_READ = ("        q[j] = reinterpret_cast<const uint32_t*>(stage + ((j + threadIdx.x) & "
              "(LPT - 1)))\n            [(t & 15) >> 2];")
ENTRY_ONCE = """    uint32_t e[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j)
      e[j] = (t < min(max(rem - j * S, 0), S)) ? ent[(q[j] >> sh) & 255u] : 0u;"""
NOW_VARIANTS = {
    # the input loaded in the step that uses it, as the first port did
    "no_stage": [(STAGE_READ, "        q[j] = reinterpret_cast<const uint32_t*>(byte_src + "
                              "static_cast<int64_t>(j) * S)[t >> 2];"),
                 ("  stage_chunk(S - 16);", ""),
                 ("    if ((t & 15) == 2 && t > 16) stage_chunk((t & ~15) - 16);", "")],
    # each entry looked up twice a step (before the barrier and after), as
    # the first port did to save registers
    "entry_twice": [(ENTRY_ONCE, """    auto e_at = [&](int j) -> uint32_t {
      return (t < min(max(rem - j * S, 0), S)) ? ent[(q[j] >> sh) & 255u] : 0u;
    };"""),
                    ("static_cast<int>(e[j] & kLenMask);", "static_cast<int>(e_at(j) & kLenMask);"),
                    ("      const uint32_t ln = e[j] & kLenMask;", "      const uint32_t e_j = e_at(j);\n"
                     "      const uint32_t ln = e_j & kLenMask;"),
                    ("        const uint32_t lj = e[j] & ~kLenMask;",
                     "        const uint32_t lj = e_j & ~kLenMask;")],
}

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
#ifdef K2_NO_SCAN
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

__device__ __forceinline__ int lane_count(int64_t limit, int64_t first, int S) {
  const int64_t r = limit - first;
  return r <= 0 ? 0 : (r >= S ? S : static_cast<int>(r));
}

template <int LPT>
__global__ void __launch_bounds__(kThreads, 1) encode_kernel(
    const uint8_t* __restrict__ sym, const uint32_t* __restrict__ tbl,
    int64_t n_valid, const int32_t* __restrict__ ctot,
    const int32_t* __restrict__ gw, const int32_t* __restrict__ grow, int S,
    uint32_t* __restrict__ out, int32_t* __restrict__ cursor_end) {
  __shared__ uint32_t ent[256];
  __shared__ int warp_tot[2][kWarps];
  if (threadIdx.x < 256) ent[threadIdx.x] = tbl[threadIdx.x];
  __syncthreads();

  constexpr int G = LPT * kThreads;
  const int g = blockIdx.x;
  const int64_t lane0 = static_cast<int64_t>(g) * G + threadIdx.x * LPT;
  const int64_t first = lane0 * S;
  const int rem = lane_count(n_valid, first, LPT * S);
  const int words_per_lane = S / 4;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(sym + first);

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
  uint32_t step0 = 0u;
  uint32_t fold = 0u;

  for (int t = S - 1; t >= 0; --t) {
    const int sh = 8 * (t & 3);
    if ((t & 3) == 3) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
#ifdef K2_NO_LOAD
        q[j] = t == S - 1 ? src[j * words_per_lane + (t >> 2)] : __funnelshift_l(q[j], q[j], 8);
#else
        q[j] = src[j * words_per_lane + (t >> 2)];
#endif
      }
    }
    auto entry = [&](int j) -> uint32_t {
      if (t >= min(max(rem - j * S, 0), S)) return 0u;
      const uint32_t b = (q[j] >> sh) & 255u;
#ifdef K2_NO_LOOKUP
      return (b << 24) | (1u + (b & 7u));
#else
      return ent[b];
#endif
    };
    if (t != S - 1) {
      uint32_t need = 0u;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int cp = cur[j] - static_cast<int>(entry(j) & kLenMask);
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
#ifdef K2_NO_EMIT
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
      const uint32_t e = entry(j);
      const uint32_t ln = e & kLenMask;
      if (ln > 0u) {
        const uint32_t lj = e & ~kLenMask;
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

extern "C" int k2_probe(const void* sym, const void* tbl, long long n_valid, const void* ctot,
                        const void* gw, const void* grow, int n_groups, int S, void* out,
                        void* cursor_end, void* stream) {
  encode_kernel<8><<<n_groups, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sym), static_cast<const uint32_t*>(tbl), n_valid,
      static_cast<const int32_t*>(ctot), static_cast<const int32_t*>(gw),
      static_cast<const int32_t*>(grow), S, static_cast<uint32_t*>(out),
      static_cast<int32_t*>(cursor_end));
  return static_cast<int>(cudaGetLastError());
}
"""


def _compile(tmp: pathlib.Path, texts: dict[str, tuple[str, str]], entry: str,
             kernel: str) -> dict[str, ctypes.CDLL]:
    """One library per variant (name -> (source, extra nvcc flags)), one
    nvcc each, all started together; prints each build's registers and
    spills for the kernel whose mangled name holds `kernel`."""
    procs = {}
    for name, (text, flags) in texts.items():
        path = tmp / f"{name.replace('+', '_')}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC), "-shared",
             *flags.split(), "-o", str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        summary = [line for line in chip_smoke.ptxas_summary(out + err) if kernel in line]
        print(f"build {name}: {summary[0] if summary else ''}", flush=True)
        lib = ctypes.CDLL(str(tmp / f"{name.replace('+', '_')}.so"))
        getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    arr = chip_smoke.make_corpus(chip_smoke.MAIN_BYTES)
    conf = cfg.THROUGHPUT
    cb = build_codebook(sampled_histogram(arr, conf.histogram_budget), ke.MAX_FUSED_LEN)
    inp = chip_smoke.KernelInputs(arr, arr.size, conf.stream_symbols, conf.group_rows, cb, dev)
    want = inp.k2(ke.encode_groups_ref)
    out = torch.zeros(inp.n_words, dtype=torch.int32, device=dev)
    cend = torch.empty(inp.padded.size, dtype=torch.int32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (_kernels.ptr(inp.sym), _kernels.ptr(inp.tbl), ctypes.c_longlong(inp.n_valid),
            _kernels.ptr(inp.ctot), _kernels.ptr(inp.gw), _kernels.ptr(inp.grow),
            ctypes.c_int(inp.padded.size), ctypes.c_int(inp.S))
    with tempfile.TemporaryDirectory() as tmp:
        libs = _compile(pathlib.Path(tmp), {k: (SOURCE, v) for k, v in VARIANTS.items()},
                        "k2_probe", "encode_kernel<8")

        def run(lib, entry="k2_probe", extra=()):
            rc = getattr(lib, entry)(*args, *extra, _kernels.ptr(out), _kernels.ptr(cend),
                                     stream)
            if rc:
                raise RuntimeError(f"{entry}: CUDA error {rc}")

        times = {}
        for name, lib in libs.items():
            if name == "base":
                out.zero_()
                run(lib)
                torch.cuda.synchronize()
                if not (torch.equal(out, want[0]) and torch.equal(cend, want[1])):
                    raise RuntimeError("variant base differs from encode_groups_ref")
            times[name] = chip_smoke.cuda_ms(lambda: run(lib), reps=5)
        times["base (again)"] = chip_smoke.cuda_ms(lambda: run(libs["base"]), reps=5)
        # csrc/lockstep.cu as it is, and with each of its changes undone
        src = (_kernels.CSRC / "lockstep.cu").read_text()
        texts = {"now": (src, "")}
        # the edits apply to encode_kernel's body only (K4's repeats some lines)
        start = src.index(K2_KERNEL)
        end = src.index("\n}\n", start) + 3
        for name, edits in NOW_VARIANTS.items():
            body = src[start:end]
            for marker, replacement in edits:
                if body.count(marker) != 1:
                    raise RuntimeError(f"lockstep.cu no longer has the probe's marker:\n{marker}")
                body = body.replace(marker, replacement)
            texts[name] = (src[:start] + body + src[end:], "")
        now = _compile(pathlib.Path(tmp), texts, "glz_encode_groups", "encode_kernel<8>")
        rows = ctypes.c_int(conf.group_rows)
        for lib in now.values():
            lib.glz_encode_groups.argtypes = _kernels._SIGNATURES["glz_encode_groups"]
        for name, lib in now.items():
            out.zero_()
            run(lib, "glz_encode_groups", (rows,))
            torch.cuda.synchronize()
            if name == "now" and not (torch.equal(out, want[0]) and torch.equal(cend, want[1])):
                raise RuntimeError("encode_kernel differs from encode_groups_ref")
            times[name if name == "now" else f"now: {name}"] = chip_smoke.cuda_ms(
                lambda: run(lib, "glz_encode_groups", (rows,)), reps=5)
    base = times["base"]
    for name, ms in times.items():
        print(f"k2 {name}: {ms:.3f} ms ({base - ms:+.3f} ms against base)", flush=True)
    print(f"k2 phases at 512 MiB, rows 64, S 512, codes {cb.min_len}-{cb.max_len} bits, on "
          f"{torch.cuda.get_device_name(0)} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
