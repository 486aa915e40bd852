#!/usr/bin/env python3
"""Time the phases of the lockstep decode (K3) apart on one CUDA card.

    python3 tools/k3_phases.py            # from the repository root

K3 runs S steps per group; each step is a block scan of the lanes' refill
flags, a refill load per refilling lane, the decode of one code per lane
and, every fourth step, one output store per lane.  This script builds a
copy of the first port's one-block-per-group kernel (the canonical scan from
min_len, payload loads in the step that uses them, 4-byte stores at a
stride of S bytes) in variants that each take one phase out, and times
each at the byte main path's shape (512 MiB under THROUGHPUT: 128 groups
of 64 x 128 lanes, S 512) with CUDA events:

  base        the kernel as it was
  table       the scan replaced by one probe of the shared decode table
              (ops/decode_table.py; the output is unchanged)
  no_load     the refill word made from its index instead of loaded
              (random bits decode to the codebook's length law, so lanes
              refill at about the same rate)
  no_store    the outputs folded into one register, stored once
  no_scan     the block scan replaced by the thread's own prefix (no
              barrier; refill indices are wrong)

and the combinations of no_store with the others, which show what the
rest of the step costs once the stores are gone.

base and table are checked bit-exact against decode_groups_ref.  The time
a variant saves is what its phase costs in the base kernel.

Then the kernel of csrc/lockstep.cu as it is, and builds of it (by editing
a copy of the source) that each undo one of its changes:

  now         decode_kernel as it is (checked against decode_groups_ref)
  no_ring     refill words loaded from the payload in the step, no ring
  no_stage    4-byte stores at a stride of S, as the first port stored
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
from glz_tpu_torch.ops import _kernels, decode_table  # noqa: E402
from glz_tpu_torch.ops import lockstep_decode as kd  # noqa: E402
from glz_tpu_torch.ops import lockstep_encode as ke  # noqa: E402

RING = ("        const uint32_t w = idx < avail ? ring[idx & (kRingWords - 1)]\n"
        "                                       : (idx < n_words ? payload[idx] : 0u);")
STAGE = ("        stage[((j + threadIdx.x) & (LPT - 1)) * 4 + ((((t >> 2) & 3) + rot) & 3u)] = "
         "acc[j];")
FLUSH = ("        *reinterpret_cast<uint4*>(dst + j * S + t - (kStageSteps - 1)) =\n"
         "            make_uint4(o[0], o[1], o[2], o[3]);")
VARIANTS = {"base": "", "table": "-DK3_TABLE", "no_load": "-DK3_NO_LOAD",
            "no_store": "-DK3_NO_STORE", "no_scan": "-DK3_NO_BLOCK_SCAN",
            # what is left once the stores are gone
            "no_store+table": "-DK3_NO_STORE -DK3_TABLE",
            "no_store+no_load": "-DK3_NO_STORE -DK3_NO_LOAD",
            "no_store+table+no_load": "-DK3_NO_STORE -DK3_TABLE -DK3_NO_LOAD",
            "no_store+table+no_load+no_scan":
                "-DK3_NO_STORE -DK3_TABLE -DK3_NO_LOAD -DK3_NO_BLOCK_SCAN"}
TABLE_BITS = 11

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int kThreads = 1024;
constexpr int kWarps = 32;
constexpr int kCodeTable = 34;

__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
#ifdef K3_NO_BLOCK_SCAN
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
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(
    const uint32_t* __restrict__ payload, int64_t n_words,
    const int64_t* __restrict__ gstart, const int32_t* __restrict__ gcount,
    const uint32_t* __restrict__ fc_g, const uint32_t* __restrict__ off_g,
    const uint32_t* __restrict__ symtab_g, const uint32_t* __restrict__ lut_g, int tb,
    int min_len, int max_len, int S, uint8_t* __restrict__ out) {
  __shared__ uint32_t fc[kCodeTable];
  __shared__ uint32_t offs[kCodeTable];
  __shared__ uint32_t symtab[256];
  __shared__ uint16_t lut[1 << 12];
  __shared__ int warp_tot[2][kWarps];
  if (threadIdx.x < 256) symtab[threadIdx.x] = symtab_g[threadIdx.x];
  if (threadIdx.x < kCodeTable) {
    fc[threadIdx.x] = fc_g[threadIdx.x];
    offs[threadIdx.x] = off_g[threadIdx.x];
  }
  for (int i = threadIdx.x; i < (1 << tb); i += kThreads) {
    const uint32_t e = lut_g[i];
    lut[i] = e == 0u ? min_len : ((e & 0xFFFFu) == 0xFFFFu ? tb + 1 : ((e >> 16) << 8) | (e & 255u));
  }
  __syncthreads();

  constexpr int G = LPT * kThreads;
  const int g = blockIdx.x;
  const int lane_in_group = threadIdx.x * LPT;
  const int rem = lane_count(gcount[g], static_cast<int64_t>(lane_in_group) * S, LPT * S);
  const int64_t first = (static_cast<int64_t>(g) * G + lane_in_group) * S;
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + first);
  const int words_per_lane = S / 4;

  uint32_t a[LPT], b[LPT], acc[LPT], pq[LPT];
  uint32_t need = 0u, fold = 0u;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    a[j] = 0u; b[j] = 0u; acc[j] = 0u;
    pq[j] = 31u << 8;
    if (min(max(rem - j * S, 0), S) > 0) need |= 1u << j;
  }
  int64_t base = gstart[g];
  int parity = 0;

  for (int t = 0; t < S; ++t) {
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
#ifdef K3_NO_LOAD
        const uint32_t w = static_cast<uint32_t>(idx) * 0x9E3779B1u ^ static_cast<uint32_t>(idx >> 13);
#else
        const uint32_t w = idx < n_words ? payload[idx] : 0u;
#endif
        ++idx;
        if (phase == 0u) a[j] = w; else b[j] = w;
      }
      const uint32_t v = phase ? ((a[j] << phase) | (b[j] >> (32u - phase))) : a[j];
      uint32_t ln, s;
#ifdef K3_TABLE
      const uint32_t e = lut[v >> (32 - tb)];
      if (e >> 8) {
        ln = e >> 8;
        s = e & 255u;
      } else {
        ln = e;
        uint32_t off = offs[ln];
        for (int l = static_cast<int>(e); l < max_len; ++l) {
          const bool c = v < fc[l];
          ln += c ? 1u : 0u;
          off = c ? offs[l + 1] : off;
        }
        s = symtab[((v >> ((32u - ln) & 31u)) + off) & 255u];
      }
#else
      ln = static_cast<uint32_t>(min_len);
      uint32_t off = offs[min_len];
      for (int l = min_len; l < max_len; ++l) {
        const bool c = v < fc[l];
        ln += c ? 1u : 0u;
        off = c ? offs[l + 1] : off;
      }
      s = symtab[((v >> ((32u - ln) & 31u)) + off) & 255u];
#endif
      const bool active = t < min(max(rem - j * S, 0), S);
      if (!active) { ln = 0u; s = 0u; }
      acc[j] |= s << (8 * (t & 3));
      if ((t & 3) == 3) {
#ifdef K3_NO_STORE
        fold ^= acc[j];
#else
        dst[j * words_per_lane + (t >> 2)] = acc[j];
#endif
        acc[j] = 0u;
      }
      if (phase + ln >= 32u) a[j] = b[j];
      if (qm + ln >= 32u) next_need |= 1u << j;
      pq[j] = ((phase + ln) & 31u) | (((qm + ln) & 31u) << 8);
    }
    need = next_need;
  }
#ifdef K3_NO_STORE
  dst[0] = fold;
#endif
}
}  // namespace

extern "C" int k3_probe(const void* payload, long long n_words, const void* gstart,
                        const void* gcount, const void* fc, const void* offsets,
                        const void* symtab, const void* lut, int tb, int min_len,
                        int max_len, int n_groups, int S, void* out, void* stream) {
  decode_kernel<8><<<n_groups, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(payload), n_words, static_cast<const int64_t*>(gstart),
      static_cast<const int32_t*>(gcount), static_cast<const uint32_t*>(fc),
      static_cast<const uint32_t*>(offsets), static_cast<const uint32_t*>(symtab),
      static_cast<const uint32_t*>(lut), tb, min_len, max_len, S, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


def build(tmp: pathlib.Path) -> dict[str, ctypes.CDLL]:
    """One library per variant, one nvcc each, all started together."""
    src = tmp / "k3_probe.cu"
    src.write_text(SOURCE)
    procs = {name: subprocess.Popen(
        [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-shared", *flag.split(),
         "-o", str(tmp / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, flag in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        regs = [line.strip() for line in (out + err).splitlines() if "registers" in line]
        print(f"build {name}: {regs[-1] if regs else ''}", flush=True)
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        lib.k3_probe.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        lib.k3_probe.restype = ctypes.c_int
        libs[name] = lib
    return libs


def build_now(tmp: pathlib.Path) -> dict[str, ctypes.CDLL]:
    """csrc/lockstep.cu as it is and with one change undone, one library
    each (glz_decode_groups only is called)."""
    src = (_kernels.CSRC / "lockstep.cu").read_text()
    for marker in (RING, STAGE, FLUSH):
        if src.count(marker) != 1:
            raise RuntimeError(f"lockstep.cu no longer has the probe's marker:\n{marker}")
    texts = {"now": src,
             "no_ring": src.replace(RING, "        const uint32_t w = idx < n_words ? "
                                          "payload[idx] : 0u;"),
             "no_stage": src.replace(STAGE, "        *reinterpret_cast<uint32_t*>(dst + j * S + "
                                            "(t & ~3)) = acc[j];").replace(FLUSH, "        (void)o;")}
    procs = {}
    for name, text in texts.items():
        path = tmp / f"{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC), "-shared",
             "-o", str(tmp / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        lines = (out + err).splitlines()
        at = [i for i, line in enumerate(lines) if "decode_kernelILi8E" in line]
        regs = [line.strip() for line in lines[at[0]:] if "registers" in line][:1] if at else []
        print(f"build {name}: {regs[0] if regs else ''}", flush=True)
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        lib.glz_decode_groups.argtypes = _kernels._SIGNATURES["glz_decode_groups"]
        lib.glz_decode_groups.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    arr = chip_smoke.make_corpus(chip_smoke.MAIN_BYTES)
    conf = cfg.THROUGHPUT
    cb = build_codebook(sampled_histogram(arr, conf.histogram_budget), ke.MAX_FUSED_LEN)
    inp = chip_smoke.KernelInputs(arr, arr.size, conf.stream_symbols, conf.group_rows, cb, dev)
    payload = inp.k2(ke.encode_groups_ref)[0]
    want = inp.k3(kd.decode_groups_ref, payload)
    fc, offs, symtab = inp.tables
    lut = decode_table.decode_lut(fc, offs, symtab, cb.min_len, cb.max_len, TABLE_BITS)
    out = torch.empty_like(want)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))

        def run(lib):
            rc = lib.k3_probe(
                _kernels.ptr(payload), payload.numel(), _kernels.ptr(inp.starts),
                _kernels.ptr(inp.counts), _kernels.ptr(fc), _kernels.ptr(offs),
                _kernels.ptr(symtab), _kernels.ptr(lut), TABLE_BITS, cb.min_len, cb.max_len,
                inp.padded.size, inp.S, _kernels.ptr(out), stream)
            if rc:
                raise RuntimeError(f"k3_probe: CUDA error {rc}")

        times = {}
        for name, lib in libs.items():
            if name in ("base", "table"):
                out.zero_()
                run(lib)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"variant {name} differs from decode_groups_ref")
            times[name] = chip_smoke.cuda_ms(lambda: run(lib), reps=5)
        # the base again, last, to show the spread within the call
        times["base (again)"] = chip_smoke.cuda_ms(lambda: run(libs["base"]), reps=5)
        now = build_now(pathlib.Path(tmp))

        def run_now(lib):
            rc = lib.glz_decode_groups(
                _kernels.ptr(payload), payload.numel(), _kernels.ptr(inp.starts),
                _kernels.ptr(inp.counts), kd.TABLE_BITS, _kernels.ptr(fc), _kernels.ptr(offs),
                _kernels.ptr(symtab), cb.min_len, cb.max_len, inp.padded.size, inp.S,
                conf.group_rows, _kernels.ptr(out), stream)
            if rc:
                raise RuntimeError(f"glz_decode_groups: CUDA error {rc}")

        out.zero_()
        run_now(now["now"])
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise RuntimeError("decode_kernel differs from decode_groups_ref")
        for name, lib in now.items():
            times[f"now: {name}"] = chip_smoke.cuda_ms(lambda: run_now(lib), reps=5)
    base = times["base"]
    for name, ms in times.items():
        print(f"k3 {name}: {ms:.3f} ms ({base - ms:+.3f} ms against base)", flush=True)
    print(f"k3 phases at 512 MiB, rows 64, S 512, codes {cb.min_len}-{cb.max_len} bits, "
          f"table_bits {TABLE_BITS}, on {torch.cuda.get_device_name(0)} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
