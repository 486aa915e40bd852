#!/usr/bin/env python3
"""Time the phases of the HuffWord lockstep decode (K5) apart on one CUDA card.

    python3 tools/k5_phases.py            # from the repository root
    python3 tools/k5_phases.py --now      # the kernel of csrc/lockstep.cu only

K5 runs S steps per group; each step is a block scan of the lanes' refill
flags, a refill load per refilling lane, the decode of one token per lane
under the codebook of the step's parity, and one 4-byte rank store per
lane.  This script builds a copy of the first port's one-block-per-group
kernel (the canonical scan from min_len, payload loads in the step that
uses them, 4-byte stores at a stride of 4S bytes) in variants that each
take one phase out, and times each at the HuffWord main path's shape (100
MiB of word text, S 512, rows 32: 24 groups of 32 x 128 lanes) with CUDA
events:

  base        the kernel as it was
  table       the scan replaced by one probe of the dual decode tables
              (csrc/decode_table.cuh; the output is unchanged)
  no_load     the refill word made from its index instead of loaded
              (random bits decode to the codebooks' length law, so lanes
              refill at about the same rate)
  no_store    the ranks folded into one register, stored once
  no_scan     the block scan replaced by the thread's own prefix (no
              barrier; refill indices are wrong)

and the combinations of no_store with the others, which show what the
rest of the step costs once the stores are gone.  base and table are
checked bit-exact against decode_groups_dual_ref.  The time a variant
saves is what its phase costs in the base kernel.

Then the kernel of csrc/lockstep.cu as it is, and builds of it (each by
editing a copy of the source) that each undo one of its changes:

  now         decode_dual_kernel as it is, in the geometry its entry
              launches at each rows
  one_block   one block of 1,024 threads a group, rows/8 lanes a thread,
              as K3 runs
  cluster     a cluster of rows/8 blocks a group, one lane a thread
  no_ring     refill words loaded from the payload in the step, no ring
  no_stage    4-byte rank stores at a stride of 4S bytes, as the first port
  stage4      4 steps staged (16 bytes a lane) instead of 8
  no_cluster_sync
              each block of a cluster takes its own refill count for every
              block's, behind a block barrier, instead of exchanging counts
              and waiting for the cluster (refill indices are wrong, but
              advance at the true rate): what the exchange costs

each at rows 32, and the first three also at rows 16 and 64 (the same
text, S 512); all but no_cluster_sync checked against the plain version.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from glz_tpu_torch.ops import _kernels  # noqa: E402
from glz_tpu_torch.ops import lockstep_decode as kd  # noqa: E402
from glz_tpu_torch.utils import tokenizer as tok  # noqa: E402

VARIANTS = {"base": "", "table": "-DK5_TABLE", "no_load": "-DK5_NO_LOAD",
            "no_store": "-DK5_NO_STORE", "no_scan": "-DK5_NO_BLOCK_SCAN",
            # what is left once the stores are gone
            "no_store+table": "-DK5_NO_STORE -DK5_TABLE",
            "no_store+no_load": "-DK5_NO_STORE -DK5_NO_LOAD",
            "no_store+table+no_load": "-DK5_NO_STORE -DK5_TABLE -DK5_NO_LOAD",
            "no_store+table+no_load+no_scan":
                "-DK5_NO_STORE -DK5_TABLE -DK5_NO_LOAD -DK5_NO_BLOCK_SCAN"}
TABLE_BITS = 12
S, ROWS = 512, 32  # the HuffWord main path's geometry
GEOMETRY_ROWS = (16, 32, 64)  # where now, one_block and cluster are timed

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

#include "decode_table.cuh"

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
#ifdef K5_NO_BLOCK_SCAN
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
__global__ void __launch_bounds__(kThreads, 1) decode_dual_kernel(
    const uint32_t* __restrict__ payload, int64_t n_words,
    const int64_t* __restrict__ gstart, const int32_t* __restrict__ gcount,
    const uint32_t* __restrict__ fc_g, const uint32_t* __restrict__ off_g,
    int min0, int max0, int min1, int max1, int tb, int S, uint32_t* __restrict__ out) {
  __shared__ uint32_t fc[2][kCodeTable];
  __shared__ uint32_t offs[2][kCodeTable];
  __shared__ int warp_tot[2][kWarps];
  if (threadIdx.x < 2 * kCodeTable) {
    fc[threadIdx.x / kCodeTable][threadIdx.x % kCodeTable] = fc_g[threadIdx.x];
    offs[threadIdx.x / kCodeTable][threadIdx.x % kCodeTable] = off_g[threadIdx.x];
  }
#ifdef K5_TABLE
  extern __shared__ uint8_t lut[];
  __shared__ glz::DualTable tbl;
  glz::build_dual_table(tbl, lut, tb, fc_g, off_g, min0, max0, min1, max1);
#endif
  __syncthreads();

  constexpr int G = LPT * kThreads;
  const int g = blockIdx.x;
  const int lane_in_group = threadIdx.x * LPT;
  const int rem = lane_count(gcount[g], static_cast<int64_t>(lane_in_group) * S, LPT * S);
  uint32_t* dst = out + (static_cast<int64_t>(g) * G + lane_in_group) * S;

  uint32_t a[LPT], b[LPT], pq[LPT];
  uint32_t need = 0u, fold = 0u;
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
#ifdef K5_NO_LOAD
        const uint32_t w = static_cast<uint32_t>(idx) * 0x9E3779B1u ^ static_cast<uint32_t>(idx >> 13);
#else
        const uint32_t w = idx < n_words ? payload[idx] : 0u;
#endif
        ++idx;
        if (phase == 0u) a[j] = w; else b[j] = w;
      }
      const uint32_t v = phase ? ((a[j] << phase) | (b[j] >> (32u - phase))) : a[j];
      uint32_t ln, rank;
#ifdef K5_TABLE
      ln = glz::decode_dual(tbl, lut, v, p, &rank);
#else
      ln = static_cast<uint32_t>(min_len);
      uint32_t off = offp[min_len];
      for (int l = min_len; l < max_len; ++l) {
        const bool c = v < fcp[l];
        ln += c ? 1u : 0u;
        off = c ? offp[l + 1] : off;
      }
      rank = (v >> ((32u - ln) & 31u)) + off;
#endif
      const bool active = t < min(max(rem - j * S, 0), S);
      if (!active) ln = 0u;
#ifdef K5_NO_STORE
      fold ^= active ? rank : 0u;
#else
      dst[j * S + t] = active ? rank : 0u;
#endif
      if (phase + ln >= 32u) a[j] = b[j];
      if (qm + ln >= 32u) next_need |= 1u << j;
      pq[j] = ((phase + ln) & 31u) | (((qm + ln) & 31u) << 8);
    }
    need = next_need;
  }
#ifdef K5_NO_STORE
  dst[0] = fold;
#endif
}
}  // namespace

extern "C" int k5_probe(const void* payload, long long n_words, const void* gstart,
                        const void* gcount, const void* fc, const void* offsets, int min0,
                        int max0, int min1, int max1, int tb, int n_groups, int S, void* out,
                        void* stream) {
  size_t smem = 0;
#ifdef K5_TABLE
  smem = (size_t{1} << glz::dual_bits(tb, max0)) + (size_t{1} << glz::dual_bits(tb, max1));
#endif
  decode_dual_kernel<4><<<n_groups, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(payload), n_words, static_cast<const int64_t*>(gstart),
      static_cast<const int32_t*>(gcount), static_cast<const uint32_t*>(fc),
      static_cast<const uint32_t*>(offsets), min0, max0, min1, max1, tb, S,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""

# Markers of csrc/lockstep.cu's decode_dual_kernel that the "now" builds edit.
RING = "const uint32_t word = idx < avail ? ring[idx & (kRingWords - 1)]"
STAGE_STORE = "      stage[((t & (kStage - 1)) * LPT + j) * kThreads + threadIdx.x] = r;\n"
STAGE_FLUSH = ("    if ((t & (kStage - 1)) == kStage - 1 || t == S - 1)\n"
               "      flush_ranks<LPT>(stage, dst, S, t);\n")
STAGE_STEPS = "  return LPT == 1 ? 8 : 4;"
# the entry's launch at each rows: GLZ_DECODE_DUAL(lanes a thread, blocks a group)
LAUNCH = r"case {rows}: GLZ_DECODE_DUAL\(\d+, \d+\);"
GEOMETRIES = {"one_block": lambda rows: (rows // 8, 1), "cluster": lambda rows: (1, rows // 8)}
CLUSTER_SYNC = ("      if (threadIdx.x < C)\n"
                "        cluster.map_shared_rank(&cta_tot[parity][0], "
                "static_cast<int>(threadIdx.x))[cta] = total;\n"
                "      cluster.sync();\n")
OWN_COUNTS = ("      if (threadIdx.x < C) cta_tot[parity][threadIdx.x] = total;\n"
              "      __syncthreads();\n")


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


def _load(procs: dict, fn: str, argtypes, marker: str) -> dict:
    libs = {}
    for name, (proc, so) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        lines = (out + err).splitlines()
        at = [i for i, line in enumerate(lines) if marker in line]
        regs = [line.strip() for line in lines[at[0]:] if "registers" in line][:1] if at else []
        print(f"build {name}: {regs[0] if regs else ''}", flush=True)
        lib = ctypes.CDLL(str(so))
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def build(tmp: pathlib.Path) -> dict[str, ctypes.CDLL]:
    """One library per variant of the first port's kernel, one nvcc each,
    all started together."""
    procs = {name: _compile(tmp, f"probe_{name}", SOURCE, flag)
             for name, flag in VARIANTS.items()}
    return _load(procs, "k5_probe",
                 [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2, "decode_dual_kernel")


def build_now(tmp: pathlib.Path) -> dict[str, ctypes.CDLL]:
    """csrc/lockstep.cu as it is and with one change undone, one library
    each (glz_decode_dual only is called)."""
    src = (_kernels.CSRC / "lockstep.cu").read_text()
    for marker in (RING, STAGE_STORE, STAGE_FLUSH, STAGE_STEPS, CLUSTER_SYNC):
        if src.count(marker) != 1:
            raise RuntimeError(f"lockstep.cu no longer has the probe's marker:\n{marker}")
    geometry = {}
    for name, form in GEOMETRIES.items():
        text = src
        for rows in GEOMETRY_ROWS:
            pattern = LAUNCH.format(rows=rows)
            if len(re.findall(pattern, text)) != 1:
                raise RuntimeError(f"lockstep.cu no longer has the probe's marker:\n{pattern}")
            text = re.sub(pattern, "case {}: GLZ_DECODE_DUAL({}, {});".format(rows, *form(rows)),
                          text)
        geometry[name] = text
    texts = {"now": src, **geometry,
             "no_ring": src.replace(RING, "const uint32_t word = idx < 0 ? ring[0]"),
             "no_stage": src.replace(STAGE_STORE, "      dst[j * S + t] = r;\n")
                            .replace(STAGE_FLUSH, ""),
             "stage4": src.replace(STAGE_STEPS, "  return 4;"),
             "no_cluster_sync": src.replace(CLUSTER_SYNC, OWN_COUNTS)}
    procs = {name: _compile(tmp, name, text) for name, text in texts.items()}
    return _load(procs, "glz_decode_dual", _kernels._SIGNATURES["glz_decode_dual"],
                 "decode_dual_kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_phases: no CUDA device", file=sys.stderr)
        return 2
    now_only = "--now" in sys.argv[1:]
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    text = chip_smoke.make_word_corpus(chip_smoke.HUFFWORD_BYTES)
    vocabs = tok.build_vocabs(text)
    inp = chip_smoke.HuffwordInputs(text, S, ROWS, dev, vocabs=vocabs)
    want = inp.ranks
    (min0, min1), (max0, max1) = inp.lens
    out = torch.empty_like(want)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    n_groups = inp.padded.size
    times = {}

    def record(name: str, ms: float, against: str) -> None:
        times[name] = ms
        diff = f" ({times[against] - ms:+.3f} ms against {against})" if against in times else ""
        print(f"k5 {name}: {ms:.3f} ms{diff}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        libs = {} if now_only else build(pathlib.Path(tmp))

        def run(lib):
            rc = lib.k5_probe(
                _kernels.ptr(inp.payload), inp.payload.numel(), _kernels.ptr(inp.starts),
                _kernels.ptr(inp.counts), _kernels.ptr(inp.fc), _kernels.ptr(inp.off),
                min0, max0, min1, max1, TABLE_BITS, n_groups, S, _kernels.ptr(out), stream)
            if rc:
                raise RuntimeError(f"k5_probe: CUDA error {rc}")

        for name, lib in libs.items():
            if name in ("base", "table"):
                out.zero_()
                run(lib)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"variant {name} differs from decode_groups_dual_ref")
            record(name, chip_smoke.cuda_ms(lambda: run(lib), reps=5), "base")
        if libs:  # the base again, last, to show the spread within the call
            record("base (again)", chip_smoke.cuda_ms(lambda: run(libs["base"]), reps=5), "base")
        now = build_now(pathlib.Path(tmp))
        for rows in GEOMETRY_ROWS:
            r_inp = inp if rows == ROWS else chip_smoke.HuffwordInputs(text, S, rows, dev,
                                                                       vocabs=vocabs)
            r_out = torch.empty_like(r_inp.ranks)
            for name, lib in now.items():
                if rows != ROWS and name not in ("now", *GEOMETRIES):
                    continue

                def run_now(lib=lib, r_inp=r_inp, r_out=r_out, rows=rows):
                    rc = lib.glz_decode_dual(
                        _kernels.ptr(r_inp.payload), r_inp.payload.numel(),
                        _kernels.ptr(r_inp.starts), _kernels.ptr(r_inp.counts),
                        kd.DUAL_TABLE_BITS, _kernels.ptr(r_inp.fc), _kernels.ptr(r_inp.off),
                        *(x for pair in zip(*r_inp.lens) for x in pair), r_inp.padded.size,
                        S, rows, _kernels.ptr(r_out), stream)
                    if rc:
                        raise RuntimeError(f"glz_decode_dual: CUDA error {rc}")

                r_out.zero_()
                run_now()
                torch.cuda.synchronize()
                if name != "no_cluster_sync" and not torch.equal(r_out, r_inp.ranks):
                    raise RuntimeError(f"decode_dual_kernel ({name}, rows {rows}) differs "
                                       f"from decode_groups_dual_ref")
                record(f"now: {name}, rows {rows} ({r_inp.padded.size} groups)",
                       chip_smoke.cuda_ms(run_now, reps=5),
                       f"now: now, rows {rows} ({r_inp.padded.size} groups)")
            del r_inp, r_out
    print(f"k5 phases at 100 MiB of word text, rows {ROWS}, S {S}, {inp.T} tokens, codes "
          f"{min0}-{max0} / {min1}-{max1} bits, table_bits {TABLE_BITS}, on "
          f"{torch.cuda.get_device_name(0)} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
