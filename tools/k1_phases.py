#!/usr/bin/env python3
"""Time the phases of the byte lane totals (K1) apart on one CUDA card, and
the entry-word lane totals (K1e, K1's HuffWord form) against their first
port.

    python3 tools/k1_phases.py            # from the repository root
    python3 tools/k1_phases.py --now      # K1: the kernel of csrc/lockstep.cu only

K1 sums the code lengths of each lane's S symbol bytes (0 past n_valid)
and adds each lane's refill word count to its group's.  This script builds
a copy of the first port's kernel (lane_totals_kernel: a thread a lane,
reading it 16 bytes at a time at a stride of S bytes between the threads
of a warp, a 256-byte length table in shared memory, a per-byte validity
predicate, the lane's last byte read again, one atomic a warp) in variants
that each take one suspect out, and times each at the byte main path's
shape (512 MiB under THROUGHPUT: 128 groups of 64 x 128 lanes, S 512) with
CUDA events:

  base        the kernel as it was (checked against lane_totals_ref)
  no_load     each lane's first 16 bytes loaded once and summed S/16 times
              (the same bytes, so the lengths keep the corpus's law)
  no_lookup   the length made from the byte (1 + (b & 7)) without the table
  no_pred     no per-byte validity test (wrong only on a ragged lane)
  no_last     the lane's last byte not read again (its length taken as 0)
  coalesced   the loads only changed: the threads of a warp read 16
              consecutive bytes each (the same bytes, summed into the wrong
              lanes), so a warp load is 512 contiguous bytes

and the combinations with no_load.  The time a variant saves is what its
suspect costs in the base kernel.  Then csrc/lockstep.cu's kernel as it
is (`now`), and builds of it that each undo one of its changes by editing
a copy of the source (`one_row`: one 512-byte row in flight a thread
instead of four; `shuffles`: a lane of 32 threads summed with five
shuffles instead of one warp reduction), each checked against
lane_totals_ref.

K1e: the first port's kernel (`k1e first port`: a thread a lane, reading
it 16 bytes at a time, so the threads of a warp are 4S bytes apart, and
its last entry read again) against csrc/lockstep.cu's, as it is and in
each build above (both kernels share kTotRows and segment_sum), at the
HuffWord cell's shape: 24 groups of 32 x 128 lanes of S 512 entries, the
first 48,992,498 valid.  Its work does not depend on the entries' values,
so they are random lj|len words (lengths 1-26), 0 past the valid count,
made on the card; each kernel is checked against lane_totals_entries_ref.
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

VARIANTS = {"base": "", "no_load": "-DK1_NO_LOAD", "no_lookup": "-DK1_NO_LOOKUP",
            "no_pred": "-DK1_NO_PRED", "no_last": "-DK1_NO_LAST",
            "coalesced": "-DK1_COALESCED",
            "no_load+no_lookup": "-DK1_NO_LOAD -DK1_NO_LOOKUP",
            "no_load+no_pred": "-DK1_NO_LOAD -DK1_NO_PRED",
            "no_load+no_lookup+no_pred+no_last":
                "-DK1_NO_LOAD -DK1_NO_LOOKUP -DK1_NO_PRED -DK1_NO_LAST"}
# csrc/lockstep.cu edits that undo one change of the redesigned kernels:
# (marker, replacement) pairs, each marker found exactly once.
NOW_VARIANTS = {
    # one 512-byte row in flight a thread instead of four
    "one_row": [("constexpr int kTotRows = 4;", "constexpr int kTotRows = 1;")],
    # a lane of 32 threads summed with five shuffles instead of one reduction
    "shuffles": [("  if (seg == 32) return __reduce_add_sync(0xffffffffu, x);", "")],
}
# K1e at the HuffWord cell (chip_smoke.py phase 4b): S, rows, tokens
K1E_SHAPE = (512, 32, 48_992_498)

# The first port's K1e, as it was.
K1E_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr uint32_t kLenMask = 63;

__device__ __forceinline__ void store_lane_total(int tot, int last, int64_t flat_lane,
                                                 int g, int32_t* __restrict__ ctot,
                                                 int32_t* __restrict__ gw) {
  ctot[flat_lane] = tot;
  int words = tot > 0 ? (tot - last + 31) / 32 + 1 : 0;
  words = __reduce_add_sync(0xffffffffu, words);
  if ((threadIdx.x & 31) == 0) atomicAdd(gw + g, words);
}

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
}  // namespace

extern "C" int glz_lane_totals_entries(const void* ent, int n_groups, int S, int rows,
                                       void* ctot, void* gw, void* stream) {
  const int G = rows * 128;
  const dim3 grid(n_groups, G / 256);
  lane_totals_entries_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ent), S, G, static_cast<int32_t*>(ctot),
      static_cast<int32_t*>(gw));
  return static_cast<int>(cudaGetLastError());
}
"""

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr uint32_t kLenMask = 63;

__device__ __forceinline__ int lane_count(int64_t limit, int64_t first, int S) {
  const int64_t r = limit - first;
  return r <= 0 ? 0 : (r >= S ? S : static_cast<int>(r));
}

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
#ifdef K1_COALESCED
  // the warp's 32 lanes' bytes, read 512 contiguous bytes a warp load
  const int64_t warp_first = (flat_lane & ~static_cast<int64_t>(31)) * S;
  const uint4* src = reinterpret_cast<const uint4*>(sym + warp_first) + (threadIdx.x & 31);
  constexpr int kStride = 32;
#else
  const uint4* src = reinterpret_cast<const uint4*>(sym + first);
  constexpr int kStride = 1;
#endif
  int tot = 0;
  for (int i = 0; i * 16 < count; ++i) {
#ifdef K1_NO_LOAD
    const uint4 q = src[0];
#else
    const uint4 q = src[i * kStride];
#endif
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t b = (w[j >> 2] >> (8 * (j & 3))) & 255u;
#ifdef K1_NO_LOOKUP
      const int l = static_cast<int>(1u + (b & 7u));
#else
      const int l = lens[b];
#endif
#ifdef K1_NO_PRED
      tot += l;
#else
      tot += (i * 16 + j < count) ? l : 0;
#endif
    }
  }
#ifdef K1_NO_LAST
  const int last = 0;
#else
  const int last = (count == S) ? lens[sym[first + S - 1]] : 0;
#endif
  ctot[flat_lane] = tot;
  int words = tot > 0 ? (tot - last + 31) / 32 + 1 : 0;
  words = __reduce_add_sync(0xffffffffu, words);
  if ((threadIdx.x & 31) == 0) atomicAdd(gw + g, words);
}
}  // namespace

extern "C" int k1_probe(const void* sym, const void* tbl, long long n_valid, int n_groups,
                        int S, int rows, void* ctot, void* gw, void* stream) {
  const int G = rows * 128;
  const dim3 grid(n_groups, G / 256);
  lane_totals_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sym), static_cast<const uint32_t*>(tbl), n_valid, S, G,
      static_cast<int32_t*>(ctot), static_cast<int32_t*>(gw));
  return static_cast<int>(cudaGetLastError());
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


def _load(procs: dict, fn: str, argtypes, kernels: tuple[str, ...]) -> dict:
    """Wait for the builds, print each one's registers and spills for the
    kernels named in `kernels`, and load the libraries."""
    libs = {}
    for name, (proc, so) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        summary = [line for line in chip_smoke.ptxas_summary(out + err)
                   if line.startswith(tuple(k + ":" for k in kernels))]
        print(f"build {name}: {'; '.join(summary)}", flush=True)
        lib = ctypes.CDLL(str(so))
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def k1e_entries(dev: torch.device) -> torch.Tensor:
    """Random lj|len entry words (lengths 1-26) at K1E_SHAPE, 0 past the
    valid token count, group-padded, on the card."""
    S, rows, n = K1E_SHAPE
    group = rows * 128 * S
    gen = torch.Generator(device=dev).manual_seed(0x1E)
    lj = torch.randint(0, 1 << 26, (-(-n // group) * group,), generator=gen, device=dev,
                       dtype=torch.int32) << 6
    ent = lj | torch.randint(1, ke.MAX_FUSED_LEN + 1, lj.shape, generator=gen, device=dev,
                             dtype=torch.int32)
    ent[n:] = 0
    return ent


def k1e_times(first, now: dict, dev: torch.device, record) -> None:
    """Time the first port's K1e (`first`'s library) against each build of
    csrc/lockstep.cu in `now`, each checked against lane_totals_entries_ref."""
    S, rows, _n = K1E_SHAPE
    ent = k1e_entries(dev)
    want = ke.lane_totals_entries_ref(ent, S, rows)
    ctot, gw = torch.empty_like(want[0]), torch.empty_like(want[1])
    args = (_kernels.ptr(ent), ent.numel() // (rows * 128 * S), S, rows,
            _kernels.ptr(ctot), _kernels.ptr(gw),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

    def run(fn):
        gw.zero_()  # the kernels add to gw
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")

    builds = {"k1e first port": first, **{f"k1e now{'' if k == 'now' else ': ' + k}": lib
                                          for k, lib in now.items()}}
    for name, lib in builds.items():
        run(lib.glz_lane_totals_entries)
        torch.cuda.synchronize()
        if not (torch.equal(ctot, want[0]) and torch.equal(gw, want[1])):
            raise RuntimeError(f"{name} differs from lane_totals_entries_ref")
        record(name, chip_smoke.cuda_ms(lambda: run(lib.glz_lane_totals_entries), reps=20),
               "k1e first port")
    record("k1e first port (again)",
           chip_smoke.cuda_ms(lambda: run(first.glz_lane_totals_entries), reps=20),
           "k1e first port")


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device", file=sys.stderr)
        return 2
    now_only = "--now" in sys.argv[1:]
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    arr = chip_smoke.make_corpus(chip_smoke.MAIN_BYTES)
    conf = cfg.THROUGHPUT
    cb = build_codebook(sampled_histogram(arr, conf.histogram_budget), ke.MAX_FUSED_LEN)
    inp = chip_smoke.KernelInputs(arr, arr.size, conf.stream_symbols, conf.group_rows, cb, dev)
    n_groups = inp.padded.size
    ctot = torch.empty_like(inp.ctot)
    gw = torch.empty_like(inp.gw)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (_kernels.ptr(inp.sym), _kernels.ptr(inp.tbl), ctypes.c_longlong(inp.n_valid),
            ctypes.c_int(n_groups), ctypes.c_int(inp.S), ctypes.c_int(inp.rows),
            _kernels.ptr(ctot), _kernels.ptr(gw), stream)
    times: dict[str, float] = {}

    def record(name: str, ms: float, against: str) -> None:
        times[name] = ms
        diff = (f" ({times[against] - ms:+.3f} ms against {against})"
                if against in times and against != name else "")
        print(f"k1 {name}: {ms:.3f} ms{diff}", flush=True)

    def run(fn):
        gw.zero_()  # the kernels add to gw
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")

    def check(name: str, fn) -> None:
        run(fn)
        torch.cuda.synchronize()
        if not (torch.equal(ctot, inp.ctot) and torch.equal(gw, inp.gw)):
            raise RuntimeError(f"{name} differs from lane_totals_ref")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        if not now_only:
            procs = {name: _compile(tmp, f"probe_{name}", SOURCE, flag)
                     for name, flag in VARIANTS.items()}
            libs = _load(procs, "k1_probe", [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3, ("lane_totals_kernel",))
            for name, lib in libs.items():
                if name == "base":
                    check("variant base", lib.k1_probe)
                record(name, chip_smoke.cuda_ms(lambda: run(lib.k1_probe), reps=20), "base")
            record("base (again)", chip_smoke.cuda_ms(lambda: run(libs["base"].k1_probe),
                                                      reps=20), "base")
        src = (_kernels.CSRC / "lockstep.cu").read_text()
        texts = {"now": src}
        for name, edits in NOW_VARIANTS.items():
            text = src
            for marker, replacement in edits:
                if text.count(marker) != 1:
                    raise RuntimeError(f"lockstep.cu no longer has the probe's marker:\n{marker}")
                text = text.replace(marker, replacement)
            texts[name] = text
        procs = {name: _compile(tmp, name, text) for name, text in texts.items()}
        procs["k1e_first"] = _compile(tmp, "k1e_first", K1E_SOURCE)
        libs = _load(procs, "glz_lane_totals_entries",
                     _kernels._SIGNATURES["glz_lane_totals_entries"],
                     ("lane_totals_kernel", "lane_totals_entries_kernel"))
        first = libs.pop("k1e_first")
        for lib in libs.values():
            lib.glz_lane_totals.argtypes = _kernels._SIGNATURES["glz_lane_totals"]
            lib.glz_lane_totals.restype = ctypes.c_int
        for name, lib in libs.items():
            check(f"lane_totals_kernel ({name})", lib.glz_lane_totals)
            record(f"now: {name}" if name != "now" else "now",
                   chip_smoke.cuda_ms(lambda: run(lib.glz_lane_totals), reps=20), "now")
        k1e_times(first, libs, dev, record)
    print(f"k1 phases at {arr.size >> 20} MiB, rows {conf.group_rows}, S "
          f"{conf.stream_symbols}, codes {cb.min_len}-{cb.max_len} bits; k1e at S "
          f"{K1E_SHAPE[0]}, rows {K1E_SHAPE[1]}, {K1E_SHAPE[2]} tokens (times include zeroing "
          f"gw), on {torch.cuda.get_device_name(0)} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
