#!/usr/bin/env python3
"""Time the bitstream pack step apart on one CUDA card: the first port's
torch glue and kernel against the pack of csrc/bitstream.cu.

    python3 tools/pack_phases.py          # from the repository root

The step is glz_tpu/ops/encode.py:pack_lj's function: left-justified codes
and their lengths (u32 each) -> the MSB-first payload words, the total bit
count and each stream's bits.  The first port computed it as

  cumsum      torch.cumsum of the int32 lengths into int64 offsets
  sub         offsets -= lengths (exclusive offsets)
  stream sum  the lengths summed per stream (int64)
  sync        int(offsets[-1]): the total, on the host
  zeros       the zeroed word buffer
  kernel      pack_lj_kernel: one thread a code, one or two atomicOr a code

This script builds a copy of that kernel, times each of the six apart and
the whole step, at the byte bitstream path's dispatch (2^27 symbols of the
512 MiB benchmark corpus under DEFAULT, streams of 2^18), then times the
port's pack_codes (pack_scan, pack_tiles of csrc/bitstream.cu) on the same
codes, checked bit-exact against the old step's words and stream bits.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from glz_tpu_torch import config as cfg  # noqa: E402
from glz_tpu_torch.core.codebook import build_codebook, histogram_bytes  # noqa: E402
from glz_tpu_torch.models.canonical_byte import MAX_DISPATCH_SYMBOLS  # noqa: E402
from glz_tpu_torch.models.transfer import i32_tensor  # noqa: E402
from glz_tpu_torch.ops import _kernels  # noqa: E402
from glz_tpu_torch.ops import encode as be  # noqa: E402

# The first port's pack kernel (csrc/bitstream.cu before its redesign).
OLD_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {
__global__ void __launch_bounds__(256) pack_lj_kernel(
    const uint32_t* __restrict__ lj, const int64_t* __restrict__ offsets, int64_t n,
    uint32_t* __restrict__ words, int64_t n_words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
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
}  // namespace

extern "C" int old_pack_lj(const void* lj, const void* offsets, long long n, void* words,
                           long long n_words, void* stream) {
  if (n <= 0 || n_words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  pack_lj_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lj), static_cast<const int64_t*>(offsets), n,
      static_cast<uint32_t*>(words), n_words);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_old(tmp: pathlib.Path) -> ctypes.CDLL:
    """The first port's pack kernel, built from OLD_SOURCE into `tmp`."""
    src = tmp / "old_pack.cu"
    src.write_text(OLD_SOURCE)
    so = tmp / "old_pack.so"
    proc = subprocess.run([_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-shared", "-o",
                           str(so), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the old pack:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.old_pack_lj.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.old_pack_lj.restype = ctypes.c_int
    return lib


def old_pack_step(lib: ctypes.CDLL, lj: torch.Tensor, lens: torch.Tensor, S: int,
                  parts: dict | None = None):
    """The first port's pack step on CUDA tensors: (words, total_bits,
    stream_bits).  With `parts`, each of its six pieces is timed apart
    (CUDA events; the sync on the host clock) into it."""
    def piece(name, fn):
        if parts is None:
            return fn()
        ms, r = chip_smoke.timed_once(fn)
        parts[name] = parts.get(name, 0.0) + ms
        return r

    offsets = piece("cumsum", lambda: torch.cumsum(lens, 0, dtype=torch.int64))
    total = piece("sync", lambda: int(offsets[-1]))
    piece("sub", lambda: offsets.sub_(lens))
    stream_bits = piece("stream sum", lambda: lens.view(-1, S).sum(dim=1, dtype=torch.int64))
    n_words = (total + 31) >> 5
    words = piece("zeros", lambda: torch.zeros(n_words, dtype=torch.int32, device=lj.device))

    def kernel():
        rc = lib.old_pack_lj(_kernels.ptr(lj), _kernels.ptr(offsets), lj.numel(),
                             _kernels.ptr(words), n_words,
                             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"old_pack_lj: CUDA error {rc}")

    piece("kernel", kernel)
    return words, total, stream_bits


def dispatch_codes(dev: torch.device):
    """(lj, lens, S) of the byte bitstream path's first dispatch."""
    arr = chip_smoke.make_corpus(chip_smoke.MAIN_BYTES)
    S = cfg.DEFAULT.stream_symbols
    chunk = arr[: (MAX_DISPATCH_SYMBOLS // S) * S]
    cb = build_codebook(histogram_bytes(arr), cfg.DEFAULT.length_limit)
    sym = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
    lj, lens = be.lookup_lj_lens_ref(sym, sym.numel(), i32_tensor(cb.left_justified_codes(), dev),
                                     i32_tensor(cb.lengths.astype(np.uint32), dev))
    return lj, lens, S


def main() -> int:
    if not torch.cuda.is_available():
        print("pack_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    lj, lens, S = dispatch_codes(dev)
    n = lj.numel()
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_old(pathlib.Path(tmp))
        want = old_pack_step(lib, lj, lens, S)
        torch.cuda.synchronize()
        parts: dict[str, float] = {}
        reps = 5
        for _ in range(reps):
            old_pack_step(lib, lj, lens, S, parts)
        old_ms = chip_smoke.cuda_ms(lambda: old_pack_step(lib, lj, lens, S), reps)
        for name, ms in parts.items():
            print(f"pack old {name}: {ms / reps:.3f} ms", flush=True)
        print(f"pack old step: {old_ms:.3f} ms", flush=True)
        got = be.pack_codes(lj, lens, S)
        torch.cuda.synchronize()
        if got[1] != want[1] or not torch.equal(got[0], want[0]) \
                or not torch.equal(got[2], want[2]):
            raise RuntimeError("pack_codes differs from the old pack step")
        new_ms = chip_smoke.cuda_ms(lambda: be.pack_codes(lj, lens, S), reps)
        old_again = chip_smoke.cuda_ms(lambda: old_pack_step(lib, lj, lens, S), reps)
        print(f"pack new step: {new_ms:.3f} ms (old step again {old_again:.3f} ms)",
              flush=True)
    total = want[1]
    print(f"pack phases at one dispatch of {n} symbols ({total} bits, {(total + 31) >> 5} "
          f"words, S {S}) on {torch.cuda.get_device_name(0)} ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
