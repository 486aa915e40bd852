"""Build, bind and count the hand-written Hopper kernels (csrc/lockstep.cu,
csrc/bitstream.cu, the header they share, csrc/decode_table.cuh, and
csrc/histogram.cu).

The CUDA sources are compiled with nvcc for sm_90a, one nvcc per source, all
started together, and linked into one shared library with a plain C
interface, on first use, into `build/` at the repository root (named by the
hash of every file under csrc/, so an edited source or header is rebuilt),
and loaded with ctypes.
Each C entry launches on the current PyTorch stream and returns
cudaGetLastError(); a non-zero code raises here.

Nothing is compiled or loaded at import time: CPU-only machines import this
module and never call `library()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

from glz_tpu_torch.utils import timer

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = [CSRC / name for name in ("lockstep.cu", "bitstream.cu", "histogram.cu")]
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# The wrappers whose launches are counted, each as timer's "launch.<wrapper>".
WRAPPERS = ("lane_totals", "encode_groups", "decode_groups", "lane_totals_entries",
            "encode_entries", "decode_dual", "lut_gather", "lookup_lj_lens", "pack_scan",
            "pack_tiles", "decode_streams", "decode_streams_dual", "histogram",
            "decode_streams_bitwalk", "decode_streams_fast", "decode_streams_dual_bitwalk",
            "decode_streams_dual_fast")
LAUNCH = "launch."
_LIB_LOCK = threading.Lock()  # the pipelined batch's first files build and load from two threads
_LIB: ctypes.CDLL | None = None
_BUILD_LOG = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "glz_lane_totals": [_P, _P, _LL, _I, _I, _I, _P, _P, _P],
    "glz_lane_totals_entries": [_P, _I, _I, _I, _P, _P, _P],
    "glz_encode_groups": [_P, _P, _LL, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "glz_encode_entries": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "glz_decode_groups": [_P, _LL, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "glz_decode_dual": [_P, _LL, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "glz_lut_gather": [_P, _I, _LL, _P, _LL, _LL, _LL, _LL, _LL, _P, _I, _P],
    "glz_lookup_lj_lens": [_P, _LL, _LL, _P, _P, _P, _P, _P],
    "glz_pack_scan": [_P, _LL, _P, _P],
    "glz_pack_tiles": [_P, _P, _LL, _P, _I, _LL, _P, _LL, _P, _P],
    "glz_decode_streams": [_P, _LL, _P, _LL, _LL, _LL, _I, _P, _P, _P, _I, _I, _I, _P, _P],
    "glz_decode_streams_dual": [_P, _LL, _P, _LL, _LL, _LL, _I, _P, _P, _I, _I, _I, _I, _I,
                                _P, _P],
    "glz_histogram": [_P, _LL, _P, _P],
    "glz_decode_streams_strategy": [_I, _P, _LL, _P, _LL, _LL, _LL, _P, _P, _P, _I, _I, _I,
                                    _I, _P, _P, _P],
    "glz_decode_streams_dual_strategy": [_I, _P, _LL, _P, _LL, _LL, _LL, _P, _P, _I, _I, _I,
                                         _I, _LL, _LL, _I, _P, _P, _P],
}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> pathlib.Path:
    """Where the library for these sources and flags is (or will be) built."""
    tag = hashlib.sha256(b"".join(f.name.encode() + f.read_bytes()
                                  for f in sorted(CSRC.iterdir()) if f.is_file())
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libglz_kernels_{tag}.so"


def build() -> pathlib.Path:
    """Compile the CUDA sources (if their hashed library is missing), one
    nvcc per source in parallel, link them into one library and return its
    path.  The compilers' -Xptxas -v reports (registers, spills per kernel)
    are kept in build_log()."""
    global _BUILD_LOG
    lib = library_path()
    log = lib.with_suffix(".ptxas.txt")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [pathlib.Path(tmp) / f"{src.stem}.o" for src in SOURCES]
            procs = [subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj),
                                       str(src)], stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for src, obj in zip(SOURCES, objs)]
            outs = [proc.communicate() for proc in procs]
            for src, proc, (out, err) in zip(SOURCES, procs, outs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
            so = pathlib.Path(tmp) / "lib.so"
            link = subprocess.run([nvcc_path(), "-shared", "-o", str(so), *map(str, objs)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
            log.write_text("".join(out + err for out, err in outs))
            os.replace(so, lib)
    _BUILD_LOG = log.read_text() if log.exists() else ""
    return lib


def build_log() -> str:
    return _BUILD_LOG


def library() -> ctypes.CDLL:
    """The loaded kernel library, built and loaded once by the first caller
    (others wait for it)."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _LIB = lib
    return _LIB


def launch(name: str, counter: str, *args) -> None:
    """Call C entry `name` on the current stream; raise on a CUDA error and
    count the launch under `counter`."""
    fn = getattr(library(), name)
    rc = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    timer.count(LAUNCH + counter, 1)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset_launch_counts(), by wrapper."""
    counted = timer.totals(LAUNCH)
    return {w: counted.get(LAUNCH + w, 0) for w in WRAPPERS}


def reset_launch_counts() -> None:
    timer.reset_totals(LAUNCH)


def runs_plain(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor (the kernel launches); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors must be on the CPU or a CUDA device, got {t.device}")
    return t.device.type == "cpu"


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless `t` has this dtype, shape and device and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
