"""ctypes bindings for the host library (glz_tpu_torch/native/glz_native.cpp).

The host half of the codec that does not run on the card: the threaded byte
histogram, the HuffWord tokenizer and vocabulary build, detokenize, and the
.crs2 decoder.  The card does the rest (the kernels of csrc/).

The library is compiled with g++ on first use into `build/` at the
repository root, named by the hash of its source and flags, in a temporary
directory and then moved into place, so that concurrent builds (test
workers, the pipelined batch's two threads) never load a half-written file.
A failed build raises with the compiler's output: nothing falls back to the
numpy bodies, which stay in the modules that call this one as the plain
references of the tests.

Nothing is compiled or loaded at import time.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from glz_tpu_torch.utils import timer

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "native" / "glz_native.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
NATIVE_ARCH = "-march=native"  # dropped on the one retry, for compilers that refuse it

_LIB_LOCK = threading.Lock()  # the pipelined batch's two threads may ask at once
_LIB: ctypes.CDLL | None = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u32, _u64 = ctypes.c_uint32, ctypes.c_uint64
_SIGNATURES = {  # name -> (restype, argtypes)
    "glz_histogram": (None, [_u8p, ctypes.c_size_t, _i64p]),
    "glz_tokenize": (_u64, [_u8p, _u64, _u64p, _u8p]),
    "glz_build_vocab": (_u64, [_u8p, _u64p, _u64, _u32, _u64, _u32p, _u32p, _u64p, _u8p,
                               _u64p]),
    "glz_detokenize": (_u64, [_u32p, _u64, _u32, _u64p, _u8p, _u64p, _u8p, _u8p]),
    "glz_decode_crs2": (_u64, [_u8p, _u64, _u32p, _u32p, _i64p, _u32, _u32, _u8p, _u64]),
}


def library_path() -> pathlib.Path:
    """Where the library for this source and these flags is (or will be) built."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libglz_native_{tag}.so"


def _compile(flags: list[str], out: pathlib.Path) -> subprocess.CompletedProcess:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host library needs a C++ compiler on PATH")
    return subprocess.run([cxx, *flags, str(SOURCE), "-o", str(out)], capture_output=True,
                          text=True)


def build() -> pathlib.Path:
    """Compile the library unless its hashed file exists; return its path.
    Raises with g++'s stderr when neither build (with -march=native, then
    without it) succeeds."""
    lib = library_path()
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            so = pathlib.Path(tmp) / "lib.so"
            r = _compile(CXX_FLAGS, so)
            if r.returncode != 0:
                r = _compile([f for f in CXX_FLAGS if f != NATIVE_ARCH], so)
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE.name} ({r.returncode}):\n{r.stderr}")
            os.replace(so, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded host library, built and loaded once by the first caller
    (others wait for it)."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(build()))
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _LIB = lib
    return _LIB


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def histogram(data: np.ndarray, threads: int | None = None) -> np.ndarray:
    """256-bin byte histogram (int64).  Shards across CPU threads for large
    inputs, one per 16 MiB up to the core count (the ctypes call releases
    the GIL, so threads scale on real cores).  A `native.histogram` span,
    as each entry point below is `native.<its name>`."""
    L = library()
    with timer.span("native.histogram"):
        return _histogram(L, data, threads)


def _histogram(L, data: np.ndarray, threads: int | None) -> np.ndarray:
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = data.size
    if threads is None:
        threads = min(os.cpu_count() or 1, max(1, n >> 24))
    if threads <= 1:
        out = np.zeros(256, dtype=np.int64)
        L.glz_histogram(_p(data, ctypes.c_uint8), n, _p(out, ctypes.c_int64))
        return out
    outs = np.zeros((threads, 256), dtype=np.int64)
    bounds = [n * i // threads for i in range(threads + 1)]

    def work(i):
        chunk = data[bounds[i] : bounds[i + 1]]
        L.glz_histogram(_p(chunk, ctypes.c_uint8), chunk.size, _p(outs[i], ctypes.c_int64))

    with concurrent.futures.ThreadPoolExecutor(threads) as ex:
        list(ex.map(work, range(threads)))
    return outs.sum(axis=0)


def tokenize(data: np.ndarray) -> tuple[np.ndarray, bool]:
    """(bounds u64[T+1], first_is_word): token t is data[bounds[t]:bounds[t+1]]."""
    L = library()
    with timer.span("native.tokenize"):
        data = np.ascontiguousarray(data, dtype=np.uint8)
        bounds = np.zeros(data.size + 1, dtype=np.uint64)
        first = np.zeros(1, dtype=np.uint8)
        t = L.glz_tokenize(_p(data, ctypes.c_uint8), data.size, _p(bounds, ctypes.c_uint64),
                           _p(first, ctypes.c_uint8))
        return bounds[: int(t) + 1], bool(first[0])


def build_vocab(arr: np.ndarray, bounds: np.ndarray, T: int, cls: int, ids: np.ndarray,
                cap_tokens: int = 1 << 22) -> tuple[bytes, np.ndarray, np.ndarray]:
    """One class's vocabulary: writes ids (u32, in place) at this class's
    token positions (i % 2 == cls); returns (token text, token lengths
    int64[V], counts int64[V]) in (length, content) rank order.

    The output buffers are allocated at cap_tokens entries; a larger
    vocabulary is reported by the first call and built again at its size."""
    L = library()
    if ids.dtype != np.uint32 or ids.size < T or not ids.flags.c_contiguous:
        raise ValueError("ids must be a contiguous uint32 array of at least T entries")
    with timer.span("native.build_vocab"):
        return _build_vocab(L, arr, bounds, T, cls, ids, cap_tokens)


def _build_vocab(L, arr, bounds, T, cls, ids, cap_tokens):
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    bounds = np.ascontiguousarray(bounds, dtype=np.uint64)
    while True:
        tok_lens = np.empty(max(cap_tokens, 1), np.uint32)
        counts = np.empty(max(cap_tokens, 1), np.uint64)
        blob = np.empty(max(arr.size, 1), np.uint8)
        blob_len = np.zeros(1, np.uint64)
        V = int(L.glz_build_vocab(
            _p(arr, ctypes.c_uint8), _p(bounds, ctypes.c_uint64), T, cls, cap_tokens,
            _p(ids, ctypes.c_uint32), _p(tok_lens, ctypes.c_uint32),
            _p(counts, ctypes.c_uint64), _p(blob, ctypes.c_uint8),
            _p(blob_len, ctypes.c_uint64)))
        if V <= cap_tokens:
            return (blob[: int(blob_len[0])].tobytes(), tok_lens[:V].astype(np.int64),
                    counts[:V].astype(np.int64))
        cap_tokens = V


def detokenize(ids: np.ndarray, first_dict: int, off0: np.ndarray, blob0: bytes,
               off1: np.ndarray, blob1: bytes) -> bytes:
    """Token ids -> the original bytes by one memcpy a token; token i draws
    from dictionary (i & 1) ^ first_dict, each an (offsets, text) pool.
    Raises ValueError for an id past its dictionary (a corrupt container).
    Inputs of 2^20 tokens and more are split in two halves on two threads.
    The output's copy into bytes counts as host_copy_bytes of its span."""
    L = library()
    with timer.span("native.detokenize"):
        return _detokenize(L, ids, first_dict, off0, blob0, off1, blob1)


def _detokenize(L, ids, first_dict, off0, blob0, off1, blob1) -> bytes:
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    offs = [np.ascontiguousarray(o, dtype=np.uint64) for o in (off0, off1)]
    blobs = [np.frombuffer(b or b"\0", dtype=np.uint8) for b in (blob0, blob1)]
    T = ids.size
    # each token's output length, by parity: the total and the halves' split
    # offset without a native size query; the ids are checked here because
    # the library indexes the offsets with them unchecked
    lens = np.empty(T, np.int64)
    for parity in (0, 1):
        sizes = np.diff(offs[parity ^ first_dict].astype(np.int64))
        part = ids[parity::2]
        if part.size and int(part.max()) >= sizes.size:
            raise ValueError("corrupt container: a token id is past its dictionary")
        lens[parity::2] = sizes[part]
    out = np.empty(int(lens.sum()), dtype=np.uint8)

    def run(lo, cnt, off):
        L.glz_detokenize(_p(ids[lo : lo + cnt], ctypes.c_uint32), cnt, first_dict,
                         _p(offs[0], ctypes.c_uint64), _p(blobs[0], ctypes.c_uint8),
                         _p(offs[1], ctypes.c_uint64), _p(blobs[1], ctypes.c_uint8),
                         _p(out[off:], ctypes.c_uint8))

    if T >= (1 << 20):
        mid = (T // 2) & ~1  # even, so each half keeps the parity -> dictionary map
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            halves = [ex.submit(run, 0, mid, 0),
                      ex.submit(run, mid, T - mid, int(lens[:mid].sum()))]
            for h in halves:
                h.result()
    else:
        run(0, T, 0)
    data = out.tobytes()
    timer.count(timer.HOST_COPY_BYTES, len(data))
    return data


def decode_crs2(payload: bytes, fc_lj: np.ndarray, start_pos: np.ndarray,
                symbols: np.ndarray, min_len: int, max_len: int, out_cap: int) -> np.ndarray:
    """Decode a .crs2 code stream until its EOF symbol (256), the end of the
    payload or out_cap bytes, whichever comes first; returns the bytes
    decoded (the caller grows out_cap when they fill it)."""
    L = library()
    pay = np.ascontiguousarray(np.frombuffer(payload, dtype=np.uint8))
    fc = np.ascontiguousarray(fc_lj, np.uint32)
    sp = np.ascontiguousarray(start_pos, np.uint32)
    syms = np.ascontiguousarray(symbols, np.int64)
    out = np.zeros(out_cap, dtype=np.uint8)
    n = L.glz_decode_crs2(_p(pay, ctypes.c_uint8), pay.size, _p(fc, ctypes.c_uint32),
                          _p(sp, ctypes.c_uint32), _p(syms, ctypes.c_int64), min_len, max_len,
                          _p(out, ctypes.c_uint8), out_cap)
    return out[: int(n)]
