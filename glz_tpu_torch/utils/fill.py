"""The bytes a call returns, made before their contents exist.

A decompress's output and a compress's container are each one new `bytes`
object (models/transfer.py host_bytes, core/container.py), and a large one
lies in memory that glibc maps afresh for every call (above its 32 MiB mmap
ceiling; below it, heap pages the allocator may have handed back).  Copied
into as it is, every 4 KiB page faults under the copy.  So fresh_bytes
makes the object at its final size, uninitialised, and has a small pool of
threads put its pages in place, one write a page, while the call goes on
with its other work; fill joins them, then makes the one copy, in slices on
the pool, into memory already in place.

On the card's host (tools/fill_phases.py on an NVIDIA H100 80GB HBM3
machine, 8 cores; medians of 9, each result fresh; the run that PERF.md
section 6 tabulates), where the kernel refuses MADV_POPULATE_WRITE (EINVAL):
10^8 B took 40.7 ms by tobytes, 24.0 ms populated on 2 threads and filled
at once (26.7 on one, 22.7 on four), 6.5 ms when filled after the card's
share of the call (n / 4 GB/s); a population beside a pageable 56 MB H2D
left the H2D as it was (8.3 ms alone, 7.9 beside).  In the twelve Silesia
sizes' order, results from 8.47 MB up took 1.04-3.43 ms in bulk against
1.59-23.97 plainly, and those of 5.3-7.3 MB 1.04-1.37 against 0.95-1.29:
hence the 8 MiB floor.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import mmap
import os
import threading

import numpy as np

from glz_tpu_torch.utils import timer

PAGE = mmap.PAGESIZE
# The copy: one slice per SLICE_BYTES, at most one a core and MAX_SLICES
# (the pool's threads).  The population: the result's whole pages in as
# many slices, but at most MAX_POPULATE, since page faults from more
# threads go no faster and only hold more cores.  A result under
# BULK_FLOOR is one plain copy (tobytes, b"".join).
SLICE_BYTES = 4 << 20
BULK_FLOOR = 8 << 20
MAX_SLICES = 4
MAX_POPULATE = 2

_new_bytes = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_void_p, ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_bytes_address = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object)(
    ("PyBytes_AsString", ctypes.pythonapi))
_pool: concurrent.futures.ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()


def _populate(obj: bytes, view: np.ndarray, lo: int, hi: int) -> None:
    """Put the pages of view[lo:hi] in place (page-aligned offsets) by one
    write a page, of bytes that the fill overwrites (numpy releases the GIL
    for it).  `obj`, the bytes object under `view`, is held until the slice
    is done."""
    view[lo:hi:PAGE] = 0


def _copy(dst: int, srcs: list, lo: int, hi: int) -> None:
    """Copy bytes [lo, hi) of a result at `dst` from the (offset, uint8
    array) parts that cover them (memmove releases the GIL)."""
    for off, src in srcs:
        a, b = max(lo, off), min(hi, off + src.size)
        if a < b:
            ctypes.memmove(dst + a, src.ctypes.data + a - off, b - a)


def _cuts(lo: int, hi: int, k: int, unit: int) -> list[int]:
    """k + 1 bounds of [lo, hi) in k slices of whole units."""
    units = (hi - lo) // unit
    return [lo + units * i // k * unit for i in range(k)] + [hi]


def _executor() -> concurrent.futures.ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = concurrent.futures.ThreadPoolExecutor(MAX_SLICES,
                                                          thread_name_prefix="glz-fill")
        return _pool


def _forget_pool() -> None:
    """In a forked child: the parent's threads are not there, so make anew."""
    global _pool, _pool_lock
    _pool, _pool_lock = None, threading.Lock()


os.register_at_fork(after_in_child=_forget_pool)


class FreshBytes:
    """The `bytes` a call returns, made at its final size before its
    contents exist (fresh_bytes), then filled once (fill).  Used as a
    context: leaving it waits for the population, so none runs on after
    an exception."""

    def __init__(self, n: int):
        self.n = n
        self._obj = self._view = None
        self._jobs = []
        self._filled = False
        if n < BULK_FLOOR:
            return
        self._k = min(MAX_SLICES, len(os.sched_getaffinity(0)), max(1, n // SLICE_BYTES))
        self._obj = _new_bytes(None, n)
        self._addr = _bytes_address(self._obj)
        self._view = np.frombuffer((ctypes.c_char * n).from_address(self._addr), np.uint8)
        lo, hi = -self._addr % PAGE, (self._addr + n) // PAGE * PAGE - self._addr
        cuts = _cuts(lo, hi, min(MAX_POPULATE, self._k), PAGE)
        pool = _executor()
        self._jobs = [pool.submit(_populate, self._obj, self._view, a, b)
                      for a, b in zip(cuts, cuts[1:]) if a < b]

    def __enter__(self) -> FreshBytes:
        return self

    def __exit__(self, *exc) -> bool:
        concurrent.futures.wait(self._jobs)
        return False

    def fill(self, parts) -> bytes:
        """The n bytes of `parts` (buffers, in order) as one bytes object:
        b"".join(parts) under BULK_FLOOR; from it, once the population is
        done, each part copied into the object at its offset, in the
        copy's slices on the pool and this thread (counted as
        `populated_bytes`).  The object is handed out once, and no view of it
        is kept."""
        if self._filled:
            raise ValueError("fill: this result has been handed out already")
        self._filled = True
        if self._view is None:
            out = b"".join(parts)
            if len(out) != self.n:
                raise ValueError(f"fill: {len(out)} bytes for a result of {self.n}")
            return out
        for job in self._jobs:
            job.result()
        srcs, off = [], 0
        for part in parts:
            srcs.append((off, np.frombuffer(part, np.uint8)))
            off += srcs[-1][1].size
        if off != self.n:
            raise ValueError(f"fill: {off} bytes for a result of {self.n}")
        cuts = _cuts(0, self.n, self._k, 1)
        pool = _executor()
        jobs = [pool.submit(_copy, self._addr, srcs, a, b) for a, b in zip(cuts[1:], cuts[2:])]
        try:
            _copy(self._addr, srcs, cuts[0], cuts[1])
        finally:
            concurrent.futures.wait(jobs)
        for job in jobs:
            job.result()
        timer.count(timer.POPULATED_BYTES, self.n)
        out, self._obj, self._view = self._obj, None, None
        return out


def fresh_bytes(n: int) -> FreshBytes:
    """The n-byte result of a call, its pages put in place in bulk from now
    on (from BULK_FLOOR bytes); start it as soon as n is known, and fill it
    where the call's one copy of the result is made."""
    return FreshBytes(n)
