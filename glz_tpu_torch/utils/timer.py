"""Phase timing / throughput observability.

A copy of glz_tpu/utils/timer.py: explicit phase timers with GB/s and a
report the CLI/bench can print (`Phase` and `Profiler`, exactly as there),
and `device_trace`, which records a torch.profiler trace where the original
records a jax.profiler one.

The program's own spans and counters (not in glz_tpu): `span(name)` around
each step of a call, `count(name, n)` for what a step did, `recording()` to
keep the spans of every thread in memory.  Spans are taken on
`time.perf_counter_ns`, and a span recorded while a torch.profiler is on is
also a `record_function` span named "glz.<name>", so its trace shows them.
With nothing recording, `span` costs one flag read and returns a shared
no-op context.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import pathlib
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

TRACE_SUFFIX = ".pt.trace.json"  # torch.profiler.tensorboard_trace_handler's files


@dataclass
class Phase:
    name: str
    seconds: float
    bytes_processed: int = 0

    @property
    def gbps(self) -> float:
        return self.bytes_processed / max(self.seconds, 1e-12) / 1e9


@dataclass
class Profiler:
    phases: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str, nbytes: int = 0):
        t0 = time.perf_counter()
        yield
        self.phases.append(Phase(name, time.perf_counter() - t0, nbytes))

    def report(self) -> str:
        lines = []
        for p in self.phases:
            rate = f"  {p.gbps:7.3f} GB/s" if p.bytes_processed else ""
            lines.append(f"{p.name:<28s} {p.seconds*1e3:9.2f} ms{rate}")
        total = sum(p.seconds for p in self.phases)
        lines.append(f"{'total':<28s} {total*1e3:9.2f} ms")
        return "\n".join(lines)


@dataclass
class Trace:
    """What device_trace wrote: the Chrome trace's path, set when the block
    has ended (None for a falsy path)."""
    file: pathlib.Path | None = None


def kernel_events(trace: dict) -> list[dict]:
    """The GPU kernel events of a Chrome trace that torch.profiler wrote."""
    return [e for e in trace.get("traceEvents", []) if e.get("cat") == "kernel"]


@contextlib.contextmanager
def device_trace(path: str | os.PathLike | None, device: str | torch.device | None = None):
    """torch.profiler trace of the block (a no-op when path is falsy).

    `path` is a directory; the trace goes there as one Chrome trace
    (`<host>_<pid>.<ns>.pt.trace.json`, torch.profiler's
    tensorboard_trace_handler).  `device` None means the CUDA card: CPU and
    CUDA activities, RuntimeError without a card, the card synchronized
    before the trace ends, and RuntimeError if the trace holds no GPU kernel
    event (torch.profiler only warns where it cannot trace the card).
    `device="cpu"` traces the CPU only.  Yields a `Trace`, whose `file` is
    the trace's path once the block has ended.
    """
    trace = Trace()
    if not path:
        yield trace
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace: no CUDA device (device='cpu' traces the CPU)")
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    elif dev.type == "cpu":
        activities = [ProfilerActivity.CPU]
    else:
        raise ValueError(f"device_trace: device must be a CUDA device or the CPU, got {dev}")
    out = pathlib.Path(path)
    before = set(out.glob("*" + TRACE_SUFFIX))
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(out))):
        yield trace
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    written = sorted(set(out.glob("*" + TRACE_SUFFIX)) - before)
    if len(written) != 1:
        raise RuntimeError(f"device_trace: expected one new trace in {out}, found {written}")
    trace.file = written[0]
    if dev.type == "cuda" and not kernel_events(json.loads(trace.file.read_text())):
        raise RuntimeError(f"device_trace: {trace.file} holds no GPU kernel event "
                           "(torch.profiler did not trace the card)")


# ---- spans and counters -------------------------------------------------------

SPAN_PREFIX = "glz."  # the record_function name of a recorded span, under a profiler
# The program's counter of the bytes a step writes into a new host buffer by
# copying (zero-fill not counted).
HOST_COPY_BYTES = "host_copy_bytes"
# The bytes a payload-sized copy brings back from the card, and those of them
# that landed in page-locked staging (models/transfer.py host_array).
D2H_BYTES = "d2h_bytes"
D2H_PINNED_BYTES = "d2h_pinned_bytes"


class SpanRecord(NamedTuple):
    """One finished span.  `parent` is the id of the span open around it (on
    its thread, or the one passed across threads), None for an entry point;
    `root` is the id of the entry point it ran under; `counts` what count()
    added while it was the innermost open span of its thread."""
    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    start_ns: int
    end_ns: int
    counts: dict


_sink: list | None = None   # the switch: the finished spans of the recording that is on
_switch_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()  # .stack: the thread's open spans, innermost last
_totals: dict[str, int] = {}
_totals_lock = threading.Lock()


class _Off:
    """What span() returns while nothing records: one shared no-op."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start", "counts", "_rf", "_sink")

    def __init__(self, name: str, parent: _Span | None, start_ns: int | None):
        self.name, self.parent, self.start = name, parent, start_ns

    def __enter__(self):
        stack = _stack()
        parent = self.parent if self.parent is not None else (stack[-1] if stack else None)
        self.parent = parent
        self.id = next(_ids)
        self.root = parent.root if parent is not None else self.id
        self.counts = {}
        self._sink = _sink
        self._rf = None
        if torch.autograd._profiler_enabled():  # a record_function costs ~10x the rest
            self._rf = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self._rf.__enter__()
        stack.append(self)
        if self.start is None:
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        sink = self._sink
        if sink is not None and sink is _sink:  # the recording it began in is still on
            sink.append(SpanRecord(self.name, self.id,
                                   None if self.parent is None else self.parent.id,
                                   self.root, threading.get_ident(), self.start, end,
                                   self.counts))
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, parent: _Span | None = None, start_ns: int | None = None):
    """A context around one step, recorded while recording() is on.  Its
    parent is the innermost open span of the thread, or `parent` (what
    current() gave on another thread, for work handed to a pool); it starts
    when the block does, or at `start_ns` (perf_counter_ns) for a wait that
    began before it."""
    if _sink is None:
        return _OFF
    return _Span(name, parent, start_ns)


def current() -> _Span | None:
    """The thread's innermost open span while recording, else None."""
    if _sink is None:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def count(name: str, n: int) -> None:
    """Add n to the process's total of `name` and, while recording, to the
    counts of the thread's innermost open span."""
    with _totals_lock:
        _totals[name] = _totals.get(name, 0) + n
    if _sink is not None:
        stack = _stack()
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n


def totals(prefix: str = "") -> dict[str, int]:
    """The process's counts of the names that start with `prefix`."""
    with _totals_lock:
        return {k: v for k, v in _totals.items() if k.startswith(prefix)}


def reset_totals(prefix: str = "") -> None:
    """Zero the process's counts of the names that start with `prefix`."""
    with _totals_lock:
        for k in _totals:
            if k.startswith(prefix):
                _totals[k] = 0


@contextlib.contextmanager
def recording():
    """Record the spans of every thread of the process while the block runs.
    Yields the list that receives each SpanRecord as its span ends.  Raises
    RuntimeError when a recording is already on."""
    global _sink
    sink: list = []
    with _switch_lock:
        if _sink is not None:
            raise RuntimeError("recording() is already on")
        _sink = sink
    try:
        yield sink
    finally:
        with _switch_lock:
            _sink = None
