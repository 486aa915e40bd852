"""Phase timing / throughput observability.

A copy of glz_tpu/utils/timer.py: explicit phase timers with GB/s and a
report the CLI/bench can print (`Phase` and `Profiler`, exactly as there),
and `device_trace`, which records a torch.profiler trace where the original
records a jax.profiler one.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import time
from dataclasses import dataclass, field

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
