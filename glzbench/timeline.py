"""The reduction from timed calls, spans and a device trace to metrics.

Every time here is in nanoseconds of the host's `time.perf_counter_ns`.
The timed calls and the harness's spans are taken on that clock; the
device events of a torch.profiler trace are moved onto it by the offset
between the trace's record of each timed call (a `record_function` span
named `glzbench.<direction>`) and the host clock's.

The arithmetic of busy and idle time is the one of
glz_tpu_torch/utils/timer.py's `kernel_events` and chip_smoke.py's
`trace_summary`: the union of device intervals, against a window.
"""

from __future__ import annotations

import dataclasses
import json
import statistics

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # work on the card's engines
SPAN_PREFIX = "glzbench."


@dataclasses.dataclass
class Call:
    """One timed call of an entry point."""
    direction: str       # "compress" or "decompress"
    start: int
    end: int
    data_bytes: int      # the uncompressed bytes the call took or returned
    container_bytes: int  # the containers' bytes it returned or took
    payload_bytes: int   # of which the payload sections
    label: str = ""      # the file's name, or "batch"

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


@dataclasses.dataclass
class DeviceEvent:
    start: int
    end: int
    cat: str             # one of DEVICE_CATS
    name: str
    nbytes: int = 0      # a copy's bytes


def union(intervals) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def overlap(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> int:
    """Length of the intersection of two unions (each sorted, disjoint)."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def length(intervals: list[tuple[int, int]]) -> int:
    return sum(b - a for a, b in intervals)


def calls_of(calls: list[Call], direction: str) -> list[Call]:
    return [c for c in calls if c.direction == direction]


def call_time(calls: list[Call]) -> int:
    return sum(c.end - c.start for c in calls)


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the values at or below it."""
    ordered = sorted(values)
    rank = max(1, -(-len(ordered) * q // 100))
    return ordered[int(rank) - 1]


def load_device_events(trace_file, calls: list[Call]) -> list[DeviceEvent]:
    """The device events of a Chrome trace torch.profiler wrote, on the host
    clock.  The offset is the median, over the timed calls, of the trace's
    start of each call's `glzbench.<direction>` span less the host clock's,
    matching the k-th span of a direction to the k-th call.  Raises when the
    trace holds none of those spans."""
    events = [e for e in json.loads(open(trace_file).read()).get("traceEvents", [])
              if e.get("ph") == "X"]
    offsets = []
    for direction in ("compress", "decompress"):
        spans = sorted(e["ts"] for e in events if e.get("cat") == "user_annotation"
                       and e.get("name") == SPAN_PREFIX + direction)
        offsets += [ts * 1e3 - c.start for ts, c in zip(spans, calls_of(calls, direction))]
    if not offsets:
        raise RuntimeError(f"{trace_file}: no {SPAN_PREFIX}* span: the trace cannot be "
                           "placed on the host clock")
    shift = statistics.median(offsets)
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            start = int(e["ts"] * 1e3 - shift)
            out.append(DeviceEvent(start, start + int(e.get("dur", 0) * 1e3), e["cat"],
                                   e["name"], int(e.get("args", {}).get("bytes", 0) or 0)))
    return out


def window_of(calls: list[Call]) -> list[tuple[int, int]]:
    return union((c.start, c.end) for c in calls)


def kernel_seconds(run, direction: str) -> float:
    """Kernel time inside the direction's calls."""
    w = window_of(calls_of(run.calls, direction))
    return overlap(union((e.start, e.end) for e in run.device_events if e.cat == "kernel"),
                   w) / 1e9


def device_busy_share(run, direction: str) -> float | None:
    """Union of kernel, copy and memset intervals over the direction's
    calls, as a share of their wall time."""
    calls = calls_of(run.calls, direction)
    wall = call_time(calls)
    if not run.device_events or not wall:
        return None
    busy = overlap(union((e.start, e.end) for e in run.device_events), window_of(calls))
    return busy / wall


def copies(run, direction: str) -> tuple[int, float]:
    """(bytes, busy seconds) of the copies whose middle lies inside one of
    the direction's calls."""
    w = window_of(calls_of(run.calls, direction))
    nbytes, busy = 0, 0
    for e in run.device_events:
        mid = (e.start + e.end) // 2
        if e.cat == "gpu_memcpy" and any(a <= mid < b for a, b in w):
            nbytes += e.nbytes
            busy += e.end - e.start
    return nbytes, busy / 1e9


def span_share(run, direction: str, wrapped: dict) -> float | None:
    """Union of the harness's spans of the functions `wrapped` names
    ({module: (attribute, ...)}) inside the direction's calls, as a share of
    their wall time; None when one of them is missing or none ran."""
    if any(f"{m}.{a}" in run.missing for m, attrs in wrapped.items() for a in attrs):
        return None
    names = {f"{m.rsplit('.', 1)[-1]}.{a}" for m, attrs in wrapped.items() for a in attrs}
    calls = calls_of(run.calls, direction)
    wall = call_time(calls)
    spans = union((a, b) for name, a, b in run.spans if name in names)
    inside = overlap(spans, window_of(calls))
    return inside / wall if inside and wall else None


def _op_name(e: DeviceEvent) -> str:
    """A kernel's function without namespace, template or argument list;
    other device operations by the trace's name."""
    if e.cat != "kernel":
        return e.name
    name = e.name.removeprefix("void ").removeprefix("(anonymous namespace)::")
    return name.split("(")[0].split("<")[0]


def breakdown(run, top: int = 10) -> dict:
    """The device operations with the most time in the window, and the
    longest device-idle gaps, each under the innermost harness span (a timed
    call or a wrapped function) that covers its middle."""
    w0, w1 = run.window
    ops: dict[str, int] = {}
    for e in run.device_events:
        d = min(e.end, w1) - max(e.start, w0)
        if d > 0:
            ops[_op_name(e)] = ops.get(_op_name(e), 0) + d
    busy = union((max(e.start, w0), min(e.end, w1)) for e in run.device_events)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    spans = [(c.direction, c.start, c.end) for c in run.calls] + list(run.spans)

    def cover(mid: int) -> str:
        over = [s for s in spans if s[1] <= mid < s[2]]
        return max(over, key=lambda s: s[1])[0] if over else "host (untraced)"

    return {
        "device_ops": [[name, ns / 1e9] for name, ns in
                       sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[cover((a + b) // 2), (b - a) / 1e9] for a, b in
                      sorted(gaps, key=lambda g: g[0] - g[1])[:top]],
    }


def busy_seconds(run) -> float:
    w0, w1 = run.window
    return length(union((max(e.start, w0), min(e.end, w1)) for e in run.device_events)) / 1e9
