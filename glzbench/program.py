"""The program's own spans and counters (glz_tpu_torch/utils/timer.py) in a
traced run, the arithmetic of the metrics that read them, and a tool that
lays them over the device's idle time: `python3 -m glzbench.program
--workload <cell> --seeds <n> ... --seconds <s>` runs the harness's traced
run of the cell once a seed and adds the breakdown with the program's spans
and the device-idle seconds inside the calls by innermost span.  The
benchmark's own runs never run the tool.

How a traced run records them: the harness's measure() loads every
per-layer reader of the cell just before its traced window opens (to learn
the functions it wraps); a reader that reads the program's spans calls
`begin_for_window()` as it is loaded, which turns the program's recorder on
for that load alone, and its `read` calls `records()`, which turns it off
and gives every span recorded so far.  Any other load of a reader (the
readers read after the window, a test that finds them) leaves the recorder
alone.  The spans are on `time.perf_counter_ns`, the clock of the timed
calls, so they need no offset.  A program without the recorder (a commit
before it) records nothing: `records()` gives None and the readers read
None.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import heapq
import importlib
import json
import statistics
import sys
import time

from glzbench import harness, timeline

# The model layer's host steps: what `model_host_share` unites.
MODEL_HOST = ("codebook", "pad", "tables", "serialize", "container.read", "container.write",
              "verify")
HOST_COPY_BYTES = "host_copy_bytes"  # the program's counter of host copies
FILE = "batch.file"                  # one file's call inside a batch

_recordings: list = []  # the program's recordings begun here, each [context, spans]
_MEASURE = harness.measure.__code__  # the harness's window, which loads the readers first


def _timer():
    return importlib.import_module("glz_tpu_torch.utils.timer")


def begin() -> None:
    """Turn the program's recorder on, unless this module's recording is on
    already, the program has no recorder, or another recording is on."""
    if _recordings and _recordings[-1][0] is not None:
        return
    recording = getattr(_timer(), "recording", None)
    if recording is None:
        return
    context = recording()
    try:
        spans = context.__enter__()
    except RuntimeError:  # someone else's recording is on
        return
    _recordings.append([context, spans])


def begin_for_window() -> None:
    """begin(), where the reader that calls it is being loaded by the
    harness's measure() for a traced window (the load that opens it); on any
    other load, nothing."""
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code is _MEASURE:
            if frame.f_locals.get("trace"):
                begin()
            return
        frame = frame.f_back


def records() -> list | None:
    """Every span the program recorded since the first begin(), its
    recording turned off; None when nothing was recorded (no begin(), or a
    program without the recorder)."""
    if not _recordings:
        return None
    last = _recordings[-1]
    if last[0] is not None:
        last[0].__exit__(None, None, None)
        last[0] = None
    return [r for _, spans in _recordings for r in spans]


def within(spans: list, calls: list) -> list:
    """The spans that start inside one of the calls."""
    w = timeline.window_of(calls)
    starts = [a for a, _ in w]
    out = []
    for r in spans:
        k = bisect.bisect_right(starts, r.start_ns) - 1
        if k >= 0 and r.start_ns < w[k][1]:
            out.append(r)
    return out


def _inside(run, direction: str) -> tuple[list, list]:
    """(the direction's calls, the program's spans that start inside one)."""
    spans = records()
    calls = timeline.calls_of(run.calls, direction)
    return calls, within(spans, calls) if spans and calls else []


def host_share(run, direction: str) -> float | None:
    """The union of the MODEL_HOST spans inside the direction's calls, over
    the calls' summed wall time; None where there is none."""
    calls, spans = _inside(run, direction)
    steps = timeline.union((r.start_ns, r.end_ns) for r in spans if r.name in MODEL_HOST)
    wall = timeline.call_time(calls)
    if not steps or not wall:
        return None
    return timeline.overlap(steps, timeline.window_of(calls)) / wall


def copy_bytes(run, direction: str) -> float | None:
    """The host_copy_bytes counted inside the direction's calls, over the
    bytes the calls took or returned; None where nothing was counted."""
    calls, spans = _inside(run, direction)
    counted = [r.counts[HOST_COPY_BYTES] for r in spans if HOST_COPY_BYTES in r.counts]
    data = sum(c.data_bytes for c in calls)
    return sum(counted) / data if counted and data else None


def overlap_files(run, direction: str) -> float | None:
    """Files in flight: the summed batch.file spans inside the direction's
    batch calls (those that hold one), over those calls' wall time; None
    where no call holds one."""
    calls, spans = _inside(run, direction)
    files = [r for r in spans if r.name == FILE]
    batches = [c for c in calls if within(files, [c])]
    wall = timeline.call_time(batches)
    return sum(r.end_ns - r.start_ns for r in files) / wall if files and wall else None


def _idle(run, calls) -> list[tuple[int, int]]:
    """The device-idle intervals inside the calls."""
    busy = timeline.union((e.start, e.end) for e in run.device_events)
    idle, j = [], 0
    for a, b in timeline.window_of(calls):
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        t, k = a, j
        while k < len(busy) and busy[k][0] < b:
            if busy[k][0] > t:
                idle.append((t, busy[k][0]))
            t = max(t, busy[k][1])
            k += 1
        if t < b:
            idle.append((t, b))
    return idle


def idle_by_span(run, spans: list, direction: str) -> dict | None:
    """The device-idle seconds inside the direction's calls, each instant
    under the innermost span over it (the latest to start): the timed
    calls, the harness's spans and the program's.  Gives {"spans": {name:
    seconds}, "idle_s", "covered": the share of that idle time under a
    program span below its root}; None without a trace or a call."""
    calls = timeline.calls_of(run.calls, direction)
    if run.device_events is None or not calls:
        return None
    # each span as (start, end, name, below its root)
    over = ([(c.start, c.end, c.direction, False) for c in calls]
            + [(a, b, name, False) for name, a, b in run.spans]
            + [(r.start_ns, r.end_ns, r.name, r.parent is not None) for r in spans])
    edges = [(a, 1, k) for k, (a, b, _, _) in enumerate(over) if b > a]
    edges += [(b, -1, k) for k, (a, b, _, _) in enumerate(over) if b > a]
    for a, b in _idle(run, calls):
        edges += [(a, 2, -1), (b, -2, -1)]
    edges.sort(key=lambda e: (e[0], e[1]))
    heap: list = []      # (-start, -k) of the open spans: the innermost first
    open_ = set()
    below = idle_depth = 0
    out: dict[str, int] = {}
    total = covered = 0
    t = None
    for x, kind, k in edges:
        if t is not None and x > t and idle_depth:
            while heap and -heap[0][1] not in open_:
                heapq.heappop(heap)
            name = over[-heap[0][1]][2] if heap else "host (untraced)"
            out[name] = out.get(name, 0) + x - t
            total += x - t
            covered += (x - t) if below else 0
        t = x
        if kind == 1:
            open_.add(k)
            heapq.heappush(heap, (-over[k][0], -k))
            below += over[k][3]
        elif kind == -1:
            open_.discard(k)
            below -= over[k][3]
        else:
            idle_depth += 1 if kind == 2 else -1
    return {"spans": {n: s / 1e9 for n, s in sorted(out.items(), key=lambda kv: -kv[1])},
            "idle_s": total / 1e9, "covered": covered / total if total else None}


# ---- the tool ------------------------------------------------------------------
# To go with the benchmark PR that makes the harness's measure() record the
# program's spans and its traced run print the idle table.

def _median_ms(run) -> dict:
    return {d: statistics.median(c.seconds * 1e3 for c in timeline.calls_of(run.calls, d))
            for d in ("compress", "decompress") if timeline.calls_of(run.calls, d)}


def traced(cell, seed: int, seconds: float, device=None, scale: float = 1.0) -> dict:
    """The harness's traced run of the cell on the seed's files (its result
    line's metrics, checks and breakdown), with the calls' median times, the
    breakdown over the program's spans too and the device-idle seconds by
    innermost span."""
    runs = []
    measure = harness.measure

    def keep(*args, **kwargs):
        run, tally = measure(*args, **kwargs)
        runs.append(run)
        return run, tally

    harness.measure = keep
    try:
        code, result = harness.run_cell(cell, seed, seconds, True, time.perf_counter(), device,
                                        scale)
    finally:
        harness.measure = measure
    run, = runs
    mine = within(records() or [], run.calls)
    both = dataclasses.replace(run, spans=run.spans + [(r.name, r.start_ns, r.end_ns)
                                                       for r in mine])
    return {"workload": cell.name, "seed": seed, "code": code, "result": result,
            "median_ms": _median_ms(run), "breakdown": timeline.breakdown(both),
            "idle": {d: idle_by_span(run, mine, d) for d in ("compress", "decompress")}}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m glzbench.program")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    code = 0
    for seed in args.seeds:
        out = traced(cell, seed, args.seconds)
        print(json.dumps(out), flush=True)
        code = code or out["code"]
    return code


if __name__ == "__main__":
    # the readers' module, not this __main__ copy, holds the recording
    from glzbench import program

    sys.exit(program.main(sys.argv[1:]))
