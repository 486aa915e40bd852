"""One run of one cell: `python3 -m glzbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`, from the root of a checkout.

The cell names a configuration (`glzbench/configs/<name>.json`: the entry
points' mode and GlzConfig, and the plain reference that judges them) and
a traffic mix (`glzbench/traffic/<name>.json`), and BENCHMARK.json names
its metrics, each read by `glzbench/metrics/<name>.py`.  Nothing here
changes when a cell, a configuration, a traffic mix or a metric is added.

A run: make the traffic's files from the seed; warm up (one compress and
one decompress of every file, or one batch call each way); then, for
`--seconds`, one client calls compress and then decompress, file after
file (or batch after batch), each call timed by the host clock and ending
in torch.cuda.synchronize().  Every answer is checked as it comes back:
each decompress against its input, each container against the first
container of the same file.  Once the window has closed the plain
reference decodes each file's container and holds it against the input
and the configuration.  With `--trace 1` the window runs under
torch.profiler, and the functions the per-layer metrics name are wrapped
in spans.

A configuration whose `processes` is over 1 runs one process a card,
each with its shard of every file, through the program's multi-process
entry points: glzbench/spmd.py.

The last line of standard output is the result, a JSON object; the
numbers compared, each with its limit, end standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback

from glzbench import timeline, traffic
from glzbench.timeline import Call

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "glz_tpu")  # top-level module names


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    chips: int


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    calls: list
    window: tuple = (0, 0)
    peaks: dict | None = None
    device_events: list | None = None
    spans: list = dataclasses.field(default_factory=list)
    missing: set = dataclasses.field(default_factory=set)


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    config = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return Cell(workload, config, traffic.load(w["traffic"]), mine(bench["end_to_end"]),
                mine(bench["per_layer"]), w["chips"])


def metric_reader(name: str):
    """The module of `glzbench/metrics/<name>.py` (its `read(run)` gives the
    value, or None where it finds nothing to read)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "glzbench_metric_" + "".join(c if c.isalnum() else "_" for c in name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Entry:
    """The timed path: the program's public entry points under the cell's
    configuration (tests put a broken one in its place)."""

    def __init__(self, config: dict, device=None):
        import glz_tpu_torch
        from glz_tpu_torch.core import api

        self.gt, self.api, self.device = glz_tpu_torch, api, device
        self.mode = config["mode"]
        self.conf = glz_tpu_torch.GlzConfig(**config["conf"])

    def compress(self, data: bytes) -> bytes:
        return self.gt.compress(data, mode=self.mode, conf=self.conf, device=self.device)

    def decompress(self, blob: bytes) -> bytes:
        return self.gt.decompress(blob, device=self.device)

    def compress_batch(self, datas: list) -> list:
        return self.api.compress_batch(datas, mode=self.mode, conf=self.conf, pipeline=True,
                                       device=self.device)

    def decompress_batch(self, blobs: list) -> list:
        return self.api.decompress_batch(blobs, pipeline=True, device=self.device)


class Spans:
    """Wraps module attributes in spans: (name, start, end) on the host
    clock, each also a torch.profiler record_function span."""

    def __init__(self):
        self.records: list = []
        self.missing: set = set()
        self._lock = threading.Lock()
        self._saved: list = []

    def wrap(self, module_name: str, attrs) -> None:
        import torch

        module = importlib.import_module(module_name)
        short = module_name.rsplit(".", 1)[-1]
        for attr in attrs:
            fn = getattr(module, attr, None)
            if not callable(fn):
                self.missing.add(f"{module_name}.{attr}")
                continue
            label = f"{short}.{attr}"

            def wrapped(*args, _fn=fn, _label=label, **kwargs):
                t0 = time.perf_counter_ns()
                try:
                    with torch.profiler.record_function(timeline.SPAN_PREFIX + _label):
                        return _fn(*args, **kwargs)
                finally:
                    t1 = time.perf_counter_ns()
                    with self._lock:
                        self.records.append((_label, t0, t1))

            self._saved.append((module, attr, fn))
            setattr(module, attr, wrapped)

    def restore(self) -> None:
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved.clear()


@dataclasses.dataclass
class Tally:
    """The answers checked as they came back."""
    failed: int = 0           # calls that raised
    wrong_outputs: int = 0    # decompress answers unequal to their input
    unstable: int = 0         # containers unequal to the file's first
    first: dict = dataclasses.field(default_factory=dict)  # file -> its first container
    checking: list = dataclasses.field(default_factory=list)  # (start, end) of the checks


def _sync(device) -> None:
    import torch

    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _payload(blob: bytes) -> int:
    """Bytes of a container's payload section: all but the header, the
    codebook, the group table and a checksum (0 for what is no container)."""
    if len(blob) < 32 or blob[:4] != b"GLZ1":
        return 0
    flags, = struct.unpack_from("<B", blob, 6)
    n_groups, _, cb_size = struct.unpack_from("<III", blob, 16)
    return max(0, len(blob) - 32 - cb_size - 4 * n_groups - (4 if flags & 0x10 else 0))


def _timed(direction: str, fn, device, *args):
    import torch

    t0 = time.perf_counter_ns()
    with torch.profiler.record_function(timeline.SPAN_PREFIX + direction):
        out = fn(*args)
        _sync(device)
    return out, t0, time.perf_counter_ns()


def _step(cell: Cell, entry: Entry, files: list, k: int, calls: list, tally: Tally,
          device) -> None:
    """One compress and one decompress call (of file k, or of the batch),
    timed, and their answers checked."""
    batch = cell.traffic["entry"] == "batch"
    group = files if batch else [files[k % len(files)]]
    datas = [d for _, d in group]
    try:
        if batch:
            blobs, t0, t1 = _timed("compress", entry.compress_batch, device, datas)
        else:
            blob, t0, t1 = _timed("compress", entry.compress, device, datas[0])
            blobs = [blob]
    except Exception:
        tally.failed += 1
        _report_once(tally)
        return
    sizes = sum(len(b) for b in blobs)
    payload = sum(_payload(b) for b in blobs)
    label = "batch" if batch else group[0][0]
    calls.append(Call("compress", t0, t1, sum(map(len, datas)), sizes, payload, label))
    try:
        if batch:
            outs, t2, t3 = _timed("decompress", entry.decompress_batch, device, blobs)
        else:
            out, t2, t3 = _timed("decompress", entry.decompress, device, blobs[0])
            outs = [out]
    except Exception:
        tally.failed += 1
        _report_once(tally)
        return
    calls.append(Call("decompress", t2, t3, sum(map(len, outs)), sizes, payload, label))
    t4 = time.perf_counter_ns()
    if len(outs) != len(datas) or len(blobs) != len(datas):
        tally.wrong_outputs += len(datas)
    else:
        for (name, data), blob, out in zip(group, blobs, outs):
            tally.wrong_outputs += out != data
            first = tally.first.setdefault(name, blob)
            tally.unstable += first != blob
    tally.checking.append((t4, time.perf_counter_ns()))


def _report_once(tally: Tally) -> None:
    if tally.failed == 1:
        print("a timed call raised:\n" + traceback.format_exc(), file=sys.stderr)


def measure(cell: Cell, entry: Entry, files: list, seconds: float, trace: bool,
            device=None, peaks: dict | None = None, setup_s: float = 0.0) -> tuple[Run, Tally]:
    """The measured window: steps for `seconds`, under torch.profiler with
    `trace`.  Returns the run for the metric readers and the answers'
    tally."""
    import torch

    calls: list = []
    tally = Tally()
    spans = Spans()
    events = None
    gc.collect()
    _sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        prof = None
        if trace:
            for m in cell.per_layer:
                for module_name, attrs in getattr(metric_reader(m["name"]), "SPANS", {}).items():
                    spans.wrap(module_name, attrs)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device is None or torch.device(device).type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        try:
            t_start = time.perf_counter_ns()
            deadline = t_start + int(seconds * 1e9)
            k = 0
            while time.perf_counter_ns() < deadline:
                _step(cell, entry, files, k, calls, tally, device)
                k += 1
            t_end = time.perf_counter_ns()
        finally:
            if prof is not None:
                _sync(device)
                prof.stop()
                spans.restore()
        if prof is not None:
            path = pathlib.Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = timeline.load_device_events(path, calls)
    run = Run(setup_s, calls, (t_start, t_end), peaks, events,
              spans.records + [("check", a, b) for a, b in tally.checking], spans.missing)
    return run, tally


def judge(cell: Cell, files: list, tally: Tally, device=None) -> dict:
    """The numbers compared, each (value, limit): the answers' tally and the
    plain reference's verdict on each file's first container, decoded on
    `device` (None: the card)."""
    import torch

    device = torch.device("cuda" if device is None else device)
    reference = importlib.import_module(f"glzbench.reference.{cell.config['reference']}")
    made = [(name, tally.first[name], data) for name, data in files if name in tally.first]
    verdicts = reference.check_all([(blob, data) for _, blob, data in made], cell.config,
                                   device) if made else []
    for (name, _, _), (_, found) in zip(made, verdicts):
        for f in found:
            print(f"reference: {name}: {f}", file=sys.stderr)
    wrong_bytes = sum(w for w, _ in verdicts)
    faults = sum(len(found) for _, found in verdicts)
    unchecked = len(files) - len(made)
    return {"failed_calls": (tally.failed, 0),
            "wrong_outputs": (tally.wrong_outputs, 0),
            "unstable_containers": (tally.unstable, 0),
            "files_unchecked": (unchecked, 0),
            "reference_wrong_bytes": (wrong_bytes, 0),
            "format_faults": (faults, 0)}


def log(t0: float, what: str) -> None:
    print(f"glzbench: {time.perf_counter() - t0:9.3f} s  {what}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_label() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def read_metrics(run: Run, specs: list) -> dict:
    out = {}
    for m in specs:
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
             device=None, scale: float = 1.0) -> tuple[int, dict | None]:
    """(exit code, result) of one run; the result is None where the run
    must print none.  A configuration of several `processes` runs one rank
    a card (glzbench/spmd.py)."""
    if cell.config.get("processes", 1) > 1:
        from glzbench import spmd

        return spmd.run_cell(cell, seed, seconds, trace, t0, device, scale)
    import torch

    log(t0, "torch imported")
    cuda = device is None or torch.device(device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"glzbench: the cell needs {cell.chips} CUDA card(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
            return 2, None
        kind = torch.cuda.get_device_name(0)
        print(f"glzbench: card {card_label()}", file=sys.stderr)
    else:
        kind = "cpu"
    peaks = json.loads((HERE / "peaks.json").read_text()).get(kind)
    entry = Entry(cell.config, device)
    log(t0, "program imported")
    files = traffic.make_files(cell.traffic, seed, scale)
    log(t0, f"{len(files)} file(s) made, {sum(len(d) for _, d in files)} B")
    biggest = max(len(d) for _, d in files)
    if biggest > cell.config["max_input_bytes"] * scale:
        raise SystemExit(f"a file of {biggest} B is past the configuration's "
                         f"max_input_bytes {cell.config['max_input_bytes']}")
    warm = Tally()
    for k in range(1 if cell.traffic["entry"] == "batch" else len(files)):
        _step(cell, entry, files, k, [], warm, device)
    setup_s = time.perf_counter() - t0
    log(t0, "warmed up: the window opens")
    run, tally = measure(cell, entry, files, seconds, trace, device, peaks, setup_s)
    log(t0, f"the window closed: {len(run.calls)} calls" + (", trace read" if trace else ""))
    for label in dict.fromkeys(c.label for c in run.calls):
        ms = {d: sorted(c.seconds * 1e3 for c in run.calls if c.label == label and
                        c.direction == d) for d in ("compress", "decompress")}
        print(f"glzbench: {label}: " + ", ".join(
            f"{d} {len(v)} calls, median {v[len(v) // 2]:.3f} ms, min {v[0]:.3f}, max {v[-1]:.3f}"
            for d, v in ms.items() if v), file=sys.stderr)
    tally.failed += warm.failed
    tally.wrong_outputs += warm.wrong_outputs
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = judge(cell, files, tally, device)
    log(t0, "the reference has judged")
    correct = bool(run.calls) and all(v <= limit for v, limit in checks.values())
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(run.calls) + tally.failed,
              "failed": tally.failed + tally.wrong_outputs,
              "metrics": read_metrics(run, cell.per_layer if trace else cell.end_to_end),
              "device": device_info}
    if trace:
        device_info["busy_s"] = timeline.busy_seconds(run)
        device_info["window_s"] = (run.window[1] - run.window[0]) / 1e9
        result["breakdown"] = timeline.breakdown(run)
    result["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in checks.items()}
    found = forbidden_modules()  # last: the reference and the readers import too
    if found:
        print(f"glzbench: the process holds {found} after the window", file=sys.stderr)
        return 3, None
    for name, (v, limit) in checks.items():
        print(f"check {name} {v} (limit {limit})", file=sys.stderr)
    return 0, result


def main(argv: list[str], t0: float) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m glzbench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    code, result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0)
    if result is not None:
        sys.stdout.flush()
        print(json.dumps(result), flush=True)
    return code
