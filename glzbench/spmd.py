"""A cell of several processes: one rank a card, each through the program's
multi-process entry points (glz_tpu_torch/parallel/multihost.py), as a
deployment that runs one process a card does.

The parent (`run_cell`, which harness.run_cell calls for a configuration
whose `processes` is over 1) starts one fresh interpreter a rank (`python3
-m glzbench.spmd`, rank k seeing only card k), hands each the run on its
standard input, checks the cards while they start, and waits.  A rank that
raises or dies stops the others: the parent ends them at once and the run
exits non-zero with no result.  No collective waits longer than
JOIN_TIMEOUT.

Every rank runs one SPMD loop.  It joins the process group through the
program's multihost.initialize, makes the traffic's files from the seed
and takes its shard of each (`shard_bounds`: every shard but the last
holds whole lockstep groups), warms up with one step, and runs steps until
rank 0 closes the window.  A step:

  compress    each rank calls compress_bytes_multihost on its shard; rank 0
              gets the stitched container and checks it against the file's
              first;
  distribute  (untimed, a harness span) rank 0 broadcasts the container to
              the other ranks, standing in for a container on shared
              storage;
  decompress  each rank calls decompress_bytes_multihost and checks its
              (slice, offset) against its own copy of the input.

A call is timed on rank 0's host clock from a start barrier to an end
barrier, which each rank reaches once its part has returned and its card
has synchronised; its data bytes are the whole file's.  A timed call that
raises ends its rank, and so the run.  After the window every rank's
tally, slices, memory peak, busy seconds and forbidden-module check are
gathered on rank 0, which alone reads the per-layer metrics (of its own
calls and card) and runs the plain reference on the stitched container;
the parent prints rank 0's result.  The harness's own collectives are
gloo, on host tensors.

`python3 -m glzbench.control` drives the same ranks through several
(seed, broken path) jobs in one launch (`control`).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np

from glzbench import harness, timeline, traffic
from glzbench.timeline import Call

JOIN_TIMEOUT = 120.0  # seconds: joining the group, and any one collective
RUN_TIMEOUT = 1150.0  # seconds: a whole run, a first run's builds included
GRACE = 30.0          # seconds the other ranks get to end once rank 0 has ended
LANES = 128


def shard_bounds(n: int, world: int, align: int) -> list[int]:
    """Shard i of an n-byte file is [bounds[i], bounds[i + 1]): bounds[i] =
    n * i // world // align * align, the rule of tests/multihost_driver.py,
    so every shard but the last holds whole groups of `align` bytes."""
    return [min(n * i // world // align * align, n) for i in range(world)] + [n]


def group_bytes(config: dict) -> int:
    """Bytes of one lockstep group: group_rows x 128 lanes x stream_symbols."""
    return config["conf"]["group_rows"] * LANES * config["conf"]["stream_symbols"]


class ShardEntry:
    """The timed path of a cell of several processes: the program's
    multi-process byte entry points under the cell's configuration, on this
    rank (glzbench/faults.py puts broken ones in its place)."""

    def __init__(self, config: dict, device=None):
        import glz_tpu_torch
        from glz_tpu_torch.parallel import multihost

        if config["mode"] != 0:
            raise ValueError("a cell of several processes runs byte mode")
        self.mh, self.device = multihost, device
        self.conf = glz_tpu_torch.GlzConfig(**config["conf"])
        self.rank, self.world = multihost.process_index(), multihost.process_count()

    def compress(self, shard: bytes):
        """The stitched container on rank 0; None on the others."""
        return self.mh.compress_bytes_multihost(shard, self.conf, device=self.device)

    def decompress(self, blob) -> tuple[bytes, int]:
        """This rank's slice of the output and its byte offset."""
        return self.mh.decompress_bytes_multihost(blob, device=self.device)

    def close(self) -> None:
        """Undo what the entry changed in the program (nothing here)."""


@dataclasses.dataclass
class File:
    name: str
    data: bytes   # the whole file: every rank checks its slice against it
    shard: bytes  # this rank's shard


def _on_card(device) -> bool:
    import torch

    return device is None or torch.device(device).type == "cuda"


# ---- the harness's collectives: gloo, on host tensors ----------------------------

def _agree(value: int, rank: int) -> int:
    """A barrier that hands every rank rank 0's value."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([value if rank == 0 else 0], dtype=torch.int64)
    dist.all_reduce(t)
    return int(t[0])


def _broadcast(blob, rank: int):
    """Rank 0's bytes on every rank (a memoryview on the others)."""
    import torch
    import torch.distributed as dist

    n = _agree(len(blob) if rank == 0 and blob is not None else 0, rank)
    if n == 0:
        return blob if rank == 0 else b""
    if rank == 0:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # read-only bytes: the broadcast only reads them
            dist.broadcast(torch.frombuffer(blob, dtype=torch.uint8), 0)
        return blob
    t = torch.empty(n, dtype=torch.uint8)
    dist.broadcast(t, 0)
    return memoryview(t.numpy())


def _gather_json(obj, rank: int, world: int) -> list | None:
    """Every rank's `obj` (a JSON value) on rank 0, in rank order; None on
    the others."""
    import torch
    import torch.distributed as dist

    raw = np.frombuffer(json.dumps(obj).encode(), np.uint8).copy()
    size = torch.tensor([raw.size], dtype=torch.int64)
    sizes = [torch.zeros_like(size) for _ in range(world)]
    dist.all_gather(sizes, size)
    buf = torch.zeros(max(int(s) for s in sizes), dtype=torch.uint8)
    buf[: raw.size] = torch.from_numpy(raw)
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    if rank != 0:
        return None
    return [json.loads(p[: int(s)].numpy().tobytes()) for p, s in zip(parts, sizes)]


# ---- one rank ----------------------------------------------------------------------

def _timed(direction: str, fn, device, rank: int, *args):
    """fn(*args), its card synchronised, then the end barrier; (out, start,
    end) on this rank's clock."""
    import torch

    t0 = time.perf_counter_ns()
    with torch.profiler.record_function(timeline.SPAN_PREFIX + direction):
        out = fn(*args)
        harness._sync(device)
        _agree(0, rank)
    return out, t0, time.perf_counter_ns()


def _matches(f: File, out, offset: int) -> bool:
    """Whether a slice holds the input's bytes at its offset."""
    got, data = np.frombuffer(out, np.uint8), np.frombuffer(f.data, np.uint8)
    return (0 <= offset and offset + got.size <= data.size
            and np.array_equal(data[offset : offset + got.size], got))


def _step(entry, files: list, k: int, rank: int, device, deadline: int, calls: list,
          tally: harness.Tally, slices: list, spans: list) -> bool:
    """One compress and one decompress of file k across the ranks, timed and
    checked; False, with nothing run, once rank 0 has closed the window."""
    if not _agree(int(time.perf_counter_ns() < deadline), rank):
        return False
    f = files[k % len(files)]
    blob, t0, t1 = _timed("compress", entry.compress, device, rank, f.shard)
    got = blob if rank == 0 and blob is not None else b""
    calls.append(Call("compress", t0, t1, len(f.data), len(got), harness._payload(got), f.name))
    if rank == 0:
        t = time.perf_counter_ns()
        first = tally.first.setdefault(f.name, got)
        tally.unstable += first != got
        tally.checking.append((t, time.perf_counter_ns()))
    t = time.perf_counter_ns()
    blob = _broadcast(blob, rank)
    spans.append(("distribute", t, time.perf_counter_ns()))
    _agree(0, rank)  # the decompress's start barrier
    (out, offset), t2, t3 = _timed("decompress", entry.decompress, device, rank, blob)
    calls.append(Call("decompress", t2, t3, len(f.data), len(blob), harness._payload(blob),
                      f.name))
    t = time.perf_counter_ns()
    tally.wrong_outputs += not _matches(f, out, offset)
    slices.append([int(offset), len(out), k % len(files)])
    tally.checking.append((t, time.perf_counter_ns()))
    return True


def measure(cell, entry, files: list, seconds: float, trace: bool, rank: int, device=None,
            peaks: dict | None = None, setup_s: float = 0.0):
    """The measured window on this rank: steps until rank 0's `seconds`
    have passed, under torch.profiler with `trace` (rank 0 also wraps the
    functions its per-layer readers name).  Returns (the run, the tally,
    the slices of each decompress)."""
    import torch

    calls: list = []
    tally = harness.Tally()
    spans = harness.Spans()
    own: list = []  # the harness's spans: distribute
    slices: list = []
    events = None
    gc.collect()
    harness._sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        prof = None
        if trace:
            if rank == 0:
                for m in cell.per_layer:
                    for module_name, attrs in getattr(harness.metric_reader(m["name"]), "SPANS",
                                                      {}).items():
                        spans.wrap(module_name, attrs)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if _on_card(device):
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        try:
            t_start = time.perf_counter_ns()
            deadline = t_start + int(seconds * 1e9)
            k = 0
            while _step(entry, files, k, rank, device, deadline, calls, tally, slices, own):
                k += 1
            t_end = time.perf_counter_ns()
        finally:
            if prof is not None:
                harness._sync(device)
                prof.stop()
                spans.restore()
        if prof is not None:
            path = pathlib.Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = timeline.load_device_events(path, calls)
    run = harness.Run(setup_s, calls, (t_start, t_end), peaks, events,
                      spans.records + own + [("check", a, b) for a, b in tally.checking],
                      spans.missing)
    return run, tally, slices


def untiled_bytes(n: int, slices: list) -> int:
    """Bytes of [0, n) that one decompress's slices (offset, length) do not
    tile exactly: those no slice covers, and those a slice covers beyond
    the first or outside [0, n)."""
    inside = timeline.union((max(o, 0), min(o + m, n)) for o, m in slices if m > 0)
    covered = timeline.length(inside)
    return (n - covered) + (sum(m for _, m in slices) - covered)


def _summary(rank: int, tally: harness.Tally, slices: list, run, device) -> dict:
    import torch

    busy = timeline.busy_seconds(run) if run is not None and run.device_events else None
    return {"rank": rank, "wrong_outputs": int(tally.wrong_outputs), "slices": slices,
            "peak": torch.cuda.max_memory_allocated() if _on_card(device) else 0, "busy_s": busy,
            "forbidden": harness.forbidden_modules()}


def _judge(cell, files: list, tally: harness.Tally, summaries: list, device) -> dict:
    """The numbers compared, each (value, limit): the plain reference's
    verdict on each file's first container (harness.judge) and the ranks'
    answers: their slices against the input, and how they tile it."""
    checks = harness.judge(cell, [(f.name, f.data) for f in files], tally, device)
    del checks["failed_calls"]  # a call that raises ends the run: see failed_ranks
    checks["wrong_outputs"] = (sum(s["wrong_outputs"] for s in summaries), 0)
    untiled = 0
    for j in range(max(len(s["slices"]) for s in summaries)):  # the j-th decompress
        step = [s["slices"][j] for s in summaries if j < len(s["slices"])]
        untiled += untiled_bytes(len(files[step[0][2]].data), [sl[:2] for sl in step])
    checks["untiled_bytes"] = (untiled, 0)
    checks["failed_ranks"] = (0, 0)
    return checks


def _make_files(cell, seed: int, scale: float, rank: int, world: int) -> list[File]:
    align = group_bytes(cell.config)
    out = []
    for name, data in traffic.make_files(cell.traffic, seed, scale):
        if len(data) > cell.config["max_input_bytes"] * scale:
            raise SystemExit(f"a file of {len(data)} B is past the configuration's "
                             f"max_input_bytes {cell.config['max_input_bytes']}")
        b = shard_bounds(len(data), world, align)
        out.append(File(name, data, data[b[rank] : b[rank + 1]]))
    return out


def _entry(cell, path: str, device):
    from glzbench import faults

    return (ShardEntry if path == "sound" else faults.SHARDED[path])(cell.config, device)


def _run(job: dict, cell, rank: int, world: int) -> int:
    """The benchmark's run on this rank; rank 0 writes the result."""
    import torch

    t0, device, trace = job["t0"], job["device"], job["trace"]
    cuda = _on_card(device)
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    peaks = json.loads((harness.HERE / "peaks.json").read_text()).get(kind)
    entry = _entry(cell, job["path"], device)
    files = _make_files(cell, job["seed"], job["scale"], rank, world)
    harness.log(t0, f"rank {rank}: {len(files)} file(s) made, shard of "
                    f"{sum(len(f.shard) for f in files)} B")
    warm, warm_slices = harness.Tally(), []
    _step(entry, files, 0, rank, device, float("inf"), [], warm, warm_slices, [])
    setup_s = time.perf_counter() - t0
    if rank == 0:
        harness.log(t0, "warmed up: the window opens")
    run, tally, slices = measure(cell, entry, files, job["seconds"], trace, rank, device, peaks,
                                 setup_s)
    tally.wrong_outputs += warm.wrong_outputs
    tally.unstable += warm.unstable
    summaries = _gather_json(_summary(rank, tally, warm_slices + slices, run, device), rank,
                             world)
    if rank != 0:
        return 0
    harness.log(t0, f"the window closed: {len(run.calls)} calls" + (", trace read" if trace
                                                                       else ""))
    times = {d: [c.seconds * 1e3 for c in timeline.calls_of(run.calls, d)]
             for d in ("compress", "decompress")}
    times["distribute"] = [(b - a) / 1e6 for name, a, b in run.spans if name == "distribute"]
    for d, ms in times.items():
        ms.sort()
        if ms:
            print(f"glzbench: {d} {len(ms)} times, median {ms[len(ms) // 2]:.3f} ms, "
                  f"min {ms[0]:.3f}, max {ms[-1]:.3f}", file=sys.stderr)
    entry.close()
    del entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = _judge(cell, files, tally, summaries, device)
    harness.log(t0, "the reference has judged")
    correct = bool(run.calls) and all(v <= limit for v, limit in checks.values())
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": world,
                   "memory_peak_bytes": max(s["peak"] for s in summaries)}
    result = {"correct": correct, "attempted": len(run.calls),
              "failed": checks["wrong_outputs"][0],
              "metrics": harness.read_metrics(run, cell.per_layer if trace else cell.end_to_end),
              "device": device_info}
    if trace:
        busy = [s["busy_s"] for s in summaries]
        device_info["busy_s"] = sum(b or 0.0 for b in busy) / world  # over the cards used
        device_info["window_s"] = (run.window[1] - run.window[0]) / 1e9
        result["breakdown"] = timeline.breakdown(run)
    result["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in checks.items()}
    found = {s["rank"]: s["forbidden"] for s in summaries if s["forbidden"]}
    if harness.forbidden_modules():  # last: the reference and the readers import too
        found[0] = harness.forbidden_modules()
    if found:
        print(f"glzbench: after the window the ranks hold {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


def _control(job: dict, cell, rank: int, world: int) -> int:
    """glzbench.control's readings on this rank: for each (seed, path) of the
    job, one short window of the path on the seed's files; rank 0 writes a
    line as each starts and one with its readings."""
    device, files, made_for = job["device"], None, None
    for seed, path in job["jobs"]:
        if made_for != seed:  # one seed's files at a time
            files, made_for = _make_files(cell, seed, job["scale"], rank, world), seed
        if rank == 0:
            print(json.dumps({"start": [seed, path]}), flush=True)
        t = time.perf_counter()
        entry = _entry(cell, path, device)
        try:
            run, tally, slices = measure(cell, entry, files, job["seconds"], False, rank, device)
        finally:
            entry.close()
        summaries = _gather_json(_summary(rank, tally, slices, None, device), rank, world)
        if rank == 0:
            checks = _judge(cell, files, tally, summaries, device)
            correct = bool(run.calls) and all(v <= limit for v, limit in checks.values())
            print(json.dumps({"workload": cell.name, "seed": seed, "path": path,
                              "correct": correct, "seconds": time.perf_counter() - t,
                              "checks": {k: v for k, (v, _) in checks.items()}}), flush=True)
    return 0


def rank_main(job: dict) -> int:
    """One rank: join the group, run the job, leave the group."""
    import torch

    from glz_tpu_torch.parallel import multihost

    rank, world = job["rank"], job["world"]
    cell = harness.Cell(**job["cell"])
    if _on_card(job["device"]) and not torch.cuda.is_available():
        print(f"glzbench: rank {rank} sees no CUDA card", file=sys.stderr)
        return 2
    multihost.initialize(job["address"], world, rank, timeout=JOIN_TIMEOUT)
    code = (_control if job["mode"] == "control" else _run)(job, cell, rank, world)
    multihost.shutdown()  # not after a raise: the process ends at once then
    return code


# ---- the parent ----------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=5)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(cell, job: dict, device=None, check_cards=None) -> tuple[list, str]:
    """Run `job` in one fresh interpreter a rank of the cell; (every rank's
    exit code, rank 0's standard output).  `check_cards()`, called while the
    ranks start, may refuse the run (a non-zero code, the ranks stopped).
    A rank that fails stops the others."""
    n = cell.config["processes"]
    cuda = device is None
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else [str(k) for k in range(n)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(harness.ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    address = f"127.0.0.1:{_free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        outs = [open(pathlib.Path(tmp) / f"rank{k}.out", "w+") for k in range(n)]
        procs = []
        try:
            for k in range(n):
                rank_env = dict(env, CUDA_VISIBLE_DEVICES=cards[k % len(cards)]) if cuda else env
                p = subprocess.Popen([sys.executable, "-m", "glzbench.spmd"], cwd=harness.ROOT,
                                     env=rank_env, stdin=subprocess.PIPE, stdout=outs[k])
                procs.append(p)
                p.stdin.write(json.dumps(dict(job, rank=k, world=n, address=address,
                                              device=device)).encode())
                p.stdin.close()
            refused = check_cards() if check_cards else 0
            if refused:
                _stop(procs)
                return [refused] * n, ""
            codes = _wait(procs)
        finally:
            _stop(procs)
            for f in outs:
                f.close()
        return codes, (pathlib.Path(tmp) / "rank0.out").read_text()


def _wait(procs: list) -> list:
    """The ranks' exit codes: every rank's once all have ended, or as soon as
    one fails (the others stopped: None), rank 0 has ended GRACE seconds ago
    with the others still running, or RUN_TIMEOUT has passed."""
    start = time.monotonic()
    zero_done = None
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
            break
        now = time.monotonic()
        if codes[0] is not None:
            zero_done = zero_done or now
            if now - zero_done > GRACE:
                break
        if now - start > RUN_TIMEOUT:
            break
        time.sleep(0.05)
    _stop(procs)
    return codes


def failed_ranks(codes: list) -> int:
    """The ranks that ended non-zero; where none did, those stopped for
    running out of time (None)."""
    return sum(c not in (None, 0) for c in codes) or sum(c is None for c in codes)


def run_cell(cell, seed: int, seconds: float, trace: bool, t0: float, device=None,
             scale: float = 1.0, path: str = "sound") -> tuple[int, dict | None]:
    """(exit code, result) of one run of a cell of several processes; the
    result is None where the run must print none.  `path` names a broken
    path of glzbench/faults.py (the tests')."""
    n = cell.config["processes"]
    if n != cell.chips:
        print(f"glzbench: the configuration runs {n} processes, the cell asks for "
              f"{cell.chips} card(s)", file=sys.stderr)
        return 2, None

    refused = []

    def check_cards() -> int:
        import torch

        harness.log(t0, "torch imported (the parent)")
        if device is None and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < n):
            print(f"glzbench: the cell needs {n} CUDA cards; torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}, device_count() "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            refused.append(2)
            return 2
        if device is None:
            print(f"glzbench: cards {harness.card_label()}", file=sys.stderr)
        return 0

    job = {"mode": "run", "cell": dataclasses.asdict(cell), "seed": seed, "seconds": seconds,
           "trace": trace, "t0": t0, "scale": scale, "path": path}
    codes, out = launch(cell, job, device, check_cards)
    if refused:
        return 2, None
    failed = failed_ranks(codes)
    if failed:
        print(f"glzbench: the ranks ended with codes {codes} (None: stopped); "
              "the run has no result", file=sys.stderr)
        print(f"check failed_ranks {failed} (limit 0)", file=sys.stderr)
        return next((c for c in codes if c not in (None, 0)), 1), None
    result = json.loads(out.strip().split("\n")[-1])
    found = harness.forbidden_modules()
    if found:
        print(f"glzbench: the process holds {found} after the window", file=sys.stderr)
        return 3, None
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} (limit {c['limit']})", file=sys.stderr)
    return 0, result


def control(cell, seeds: list, seconds: float, paths: list, device=None):
    """glzbench.control's readings of a cell of several processes: yields one
    reading a (seed, path).  The jobs run in one launch; a path that ends
    its ranks reads as not correct, with the ranks that failed as its
    number, and a new launch takes the jobs left."""
    left = [(s, p) for s in seeds for p in paths]
    while left:
        job = {"mode": "control", "cell": dataclasses.asdict(cell), "jobs": left,
               "seconds": seconds, "scale": 1.0}
        t = time.perf_counter()
        codes, out = launch(cell, job, device)
        started = None
        for line in out.split("\n"):
            if not line.startswith("{"):
                continue
            d = json.loads(line)
            if "start" in d:
                started = tuple(d["start"])
                continue
            left.remove((d["seed"], d["path"]))
            started = None
            yield d
        if not failed_ranks(codes):
            break
        seed, path = started or left[0]
        left.remove((seed, path))
        yield {"workload": cell.name, "seed": seed, "path": path, "correct": False,
               "seconds": time.perf_counter() - t, "codes": codes,  # the whole launch's
               "checks": {"failed_ranks": failed_ranks(codes)}}


if __name__ == "__main__":
    # the harness's module, not this __main__ copy, is the one the faults import
    from glzbench import spmd

    try:
        code = spmd.rank_main(json.loads(sys.stdin.read()))
    except BaseException:  # a rank that raises: its traceback, then a code the parent sees
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    sys.exit(code)
