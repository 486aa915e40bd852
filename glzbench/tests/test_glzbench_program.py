"""The readers of the program's own spans and counters (glzbench/program.py)
on hand-made runs, the breakdown and the idle table with the program's
spans, a traced CPU run that reports them, and the clock they share with
the device trace."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from glzbench import harness, program, timeline
from glzbench.timeline import Call, DeviceEvent

MS = 1_000_000  # ns
NEW = ("model_host_share.compress", "model_host_share.compress.silesia",
       "model_host_share.decompress", "host_copy_bytes.compress",
       "host_copy_bytes.compress.silesia", "host_copy_bytes.decompress",
       "pipeline_overlap.compress", "pipeline_overlap.decompress")
OLD = ("compress_GBps", "compress_GBps.silesia", "decompress_GBps", "compress_p95_ms",
       "decompress_p95_ms", "ratio", "setup_s", "kernel_roofline.compress",
       "kernel_roofline.compress.silesia", "kernel_roofline.decompress",
       "device_idle.compress", "device_idle.compress.silesia", "device_idle.decompress",
       "copy_GBps.compress", "copy_GBps.compress.silesia", "copy_GBps.decompress",
       "host_library_share.compress", "host_library_share.compress.silesia",
       "host_library_share.decompress")


def rec(name, start_ms, end_ms, id_, parent=None, root=None, counts=None, thread=1):
    from glz_tpu_torch.utils.timer import SpanRecord

    return SpanRecord(name, id_, parent, root if root is not None else (parent or id_), thread,
                      int(start_ms * MS), int(end_ms * MS), counts or {})


@pytest.fixture
def recorded(monkeypatch):
    """Put hand-made spans where the readers find the program's recording."""
    def put(spans):
        monkeypatch.setattr(program, "_recordings", [[None, list(spans)]] if spans is not None
                            else [])
    put(None)
    return put


def read(name, run):
    return harness.metric_reader(name).read(run)


def call(direction, start_ms, end_ms, data=1000, label="f"):
    return Call(direction, start_ms * MS, end_ms * MS, data, 600, 560, label)


def make_run(calls, events=None, spans=()):
    window = (min(c.start for c in calls), max(c.end for c in calls))
    return harness.Run(9.0, list(calls), window, {"hbm_bytes_per_s": 3.35e12}, events,
                       list(spans), set())


def one_file_run():
    """A compress [0, 100) ms and a decompress [100, 200) ms, each with its
    program spans, and a span outside both."""
    calls = [call("compress", 0, 100), call("decompress", 100, 200)]
    spans = [rec("compress", 1, 99, 1),
             rec("codebook", 2, 12, 2, 1),
             rec("pad", 12, 22, 3, 1, counts={"host_copy_bytes": 1000}),
             rec("encode", 25, 60, 4, 1),
             rec("sync.layout", 30, 40, 5, 4),
             rec("serialize", 70, 80, 6, 1, counts={"host_copy_bytes": 560}),
             rec("container.write", 78, 90, 7, 1, counts={"host_copy_bytes": 600}),
             rec("decompress", 101, 199, 8),
             rec("container.read", 102, 110, 9, 8, counts={"host_copy_bytes": 560}),
             rec("decode", 110, 150, 10, 8),
             rec("d2h", 150, 170, 11, 8),
             rec("serialize", 170, 190, 12, 8, counts={"host_copy_bytes": 1000}),
             rec("pad", 300, 400, 13, counts={"host_copy_bytes": 10**6})]  # outside the calls
    events = [DeviceEvent(22 * MS, 60 * MS, "kernel", "encode_kernel"),
              DeviceEvent(110 * MS, 170 * MS, "kernel", "decode_kernel")]
    return make_run(calls, events), spans


def test_the_readers_read_the_program_spans_inside_the_calls(recorded):
    run, spans = one_file_run()
    recorded(spans)
    # compress: codebook, pad [2, 22), serialize and container [70, 90): 40 of 100 ms
    assert read("model_host_share.compress", run) == pytest.approx(40.0)
    assert read("model_host_share.compress.silesia", run) == pytest.approx(40.0)
    # decompress: the read [102, 110) and the serialize [170, 190): 28 of 100 ms
    assert read("model_host_share.decompress", run) == pytest.approx(28.0)
    assert read("host_copy_bytes.compress", run) == pytest.approx(2160 / 1000)
    assert read("host_copy_bytes.compress.silesia", run) == pytest.approx(2.16)
    assert read("host_copy_bytes.decompress", run) == pytest.approx(1.56)
    assert read("pipeline_overlap.compress", run) is None  # no batch.file span
    assert read("pipeline_overlap.decompress", run) is None


def test_absent_rather_than_zero(recorded):
    run, spans = one_file_run()
    for case in (None, [], [s for s in spans if s.name in ("compress", "decompress")]):
        recorded(case)
        for name in NEW:
            assert read(name, run) is None, (name, case)
    recorded([s for s in spans if s.start_ns >= 300 * MS])  # only outside the calls
    assert all(read(name, run) is None for name in NEW)
    recorded(spans)
    only_compress = make_run(run.calls[:1], run.device_events)
    assert read("host_copy_bytes.decompress", only_compress) is None
    assert read("host_copy_bytes.compress", only_compress) == pytest.approx(2.16)


def test_pipeline_overlap_is_files_in_flight_in_the_batch_calls(recorded):
    calls = [call("compress", 0, 100, label="batch"), call("decompress", 100, 200, label="batch"),
             call("compress", 200, 300, label="other")]
    spans = [rec("compress_batch", 0, 100, 1),
             rec("batch.file", 1, 61, 2, 1, thread=2), rec("batch.file", 20, 90, 3, 1, thread=3),
             rec("batch.file", 62, 99, 4, 1, thread=2),
             rec("decompress_batch", 100, 200, 5),
             rec("batch.file", 101, 150, 6, 5, thread=2), rec("batch.file", 150, 199, 7, 5)]
    recorded(spans)
    run = make_run(calls)
    # compress: 60 + 70 + 37 ms of files over the one batch call's 100 ms
    assert read("pipeline_overlap.compress", run) == pytest.approx(1.67)
    assert read("pipeline_overlap.decompress", run) == pytest.approx(0.98)


def test_every_existing_metric_reads_the_same_with_the_program_spans(recorded):
    run, spans = one_file_run()
    run = dataclasses.replace(run, spans=[("native.histogram", 3 * MS, 9 * MS),
                                          ("native.detokenize", 171 * MS, 180 * MS)])
    recorded(None)
    before = {name: read(name, run) for name in OLD}
    recorded(spans)
    after = {name: read(name, run) for name in OLD}
    assert before == after
    assert sum(v is not None for v in before.values()) >= 10


def test_the_breakdown_labels_a_gap_with_a_program_span():
    run, spans = one_file_run()
    plain = timeline.breakdown(run)
    assert {name for name, _ in plain["idle_gaps"]} <= {"compress", "decompress"}
    both = dataclasses.replace(run, spans=run.spans + [(r.name, r.start_ns, r.end_ns)
                                                       for r in program.within(spans, run.calls)])
    gaps = [[name, round(s, 6)] for name, s in timeline.breakdown(both)["idle_gaps"]]
    assert gaps == [["container.write", 0.05],  # [60, 110): its middle, 85 ms
                    ["serialize", 0.03],        # [170, 200): 185 ms
                    ["codebook", 0.022]]        # [0, 22): 11 ms


def test_the_idle_table_sums_device_idle_by_innermost_span():
    run, spans = one_file_run()
    mine = program.within(spans, run.calls)
    table = program.idle_by_span(run, mine, "compress")
    # idle in the compress call: [0, 22) and [60, 100) ms
    assert table["idle_s"] == pytest.approx(0.062)
    # [0, 2) and [60, 70), [90, 100) under the call or its root; container.write
    # over serialize in [78, 80), the later to start
    assert table["spans"] == pytest.approx({"compress": 0.022, "codebook": 0.010, "pad": 0.010,
                                            "serialize": 0.008, "container.write": 0.012})
    assert list(table["spans"])[0] == "compress"  # the most idle time first
    assert table["covered"] == pytest.approx(0.040 / 0.062)
    dec = program.idle_by_span(run, mine, "decompress")
    # idle [100, 110) and [170, 200); d2h ran while the card was busy
    assert dec["spans"] == pytest.approx({"decompress": 0.012, "container.read": 0.008,
                                          "serialize": 0.02})
    assert program.idle_by_span(make_run(run.calls), mine, "compress") is None


def test_a_program_without_the_recorder_records_nothing(monkeypatch):
    from glz_tpu_torch.utils import timer

    monkeypatch.setattr(program, "_recordings", [])
    monkeypatch.delattr(timer, "recording")
    program.begin()
    assert program.records() is None


def test_begin_leaves_another_recording_alone(monkeypatch):
    from glz_tpu_torch.utils import timer

    monkeypatch.setattr(program, "_recordings", [])
    with timer.recording() as theirs:
        program.begin()
        with timer.span("x"):
            pass
    assert program.records() is None and [r.name for r in theirs] == ["x"]
    program.begin()
    with timer.span("y"):
        pass
    program.begin()  # on already: the same recording
    assert [r.name for r in program.records()] == ["y"]
    program.begin()  # a second recording, kept with the first
    with timer.span("z"):
        pass
    assert [r.name for r in program.records()] == ["y", "z"]
    with timer.recording():  # the recorder is free again
        pass


def run_traced(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().split("\n")[-1])


@pytest.mark.parametrize("workload, names", [
    ("byte-throughput.and3-100MB", ("model_host_share.compress", "model_host_share.decompress",
                                    "host_copy_bytes.compress", "host_copy_bytes.decompress")),
    ("byte-throughput.silesia-sizes-batch", NEW[:1] + NEW[2:4] + NEW[5:]),
])
def test_a_traced_cpu_run_reports_the_new_metrics(workload, names):
    result = run_traced(
        "import time, json; from glzbench import harness; "
        f"c = harness.load_cell({workload!r}); "
        "code, r = harness.run_cell(c, 2**31 + 11, 0.01, True, time.perf_counter(), "
        "device='cpu', scale=2e-4); print(json.dumps([code, r]))")
    code, r = result
    assert code == 0 and r["correct"]
    assert set(names) <= set(r["metrics"])
    cell = harness.load_cell(workload)
    assert set(names) == {m["name"] for m in cell.per_layer if m["name"] in NEW}
    for name in names:
        if name.startswith("pipeline_overlap"):
            assert 0.9 <= r["metrics"][name]["value"] <= 2.0
        elif name.startswith("host_copy_bytes"):
            assert 1.5 <= r["metrics"][name]["value"] <= 4.0
        else:
            assert 0 < r["metrics"][name]["value"] <= 100


def test_the_tool_reports_the_idle_table_on_the_cpu():
    line = run_traced(
        "import json; from glzbench import harness, program; "
        "c = harness.load_cell('byte-throughput.silesia-sizes'); "
        "print(json.dumps(program.traced(c, 5, 0.01, device='cpu', scale=1e-4)))")
    assert line["code"] == 0 and line["result"]["failed"] == 0  # the window is too short to
    assert line["median_ms"]["compress"] > 0                       # reach every file: unjudged
    assert "host_copy_bytes.compress.silesia" in line["result"]["metrics"]
    assert {"device_ops", "idle_gaps"} <= set(line["breakdown"])
    idle = line["idle"]["compress"]  # no device event on the CPU: the whole call is idle
    assert 0 < idle["covered"] <= 1 and idle["spans"]["encode"] > 0


LOADS_THEN_RUNS = """
import json, time
from glzbench import harness, program
from glz_tpu_torch.utils import timer

def free():
    try:
        with timer.recording():
            return True
    except RuntimeError:
        return False

c = harness.load_cell("byte-throughput.silesia-sizes-batch")
for m in c.per_layer:  # as the discovery test and read_metrics load them
    harness.metric_reader(m["name"])
before = free()
code, r = harness.run_cell(c, 7, 0.01, True, time.perf_counter(), device="cpu", scale=2e-4)
print(json.dumps([before, code, "pipeline_overlap.compress" in r["metrics"], free(),
                  len(program.records())]))
"""


def test_loading_the_readers_leaves_the_recorder_off():
    """Only the harness's traced window turns the recorder on: a reader
    loaded anywhere else does not, and a traced run ends with it off."""
    before, code, read, after, n = run_traced(LOADS_THEN_RUNS)
    assert before and code == 0 and read and after and n > 0


def test_the_program_spans_share_the_clock_of_the_device_trace(tmp_path):
    """A traced CPU round trip: each glz.* span of the Chrome trace, moved by
    the offset the harness places device events with, starts within 0.5 ms
    of its perf_counter_ns start, at the median."""
    import statistics
    import time

    import torch

    import glz_tpu_torch as gt
    from glz_tpu_torch import config as cfg
    from glz_tpu_torch.utils import timer

    data = bytes(range(256)) * 300
    calls = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.recording() as spans:
            for _ in range(3):
                t0 = time.perf_counter_ns()
                with torch.profiler.record_function(timeline.SPAN_PREFIX + "compress"):
                    blob = gt.compress(data, conf=cfg.THROUGHPUT, device="cpu")
                calls.append(Call("compress", t0, time.perf_counter_ns(), len(data), len(blob),
                                  0))
                t0 = time.perf_counter_ns()
                with torch.profiler.record_function(timeline.SPAN_PREFIX + "decompress"):
                    gt.decompress(blob, device="cpu")
                calls.append(Call("decompress", t0, time.perf_counter_ns(), len(data),
                                  len(blob), 0))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    glz = sorted((e for e in trace["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e["name"].startswith(timer.SPAN_PREFIX)), key=lambda e: e["ts"])
    # the glz.* spans as device events: the harness moves them onto the host clock
    for e in glz:
        trace["traceEvents"].append(dict(e, cat="kernel"))
    path.write_text(json.dumps(trace))
    moved = timeline.load_device_events(path, calls)
    gaps = []
    for name in {r.name for r in spans}:  # the k-th span of a name against the k-th
        theirs = sorted(e.start for e in moved if e.name == timer.SPAN_PREFIX + name)
        mine = sorted(r.start_ns for r in spans if r.name == name)
        assert len(theirs) == len(mine) >= 3, name
        gaps += [abs(a - b) for a, b in zip(theirs, mine)]
    assert len(gaps) == len(spans)
    assert statistics.median(gaps) < 0.5 * MS
