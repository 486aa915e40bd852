"""The metric readers' arithmetic on synthetic calls, spans and traces."""

import json

import pytest

from glzbench import harness, timeline
from glzbench.timeline import Call, DeviceEvent

MS = 1_000_000  # ns
PEAKS = {"hbm_bytes_per_s": 3.35e12}


def read(name, run):
    return harness.metric_reader(name).read(run)


def make_run(calls, events=None, spans=(), missing=(), peaks=PEAKS):
    window = (min(c.start for c in calls), max(c.end for c in calls)) if calls else (0, 0)
    return harness.Run(12.5, list(calls), window, peaks, events, list(spans), set(missing))


def call(direction, start_ms, end_ms, data=10**8, container=56 * 10**6, payload=55 * 10**6):
    return Call(direction, start_ms * MS, end_ms * MS, data, container, payload)


def test_union_and_overlap():
    u = timeline.union([(5, 9), (0, 2), (1, 3), (9, 10), (12, 12)])
    assert u == [(0, 3), (5, 10)]
    assert timeline.length(u) == 8
    assert timeline.overlap(u, [(2, 6), (8, 20)]) == 1 + 1 + 2


def test_rates_and_ratio_take_all_the_work_over_all_the_call_time():
    run = make_run([call("compress", 0, 200), call("decompress", 200, 300),
                    call("compress", 300, 400), call("decompress", 400, 600)])
    assert read("compress_GBps", run) == pytest.approx(2e8 / 0.3 / 1e9)
    assert read("decompress_GBps", run) == pytest.approx(2e8 / 0.3 / 1e9)
    assert read("ratio", run) == pytest.approx(0.56)
    assert read("setup_s", run) == 12.5
    assert read("compress_GBps", make_run([])) is None


def test_p95_is_the_nearest_rank_and_needs_twenty_calls():
    calls = [call("decompress", 10 * k, 10 * k + k + 1) for k in range(240)]
    run = make_run(calls)
    # 240 calls: rank ceil(0.95 * 240) = 228, 12 calls beyond it
    assert read("decompress_p95_ms", run) == pytest.approx(228.0)
    assert timeline.percentile(list(range(1, 21)), 95) == 19
    assert read("decompress_p95_ms", make_run(calls[:19])) is None
    assert read("decompress_p95_ms", make_run(calls[:20])) is not None


def test_the_compress_tail_and_the_per_cell_readers_read_as_their_bases():
    calls = [call("compress", 10 * k, 10 * k + k + 1) for k in range(240)]
    run = make_run(calls)
    assert read("compress_p95_ms", run) == pytest.approx(228.0)
    assert read("compress_p95_ms", make_run(calls[:19])) is None
    for base in ("compress_GBps", "kernel_roofline.compress", "device_idle.compress",
                 "copy_GBps.compress", "host_library_share.compress"):
        mine, theirs = harness.metric_reader(base + ".silesia"), harness.metric_reader(base)
        assert getattr(mine, "SPANS", {}) == getattr(theirs, "SPANS", {})
        assert mine.read(run) == theirs.read(run)



def test_the_sharded_compress_rate_reads_as_compress_GBps():
    run = make_run([call("compress", 10 * k, 10 * k + k + 1) for k in range(20)])
    mine, theirs = harness.metric_reader("compress_GBps.sharded"), harness.metric_reader(
        "compress_GBps")
    assert getattr(mine, "SPANS", {}) == getattr(theirs, "SPANS", {})
    assert mine.read(run) == theirs.read(run) > 0
    assert mine.read(make_run([])) is None

def trace_run():
    calls = [call("compress", 0, 100, data=1000 * 10**6, payload=600 * 10**6),
             call("decompress", 100, 200, data=1000 * 10**6, payload=600 * 10**6)]
    events = [DeviceEvent(10 * MS, 20 * MS, "gpu_memcpy", "Memcpy HtoD", 40 * 10**6),
              DeviceEvent(20 * MS, 21 * MS, "kernel", "void (anonymous namespace)::k1<8>(int)"),
              DeviceEvent(20 * MS + MS // 2, 22 * MS, "kernel", "k2(int)"),  # overlaps k1
              DeviceEvent(90 * MS, 99 * MS, "gpu_memcpy", "Memcpy DtoH", 18 * 10**6),
              DeviceEvent(150 * MS, 154 * MS, "kernel", "k3"),
              DeviceEvent(154 * MS, 155 * MS, "gpu_memset", "Memset")]
    spans = [("native.histogram", 30 * MS, 40 * MS), ("native.histogram", 35 * MS, 45 * MS),
             ("native.detokenize", 190 * MS, 210 * MS)]
    return make_run(calls, events, spans)


def test_device_idle_is_one_less_the_union_of_device_work():
    run = trace_run()
    # compress: copies 10 + 9 ms, kernels [20, 22): 21 ms busy of 100
    assert read("device_idle.compress", run) == pytest.approx(79.0)
    assert read("device_idle.decompress", run) == pytest.approx(95.0)


def test_kernel_roofline_counts_the_directions_work_once():
    run = trace_run()
    work = 1600e6 / 3.35e12
    assert read("kernel_roofline.compress", run) == pytest.approx(100 * work / 2e-3)
    assert read("kernel_roofline.decompress", run) == pytest.approx(100 * work / 4e-3)


def test_copy_rate_is_bytes_over_copy_time():
    run = trace_run()
    assert read("copy_GBps.compress", run) == pytest.approx(58e6 / 19e-3 / 1e9)
    assert read("copy_GBps.decompress", run) is None  # no copy in the decompress call


def test_host_library_share_is_the_union_of_its_spans_inside_the_calls():
    run = trace_run()
    assert read("host_library_share.compress", run) == pytest.approx(15.0)
    assert read("host_library_share.decompress", run) == pytest.approx(10.0)


def test_absent_rather_than_zero():
    run = trace_run()
    for name in ("kernel_roofline.compress", "device_idle.compress", "copy_GBps.compress"):
        assert read(name, make_run(run.calls, events=None)) is None
        assert read(name, make_run(run.calls, events=[])) is None
    no_peak = make_run(run.calls, run.device_events, peaks=None)
    assert read("kernel_roofline.compress", no_peak) is None
    no_kernel = [e for e in run.device_events if e.cat != "kernel"]
    assert read("kernel_roofline.compress", make_run(run.calls, no_kernel)) is None
    missing = make_run(run.calls, run.device_events, run.spans,
                       missing={"glz_tpu_torch.utils.native.tokenize"})
    assert read("host_library_share.compress", missing) is None
    assert read("host_library_share.decompress", missing) is not None
    assert read("host_library_share.compress", make_run(run.calls, run.device_events)) is None


def test_breakdown_names_ops_and_labels_gaps_by_the_innermost_span():
    run = trace_run()
    b = timeline.breakdown(run)
    assert b["device_ops"][0] == ["Memcpy HtoD", 0.01]
    assert ["k1", 0.001] in b["device_ops"]
    assert [[name, round(s, 6)] for name, s in b["idle_gaps"]] == [
        ["compress", 0.068],    # [22, 90) ms: the histogram's spans end at 45 ms
        ["decompress", 0.051],  # [99, 150) ms
        ["decompress", 0.045],  # [155, 200) ms: detokenize starts after its middle
        ["compress", 0.01]]     # [0, 10) ms
    spans = run.spans + [("native.detokenize", 170 * MS, 180 * MS)]
    b = timeline.breakdown(make_run(run.calls, run.device_events, spans))
    assert b["idle_gaps"][2] == ["native.detokenize", pytest.approx(0.045)]
    assert timeline.busy_seconds(run) == pytest.approx(0.026)


def test_device_events_are_placed_on_the_host_clock(tmp_path):
    calls = [call("compress", 1000, 1100), call("decompress", 1100, 1200)]
    shift_us = 5_000_000.0  # the trace's clock: 5 s ahead
    events = [{"ph": "X", "cat": "user_annotation", "name": "glzbench.compress",
               "ts": 1000e3 + shift_us, "dur": 100e3},
              {"ph": "X", "cat": "user_annotation", "name": "glzbench.decompress",
               "ts": 1100e3 + shift_us, "dur": 100e3},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 1050e3 + shift_us, "dur": 2e3},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1150e3 + shift_us,
               "dur": 10e3, "args": {"bytes": 1234}},
              {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0, "dur": 1}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = timeline.load_device_events(path, calls)
    assert [(e.cat, e.start, e.end, e.nbytes) for e in out] == [
        ("kernel", 1050 * MS, 1052 * MS, 0), ("gpu_memcpy", 1150 * MS, 1160 * MS, 1234)]
    path.write_text(json.dumps({"traceEvents": events[2:]}))
    with pytest.raises(RuntimeError):
        timeline.load_device_events(path, calls)
