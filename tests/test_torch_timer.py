"""glz_tpu_torch.utils.timer against glz_tpu.utils.timer, device_trace on the
CPU, and chip_smoke.py's trace summary on hand-made Chrome traces."""

import dataclasses
import json

import pytest
import torch

import chip_smoke
from glz_tpu.utils import timer as tpu_timer
from glz_tpu_torch.utils import timer
from tests.torch_threads import one_torch_thread  # noqa: F401

PHASE_LISTS = {
    "empty": [],
    "one_with_bytes": [("encode", 0.0123456, 512 << 20)],
    "bytes_and_none": [("histogram+codebook", 0.25, 8 << 20), ("pad copy", 1.5, 0),
                       ("a name longer than the twenty-eight columns", 12.0, 100 << 20)],
    "zero_seconds": [("instant", 0.0, 4096), ("nothing", 0.0, 0)],
}


@pytest.mark.parametrize("case", list(PHASE_LISTS))
def test_timer_matches_reference(case):
    """Phase and Profiler are glz_tpu's: the same fields and defaults, the
    same GB/s (with its 1e-12 guard) and the same report for the same
    phases."""
    assert ([(f.name, f.default) for f in dataclasses.fields(timer.Phase)]
            == [(f.name, f.default) for f in dataclasses.fields(tpu_timer.Phase)])
    assert ([f.name for f in dataclasses.fields(timer.Profiler)]
            == [f.name for f in dataclasses.fields(tpu_timer.Profiler)])
    got, want = timer.Profiler(), tpu_timer.Profiler()
    for name, seconds, nbytes in PHASE_LISTS[case]:
        got.phases.append(timer.Phase(name, seconds, nbytes))
        want.phases.append(tpu_timer.Phase(name, seconds, nbytes))
        assert got.phases[-1].gbps == want.phases[-1].gbps
    assert got.report() == want.report()
    assert timer.Profiler().phases == [] and timer.Profiler().phases is not got.phases


def test_profiler_phase_records_name_bytes_and_time():
    prof = timer.Profiler()
    with prof.phase("encode", nbytes=1234):
        sum(range(10_000))
    with prof.phase("decode"):
        pass
    assert [(p.name, p.bytes_processed) for p in prof.phases] == [("encode", 1234), ("decode", 0)]
    assert prof.phases[0].seconds > 0 and prof.phases[1].seconds >= 0
    assert prof.report().splitlines()[0].startswith("encode")


def test_device_trace_without_a_path_records_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for path in (None, ""):
        with timer.device_trace(path) as trace:
            torch.arange(10).sum()
        assert trace.file is None
    assert list(tmp_path.iterdir()) == []


def test_device_trace_on_the_cpu_writes_one_chrome_trace(tmp_path):
    with timer.device_trace(tmp_path / "t", device="cpu") as trace:
        with torch.profiler.record_function("glz_span"):
            torch.arange(1000).sum()
    assert trace.file.parent == tmp_path / "t"
    assert [p.name for p in (tmp_path / "t").iterdir()] == [trace.file.name]
    assert trace.file.name.endswith(timer.TRACE_SUFFIX)
    events = json.loads(trace.file.read_text())["traceEvents"]
    assert any(e.get("cat") == "user_annotation" and e["name"] == "glz_span" for e in events)
    assert timer.kernel_events({"traceEvents": events}) == []


def test_device_trace_without_a_card_raises(tmp_path, monkeypatch):
    """device None means the card: no quiet trace of the CPU alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with timer.device_trace(tmp_path / "t"):
            pass
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        with timer.device_trace(tmp_path / "t", device="meta"):
            pass
    assert not (tmp_path / "t").exists()


def _x(cat, name, ts, dur, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, **kw}


# A hand-made trace (microseconds).  The span runs 1000-2000.  Device work:
# a port kernel 1100-1300 and a kernel nested in it 1150-1200 (the same
# stream cannot do that, but the union must not count it twice); another
# kernel 1250-1400 overlapping the first; a copy 1500-1600; a copy 1550-1580
# inside it; a memset 1590-1700 overlapping the copy; a kernel 1900-2100 that
# runs past the span's end; a kernel and a copy wholly before the span (not
# in the window, but a port kernel counts in the whole trace).  Gaps with no
# device event: 1000-1100 (covered by cudaMemcpyAsync inside aten::copy_),
# 1400-1500 (covered by nothing), 1700-1900 (covered by aten::empty).
HAND_MADE = {"traceEvents": [
    _x("user_annotation", "call", 1000, 1000),
    _x("gpu_user_annotation", "call", 1100, 1000),
    _x("kernel", "void encode_kernel<8>(unsigned char const*, int)", 1100, 200),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int> >"
       "(int, at::native::FillFunctor<int>)", 1150, 50),
    _x("kernel", "_Z26decode_streams_sync_kernelILb1ELi256ELi8ELi8EEvPKjxPKxxxx", 1250, 150),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1500, 100),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1550, 30),
    _x("gpu_memset", "Memset (Device)", 1590, 110),
    _x("kernel", "void decode_streams_sync_kernel<false, 256, 8, 4>(unsigned int const*)",
       1900, 200),
    _x("kernel", "_Z18lane_totals_kernelPKhPKjxiiiPjS3_S3_", 500, 100),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 700, 100),
    _x("cpu_op", "aten::copy_", 980, 125),
    _x("cuda_runtime", "cudaMemcpyAsync", 1000, 105),
    _x("cpu_op", "aten::empty", 1650, 400),
    _x("cpu_op", "aten::zeros", 1801, 20),  # just misses 1800, the gap's midpoint
    {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1000, "id": 1},
    {"ph": "M", "name": "process_name", "args": {"name": "python"}},
]}


def test_trace_summary_on_a_hand_made_trace():
    s = chip_smoke.trace_summary(HAND_MADE, "call")
    assert s["window_ms"] == 1.0
    # kernels: [1100, 1400] and [1900, 2000] (clipped to the window)
    assert s["kernel_ms"] == 0.4
    # all device events: [1100, 1400], [1500, 1700], [1900, 2000]
    assert s["device_ms"] == 0.6
    assert (s["kernel_idle"], s["device_idle"]) == (0.6, 0.4)
    # by time inside the window; the FillFunctor kernel (0.05 ms) is sixth
    assert s["top"] == [
        ("encode_groups", 1, 0.2), ("decode_streams_dual", 1, 0.15),
        ("Memcpy DtoH (Device -> Pageable)", 2, 0.13), ("Memset (Device)", 1, 0.11),
        ("decode_streams", 1, 0.1)]
    assert s["gaps"] == [
        (0.2, "aten::empty"), (0.1, "cudaMemcpyAsync"), (0.1, "host (untraced)")]
    assert s["port_kernels"] == {"encode_groups": 1, "decode_streams_dual": 1,
                                 "decode_streams": 1, "lane_totals": 1}
    line = chip_smoke.trace_line("call", s)
    assert "idle (kernels) 60.0000%" in line and "0.200 ms under aten::empty" in line


def test_trace_summary_names_every_port_kernel():
    """Each wrapper's kernel, by its demangled and its mangled name, maps to
    the wrapper; PyTorch's kernels map to none."""
    names = {
        "lane_totals": ["void lane_totals_kernel(unsigned char const*)",
                        "_Z18lane_totals_kernelPKhPKjxiiiPjS3_S3_"],
        "lane_totals_entries": ["void lane_totals_entries_kernel(unsigned int const*)",
                                "_Z26lane_totals_entries_kernelPKjiiiPjS1_S1_"],
        "encode_groups": ["void encode_kernel<8>(unsigned char const*)", "_Z13encode_kernelILi8EEv"],
        "encode_entries": ["void encode_entries_kernel<4>(unsigned int const*)",
                           "_Z21encode_entries_kernelILi4EEv"],
        "decode_groups": ["void decode_kernel<8>(unsigned int const*)", "_Z13decode_kernelILi8EEv"],
        "decode_dual": ["void decode_dual_kernel<1, 4>(unsigned int const*)",
                        "_Z18decode_dual_kernelILi1ELi4EEv"],
        "lut_gather": ["void lut_gather_kernel<unsigned short, unsigned int>(unsigned short const*)",
                       "_Z17lut_gather_kernelItjEvPKT_"],
        "lookup_lj_lens": ["void lookup_lj_lens_kernel(unsigned char const*)",
                           "_Z21lookup_lj_lens_kernelPKhxxPKjS2_PjS3_"],
        "pack_scan": ["void pack_scan_kernel(unsigned int const*)", "_Z16pack_scan_kernelPKjxPl"],
        "pack_tiles": ["void pack_tiles_kernel(unsigned int const*)", "_Z17pack_tiles_kernelPKjS0_x"],
        "decode_streams": ["void decode_streams_sync_kernel<false, 256, 8, 4>(unsigned int const*)",
                           "_Z26decode_streams_sync_kernelILb0ELi256ELi8ELi4EEvPKj"],
        "decode_streams_dual": ["void decode_streams_sync_kernel<true, 256, 8, 8>(unsigned int)",
                                "_Z26decode_streams_sync_kernelILb1ELi256ELi8ELi8EEvPKj"],
        "histogram": ["void histogram_kernel(uint4 const*, long, long, unsigned long long*)",
                      "_Z16histogram_kernelPK5uint4xxPy"],
        "decode_streams_bitwalk": [
            "(anonymous namespace)::decode_streams_sync_kernel<false, 256, 8, 4, 1>(unsigned int)",
            "_ZN12_GLOBAL__N_126decode_streams_sync_kernelILb0ELi256ELi8ELi4ELi1EEEvPKj"],
        "decode_streams_fast": [
            "(anonymous namespace)::decode_streams_sync_kernel<false, 256, 8, 4, 2>(unsigned int)",
            "_ZN12_GLOBAL__N_126decode_streams_sync_kernelILb0ELi256ELi8ELi4ELi2EEEvPKj"],
        "decode_streams_dual_bitwalk": [
            "(anonymous namespace)::decode_streams_sync_kernel<true, 128, 2, 8, 1>(unsigned int)",
            "_ZN12_GLOBAL__N_126decode_streams_sync_kernelILb1ELi128ELi2ELi8ELi1EEEvPKj"],
        "decode_streams_dual_fast": [
            "(anonymous namespace)::decode_streams_sync_kernel<true, 128, 2, 8, 2>(unsigned int)",
            "_ZN12_GLOBAL__N_126decode_streams_sync_kernelILb1ELi128ELi2ELi8ELi2EEEvPKj"],
    }
    assert set(names) == set(chip_smoke.REPLACES)
    for wrapper, kernels in names.items():
        for k in kernels:
            assert chip_smoke.wrapper_of(k) == wrapper, k
    for other in ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int> >",
                  "void at::native::(anonymous namespace)::kernelHistogram1D<long>(long*)",
                  "void cub::DeviceScanKernel<int>(int*)", "Memcpy DtoH (Device -> Pageable)"):
        assert chip_smoke.wrapper_of(other) is None


# ---- the program's spans and counters -----------------------------------------

def test_span_off_is_one_shared_no_op_that_allocates_nothing(monkeypatch):
    import tracemalloc

    def refuse(*args, **kwargs):
        raise AssertionError("the off path made a span, took a lock or read a stack")

    class Refused:
        __enter__ = __exit__ = acquire = refuse

    monkeypatch.setattr(timer, "_Span", refuse)
    monkeypatch.setattr(timer, "_stack", refuse)
    monkeypatch.setattr(timer, "_switch_lock", Refused())
    monkeypatch.setattr(timer, "_totals_lock", Refused())
    assert timer.span("a") is timer.span("b") is timer.span("c", parent=None)
    assert timer.current() is None
    monkeypatch.undo()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with timer.span("pad"):
                pass
            assert timer.current() is None
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, timer.__file__)]
    grown = after.filter_traces(mine).compare_to(before.filter_traces(mine), "lineno")
    assert sum(d.size_diff for d in grown) == 0


def test_recording_keeps_each_span_with_its_parent_and_root():
    with timer.recording() as spans:
        with timer.span("compress") as root:
            assert timer.current() is root
            with timer.span("pad"):
                with timer.span("inner"):
                    pass
            with timer.span("encode"):
                pass
        with timer.span("decompress"):
            pass
    assert timer.current() is None and timer.span("x") is timer.span("y")
    by = {r.name: r for r in spans}
    assert [r.name for r in spans] == ["inner", "pad", "encode", "compress", "decompress"]
    assert by["compress"].parent is None and by["compress"].root == by["compress"].id
    assert by["pad"].parent == by["encode"].parent == by["compress"].id
    assert by["inner"].parent == by["pad"].id
    assert {by[n].root for n in ("inner", "pad", "encode")} == {by["compress"].id}
    assert by["decompress"].root == by["decompress"].id != by["compress"].id
    assert all(r.start_ns <= r.end_ns for r in spans)
    assert by["compress"].start_ns <= by["pad"].start_ns <= by["inner"].end_ns \
        <= by["pad"].end_ns <= by["encode"].start_ns <= by["compress"].end_ns
    assert len({r.thread for r in spans}) == 1


def test_nesting_recording_raises_and_leaves_the_first_on():
    with timer.recording() as spans:
        with pytest.raises(RuntimeError, match="already on"):
            with timer.recording():
                pass
        with timer.span("still"):
            pass
    assert [r.name for r in spans] == ["still"]
    with timer.recording() as again:
        pass
    assert again == [] and again is not spans


def test_counts_land_on_the_innermost_span_and_on_the_totals():
    timer.reset_totals("test.")
    timer.count("test.bytes", 5)  # nothing records: the totals alone
    with timer.recording() as spans:
        timer.count("test.bytes", 7)  # no span open: the totals alone
        with timer.span("outer"):
            timer.count("test.bytes", 1)
            with timer.span("inner"):
                timer.count("test.bytes", 10)
                timer.count("test.calls", 1)
            timer.count("test.bytes", 100)
    by = {r.name: r for r in spans}
    assert by["outer"].counts == {"test.bytes": 101}
    assert by["inner"].counts == {"test.bytes": 10, "test.calls": 1}
    assert timer.totals("test.") == {"test.bytes": 123, "test.calls": 1}
    timer.reset_totals("test.b")
    assert timer.totals("test.") == {"test.bytes": 0, "test.calls": 1}


def test_a_span_passed_across_threads_is_the_parent():
    import threading

    def work(parent, out):
        with timer.span("child", parent=parent):
            with timer.span("leaf"):
                timer.count("test.leaf", 1)
        out.append(timer.current())

    with timer.recording() as spans:
        with timer.span("batch") as batch:
            seen: list = []
            t = threading.Thread(target=work, args=(timer.current(), seen))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive() and seen == [None]
        with timer.span("wait", start_ns=batch.start - 5):
            pass
    by = {r.name: r for r in spans}
    assert by["child"].parent == by["batch"].id and by["child"].root == by["batch"].id
    assert by["leaf"].parent == by["child"].id and by["leaf"].counts == {"test.leaf": 1}
    assert by["child"].thread == by["leaf"].thread != by["batch"].thread
    assert by["wait"].start_ns == by["batch"].start_ns - 5


def test_a_span_that_ends_after_its_recording_is_dropped():
    with timer.recording() as first:
        span = timer.span("late")
        span.__enter__()
    with timer.recording() as second:
        span.__exit__(None, None, None)
    assert first == [] and second == []


def test_recorded_spans_are_profiler_spans_under_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    with timer.recording():
        with timer.span("no_profiler"):
            pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.recording():
            with timer.span("pad"):
                torch.arange(10).sum()
        with timer.span("unrecorded"):
            pass
    names = {e.key for e in prof.key_averages()}
    assert timer.SPAN_PREFIX + "pad" in names
    assert timer.SPAN_PREFIX + "unrecorded" not in names
    assert entered == [timer.SPAN_PREFIX + "pad"]
