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
