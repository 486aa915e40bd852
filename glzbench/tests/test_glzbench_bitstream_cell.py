"""The cell of the DEFAULT preset (byte-default.silesia-sizes): the readers
of the program's `bitio.*` spans on hand-made runs, and a traced CPU run of
the cell that reports them, whose containers the bitstream reference
finds sound."""

import json
import os
import subprocess
import sys

import pytest

from glzbench import harness, program
from glzbench.timeline import Call, DeviceEvent

MS = 1_000_000  # ns
CELL = "byte-default.silesia-sizes"
NEW = ("kernel_roofline.compress.bitstream", "bitio_share.compress", "bitio_share.decompress")


def rec(name, start_ms, end_ms, id_, parent=None):
    from glz_tpu_torch.utils.timer import SpanRecord

    return SpanRecord(name, id_, parent, parent or id_, 1, int(start_ms * MS), int(end_ms * MS),
                      {})


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


def make_run():
    """A compress [0, 100) ms and a decompress [100, 300) ms."""
    calls = [Call("compress", 0, 100 * MS, 1000, 600, 560, "f"),
             Call("decompress", 100 * MS, 300 * MS, 1000, 600, 560, "f")]
    return harness.Run(9.0, calls, (0, 300 * MS), {"hbm_bytes_per_s": 3.35e12}, None, [],
                       set())


SPANS = [rec("compress", 0, 100, 1),
         rec("serialize", 60, 90, 2, 1), rec("bitio.words_to_bytes", 61, 86, 3, 2),
         rec("decompress", 100, 300, 4),
         rec("serialize", 110, 130, 5, 4), rec("bitio.bytes_to_words", 111, 129, 6, 5),
         rec("serialize", 250, 290, 7, 4),
         rec("bitio.words_to_bytes", 400, 500, 8)]  # outside the calls


def test_bitio_share_is_the_union_of_the_bitio_spans_inside_the_calls(recorded):
    recorded(SPANS)
    run = make_run()
    assert read("bitio_share.compress", run) == pytest.approx(25.0)   # 25 of 100 ms
    assert read("bitio_share.decompress", run) == pytest.approx(9.0)  # 18 of 200 ms


def test_bitio_share_is_absent_without_its_spans(recorded):
    run = make_run()
    for case in (None, [], [s for s in SPANS if not s.name.startswith("bitio.")]):
        recorded(case)  # no recorder, nothing recorded, a program without the spans
        assert read("bitio_share.compress", run) is None
        assert read("bitio_share.decompress", run) is None


def test_the_bitstream_roofline_reads_as_its_base():
    run = make_run()
    run.device_events = [DeviceEvent(10 * MS, 30 * MS, "kernel", "lookup_lj_lens_kernel"),
                         DeviceEvent(40 * MS, 50 * MS, "kernel", "pack_tiles_kernel")]
    value = read("kernel_roofline.compress.bitstream", run)
    assert value == read("kernel_roofline.compress", run)
    assert value == pytest.approx(100 * 1560 / 3.35e12 / 0.030)  # data + payload over 30 ms


def test_the_cell_reports_the_silesia_cells_metrics_but_the_decompress_tail():
    mine, silesia = harness.load_cell(CELL), harness.load_cell("byte-throughput.silesia-sizes")
    assert [m["name"] for m in mine.end_to_end] == [m["name"] for m in silesia.end_to_end
                                                    if m["name"] != "decompress_p95_ms"]
    assert set(NEW) <= {m["name"] for m in mine.per_layer}
    assert mine.traffic == silesia.traffic and mine.config["reference"] == "glz_bitstream"


def test_a_traced_cpu_run_of_the_cell_reports_bitio_and_sound_containers():
    code = ("import time, json, torch; from glzbench import harness; "
            "torch.set_num_threads(1); "
            f"c = harness.load_cell({CELL!r}); "
            "code, r = harness.run_cell(c, 2**31 + 13, 2.0, True, time.perf_counter(), "
            "device='cpu', scale=1e-3); print(json.dumps([code, r]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ,
                                                          PYTHONPATH=str(harness.ROOT)))
    assert out.returncode == 0, out.stderr[-4000:]
    code, r = json.loads(out.stdout.strip().split("\n")[-1])
    assert code == 0 and r["failed"] == 0
    # a loaded CPU may not reach every file in the window: those go unchecked
    checks = {k: c["value"] for k, c in r["checks"].items()}
    assert checks.pop("files_unchecked") < 12 and not any(checks.values()), checks
    for name in ("bitio_share.compress", "bitio_share.decompress"):
        assert 0 < r["metrics"][name]["value"] <= 100
