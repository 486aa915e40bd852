"""The benchmark on a CUDA card: one short run of each cell's command, and
the control's readings at a small size.  Skipped without a card."""

import json
import subprocess
import sys

import pytest

from glzbench import harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())[
    "workloads"]]


def card(n: int = 1):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA card(s)")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_run_prints_its_result(workload, trace):
    cell = harness.load_cell(workload)
    card(cell.chips)
    out = subprocess.run([sys.executable, "-m", "glzbench", "--workload", workload, "--seed",
                          str(2**31 + 77), "--seconds", "2", "--trace", str(trace)],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().split("\n")[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == cell.chips
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if not trace:
        want.discard("decompress_p95_ms")  # 2 s hold too few calls
    assert want <= set(result["metrics"])
    if trace:
        assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]


@pytest.mark.gpu
def test_the_control_reads_not_correct_on_the_card():
    card()
    from glzbench import control, faults, traffic

    cell = harness.load_cell("byte-throughput.and3-100MB")
    files = traffic.make_files(cell.traffic, 5, scale=0.05)
    assert control.readings(cell, harness.Entry(cell.config), files, 1.0)[0]
    for fault in faults.FAULTS.values():
        assert not control.readings(cell, fault(cell.config), files, 1.0)[0]
