"""BENCHMARK.json against the rules of its format, and the harness finding
cells, configurations, traffic mixes and metrics by name alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from glzbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_the_file_keeps_to_its_format():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["glzbench"] and BENCH["command"][:2] == ["python3", "-m"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"] == f"glzbench/configs/{c['name']}.json"
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["source"] == c["source"]  # the project's settings that define it
        assert body["reduced"] == c["reduced"] and all(k in body for k in c["reduced"])
    cells = {w["name"] for w in BENCH["workloads"]}
    assert len(cells) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"])
        body = json.loads((harness.ROOT / configs[w["config"]]["file"]).read_text())
        assert body.get("processes", 1) in (1, w["chips"])  # one process, or one a card
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(cells) // 4)
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and line(m["layer"])
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", cells):  # each cell it names reports what it moves
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        mine = [m for m in BENCH["per_layer"] if cell in m.get("workloads", cells)]
        assert mine and len([m for m in e2e.values() if cell in m.get("workloads", cells)]) >= 2
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(workload):
    cell = harness.load_cell(workload)
    assert cell.config["reference"] and cell.traffic["files"]
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)


def test_a_dropped_in_metric_traffic_and_config_are_found_with_no_edit(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "glzbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [dict(BENCH["configs"][0], name="byte-copy",
                                                file="glzbench/configs/byte-copy.json")]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "byte-copy.tiny", "config": "byte-copy", "traffic": "tiny", "chips": 1,
         "why": "a test"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "calls_made", "unit": "calls", "better": "higher", "source": "program_counter",
         "layer": "front door", "moves": "compress_GBps", "workloads": ["byte-copy.tiny"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(harness.HERE / "configs" / "byte-throughput.json",
                tmp_path / "glzbench" / "configs" / "byte-copy.json")
    (tmp_path / "glzbench" / "traffic" / "tiny.json").write_text(json.dumps(
        {"entry": "file", "laws": {"u": {"kind": "and", "draws": 1}},
         "files": [{"name": "a", "bytes": 3000, "law": "u"}]}))
    (tmp_path / "glzbench" / "metrics" / "calls_made.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    code = ("import time, json; from glzbench import harness; "
            "c = harness.load_cell('byte-copy.tiny'); "
            "print(json.dumps(harness.run_cell(c, 3, 0.01, True, time.perf_counter(), "
            "device='cpu')[1]['metrics']))")
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))  # the program; glzbench is the copy's
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.split("\n")[-2])["calls_made"]["value"] >= 2


def test_an_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell("no-such.cell")
