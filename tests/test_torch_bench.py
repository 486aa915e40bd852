"""bench_torch.py and bench_huffword_torch.py (the port's benches) on the
CPU under GLZ_PLATFORM=cpu, at a small size: their corpora against
bench.py's and bench_huffword.py's, bench_torch's JSON line against the keys
bench.py writes, the failure paths (a zero-valued line and a non-zero exit),
the HuffWord kernel part's id check, the refusal without a card, and their
imports.  The JAX scripts are imported for their corpora only (their top
level is numpy)."""

import ast
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import bench_huffword
import bench_huffword_torch
import bench_torch
import chip_smoke
from glz_tpu_torch.models import huffword as hwm
from glz_tpu_torch.utils import tokenizer as tok
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = {"GLZ_PLATFORM": "cpu", "GLZ_BENCH_MB": "1", "GLZ_BENCH_ROWS": "8",
         "GLZ_BENCH_STREAM": "64", "GLZ_BENCH_REPEATS": "1", "GLZ_BENCH_HW_MB": "1"}
ZERO_LINE = {"metric": bench_torch.METRIC, "value": 0.0, "unit": "GB/s", "vs_baseline": 0.0}


def run_main(module, env: dict) -> tuple[int, list[str], str]:
    """module.main() in this process with `env` set (and every other
    GLZ_BENCH_* knob unset): (exit code, stdout lines, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith("GLZ_BENCH_") or k == "GLZ_HW_PROFILE":
                mp.delenv(k)
        for k, v in env.items():
            mp.setenv(k, v)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = module.main()
    return rc, out.getvalue().splitlines(), err.getvalue()


def bench_py_keys() -> set[str]:
    """Every key of bench.py's JSON line: the string keys of its dict
    literals and of its `result[...] = ` assignments."""
    keys = set()
    for node in ast.walk(ast.parse((ROOT / "bench.py").read_text())):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) and isinstance(k.value, str) for k in node.keys):
            keys |= {k.value for k in node.keys}
        if isinstance(node, ast.Assign):
            keys |= {t.slice.value for t in node.targets
                     if isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant)}
    return keys


# ---- (a) the corpora ---------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 4097, (1 << 20) + 3])
def test_byte_corpus_is_bench_py_s(n):
    got = bench_torch.make_corpus(n)
    assert got.dtype == np.uint8 and np.array_equal(got, bench.make_corpus(n))


@pytest.mark.parametrize("n", [1, 1000, 70_001, 500_000])
def test_huffword_corpus_is_bench_huffword_py_s(n):
    assert bench_huffword_torch.make_corpus(n) == bench_huffword.make_corpus(n)


# ---- (b) bench_torch.main at 1 MiB on the CPU --------------------------------

@pytest.fixture(scope="module")
def small_run():
    return run_main(bench_torch, SMALL)


def test_bench_prints_one_line_and_exits_0(small_run):
    rc, lines, err = small_run
    assert rc == 0, err
    assert len(lines) == 1


def test_bench_keys_are_bench_py_s(small_run):
    """Exactly the fourteen keys bench.py writes, collected from its source;
    chip_smoke.py's phase 10 holds the card's line to the same keys."""
    keys = bench_py_keys()
    assert len(keys) == 14
    assert set(json.loads(small_run[1][-1])) == keys == set(chip_smoke.BENCH_KEYS)


def test_bench_values_are_positive(small_run):
    line = json.loads(small_run[1][-1])
    assert line["metric"] == "enwik8_byte_codec_GBps_per_chip" and line["unit"] == "GB/s"
    assert all(v > 0 for k, v in line.items() if k not in ("metric", "unit")), line
    assert line["vs_baseline"] == line["value"]


def test_bench_logs_each_part_s_launches(small_run):
    """Every part logs its launch line in the format phase 10 parses; on the
    CPU no kernel launches, so the counts are empty."""
    found = {m[1]: (int(m[2]), int(m[3]), json.loads(m[4]))
             for m in chip_smoke._LAUNCH_LINE.finditer(small_run[2])}
    assert set(found) == set(chip_smoke.BENCH_PARTS["bench_torch.py"])
    assert all(e > 0 and d > 0 and counts == {} for e, d, counts in found.values())
    # one repeat: byte, warm + timed + 2 edges; batch, 4 files x (warm, serial,
    # pipelined, shared, archive) encodes and 4 x (warm, serial, pipelined) decodes
    assert found["byte"][:2] == (4, 4)
    assert found["batch"][:2] == (4 * 5, 4 * 3)


def test_bench_logs_phases_and_edges(small_run):
    err = small_run[2]
    for phase in ("histogram+codebook (C++, sampled)", "device encode (K1 + K2)", "device decode (K3)"):
        assert phase in err
    assert "edge[ragged]" in err and "edge[deepcode]" in err
    assert err.count("— OK") == 2 and "MISMATCH" not in err
    assert "device: cpu" in err and f"torch {torch.__version__}" in err


def test_bench_trace_knob_writes_a_trace(tmp_path):
    """GLZ_BENCH_TRACE=dir writes one profiler trace of an encode + decode
    there (on the CPU, a CPU trace)."""
    rc, lines, err = run_main(bench_torch, {**SMALL, "GLZ_BENCH_MB": "0.25", "GLZ_BENCH_HW": "0",
                                            "GLZ_BENCH_BATCH": "0", "GLZ_BENCH_EDGES": "0",
                                            "GLZ_BENCH_TRACE": str(tmp_path)})
    assert rc == 0 and len(lines) == 1, err
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1 and f"profiler trace written to {traces[0]}" in err


# ---- (c) failures: the zero-valued line and a non-zero exit -----------------

def _flip_first(out: torch.Tensor) -> torch.Tensor:
    out = out.clone()
    out[0] ^= 1
    return out


def _decode_flip(real, only_deep: bool):
    """decode_groups with its first output byte flipped (only on the deep
    edge's call, whose symbols are all below 64, when `only_deep`)."""
    def decode(*args):
        out = real(*args)
        return _flip_first(out) if not only_deep or int(out.max()) < 64 else out
    return decode


def _raise(*args, **kw):
    raise RuntimeError("injected failure")


FAILURES = {
    # case: (patch target, replacement of the original, env, the zero-valued key)
    "round_trip": (bench_torch, "decode_groups", lambda f: _decode_flip(f, False),
                   {"GLZ_BENCH_HW": "0", "GLZ_BENCH_BATCH": "0"}, None),
    "deepcode": (bench_torch, "decode_groups", lambda f: _decode_flip(f, True),
                 {"GLZ_BENCH_HW": "0", "GLZ_BENCH_BATCH": "0"}, None),
    "huffword": (bench_torch, "decompress", lambda f: lambda *a, **k: f(*a, **k)[1:] + b"x",
                 {"GLZ_BENCH_BATCH": "0"}, "huffword_GBps"),
    "huffword_kernels": (bench_torch, "map_ranks", lambda f: lambda *a: _flip_first(f(*a)),
                         {"GLZ_BENCH_BATCH": "0"}, "huffword_kernel_GBps"),
    "batch_mismatch": (bench_torch, "decompress_batch", lambda f: lambda *a, **k: f(*a, **k)[::-1],
                       {"GLZ_BENCH_HW": "0", "GLZ_BENCH_EDGES": "0"}, "batch4_serial_GBps"),
    "batch_raises": (bench_torch, "compress_batch", lambda f: _raise,
                     {"GLZ_BENCH_HW": "0", "GLZ_BENCH_EDGES": "0"}, "batch4_serial_GBps"),
}


@pytest.mark.parametrize("case", list(FAILURES))
def test_failure_prints_zero_and_exits_nonzero(monkeypatch, case):
    """A corrupted round trip or edge prints bench.py's zero line; a failed
    HuffWord or batch part prints the line with bench.py's zero-valued key
    for it.  Either way the exit code is non-zero (bench.py exits 0)."""
    module, name, patch, env, zero_key = FAILURES[case]
    monkeypatch.setattr(module, name, patch(getattr(module, name)))
    rc, lines, err = run_main(bench_torch, {**SMALL, "GLZ_BENCH_MB": "0.25",
                                            "GLZ_BENCH_HW_MB": "0.25", **env})
    assert rc == 1 and len(lines) == 1, err
    line = json.loads(lines[0])
    if zero_key is None:
        assert line == ZERO_LINE
        assert "— MISMATCH" in err if case == "deepcode" else "ROUND TRIP MISMATCH" in err
    else:
        assert line[zero_key] == 0.0 and line["value"] > 0
        assert "FAILED" in err


# ---- (d) the HuffWord kernel part reproduces the ids ------------------------

@pytest.mark.parametrize("text", [b"the cat-sat on its mat. " * 3000,
                                  b"  -- nonword first, then words; " * 2000],
                         ids=["word_first", "nonword_first"])
def test_huffword_kernel_part_reproduces_ids(text):
    """_bench_huffword_kernels decodes the container's payload back to the
    tokenizer's ids (it raises Mismatch otherwise) and times both halves."""
    dev = torch.device("cpu")
    _, _, word_first, wv, nv, ids = tok.build_vocabs(text)
    conf = bench_huffword_torch.huffword_conf()
    blob = hwm._compress_huffword_device(text, conf, word_first, wv, nv, ids, device=dev)
    keys = bench_torch._bench_huffword_kernels(len(text), blob, word_first, wv, nv, ids, conf,
                                               1, dev)
    assert set(keys) == {"huffword_kernel_GBps", "huffword_kernel_enc_GBps",
                         "huffword_kernel_dec_GBps"}
    assert all(v > 0 for v in keys.values())


# ---- (e) no card and no GLZ_PLATFORM=cpu: exit non-zero, no line ------------

def _script_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k != "GLZ_PLATFORM" and not k.startswith("GLZ_BENCH_")}
    return {**env, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1", **extra}


@pytest.mark.parametrize("script", ["bench_torch.py", "bench_huffword_torch.py"])
def test_without_a_card_exits_nonzero_with_no_line(script):
    proc = subprocess.run([sys.executable, script], cwd=ROOT, env=_script_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_watchdog_prints_zero_line_and_exits_3():
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                          env=_script_env(GLZ_PLATFORM="cpu", GLZ_BENCH_TIMEOUT="0",
                                          **{k: v for k, v in SMALL.items()
                                             if k != "GLZ_PLATFORM"}),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == ZERO_LINE
    assert "WATCHDOG" in proc.stderr


# ---- (f) imports ------------------------------------------------------------

@pytest.mark.parametrize("script", ["bench_torch.py", "bench_huffword_torch.py"])
def test_imports_nothing_of_jax_or_the_jax_package(script):
    roots = set()
    for node in ast.walk(ast.parse((ROOT / script).read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "torch" in roots and "glz_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "glz_tpu", "bench", "bench_huffword"}


# ---- (g) bench_huffword_torch.main at 256 KiB -------------------------------

def test_huffword_bench_prints_its_line():
    rc, lines, err = run_main(bench_huffword_torch, {"GLZ_PLATFORM": "cpu",
                                                     "GLZ_BENCH_MB": "0.25",
                                                     "GLZ_HW_PROFILE": "1"})
    assert rc == 0 and len(lines) == 1, err
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "huffword_device_codec_GBps_per_chip" and line["value"] > 0
    assert "sub[device decode kernel]" in err and "sub[detokenize (host)]" in err
    assert ({m[1] for m in chip_smoke._LAUNCH_LINE.finditer(err)}
            == set(chip_smoke.BENCH_PARTS["bench_huffword_torch.py"]))


def test_huffword_bench_mismatch_prints_zero_line(monkeypatch):
    real = bench_huffword_torch.decompress
    monkeypatch.setattr(bench_huffword_torch, "decompress", lambda *a, **k: real(*a, **k)[:-1])
    rc, lines, err = run_main(bench_huffword_torch, {"GLZ_PLATFORM": "cpu",
                                                     "GLZ_BENCH_MB": "0.25"})
    assert rc == 1 and len(lines) == 1
    assert json.loads(lines[0]) == {**ZERO_LINE, "metric": bench_huffword_torch.METRIC}
    assert "ROUND TRIP MISMATCH" in err
