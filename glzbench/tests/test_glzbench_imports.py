"""What the benchmark may import: never JAX or the JAX package (top-level
module names compared whole: glz_tpu_torch begins with glz_tpu and is
the program), and, in the references, nothing of the program."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from glzbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "glz_tpu"}
SOURCES = sorted(harness.HERE.rglob("*.py"))


def imported(path: pathlib.Path) -> set[str]:
    """Top-level names of every module a file imports, anywhere in it."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_a_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= set(sys.stdlib_module_names) | {"numpy", "torch"}


def test_the_name_check_is_whole():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "glz_tpu")
    assert "glz_tpu_torch" not in FORBIDDEN


def test_a_run_leaves_no_forbidden_module(tmp_path):
    code = ("import sys, time; from glzbench import harness; "
            "c = harness.load_cell('byte-throughput.and3-100MB'); "
            "r = harness.run_cell(c, 5, 0.01, False, time.perf_counter(), device='cpu', "
            "scale=1e-5); print(r[0], r[1]['correct'], harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "0 True []"


@pytest.mark.parametrize("planted", ["reference/glz_lockstep.py", "metrics/ratio.py"])
def test_a_forbidden_module_loaded_after_the_window_stops_the_run(tmp_path, planted):
    """The reference and the metric readers are imported once the window has
    closed: a JAX package they load there still ends the run, with code 3
    and no result."""
    shutil.copytree(harness.HERE, tmp_path / "glzbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    (tmp_path / "glz_tpu").mkdir()
    (tmp_path / "glz_tpu" / "__init__.py").write_text("")  # a stand-in of the JAX package
    path = tmp_path / "glzbench" / planted
    path.write_text(path.read_text() + "\nimport glz_tpu  # noqa: E402, F401\n")
    code = ("import sys, time; from glzbench import harness; "
            "c = harness.load_cell('byte-throughput.and3-100MB'); "
            "code, result = harness.run_cell(c, 5, 0.01, False, time.perf_counter(), "
            "device='cpu', scale=1e-5); "
            "print(result is None and 'no result' or result); sys.exit(code)")
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))  # the program; glzbench is the copy's
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 3, out.stderr[-4000:]
    assert out.stdout.split("\n")[-2] == "no result"
    assert "holds ['glz_tpu'] after the window" in out.stderr
