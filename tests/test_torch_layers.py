"""The direction of glz_tpu_torch's imports, read from its source with ast:
the front door (core/api.py) imports the models, the models import
models/transfer.py, ops/ and core/, and nothing below the front door imports
it back."""

import ast
import pathlib

import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401

PACKAGE = pathlib.Path(__file__).resolve().parent.parent / "glz_tpu_torch"
API = "glz_tpu_torch.core.api"
# The layers below the front door: {modules: what they may not import}.  A
# name ending in "." is a package and everything in it, any other one module.
BELOW = {
    "glz_tpu_torch.core.": ("glz_tpu_torch.models.", "glz_tpu_torch.ops.", API,
                            "glz_tpu_torch.parallel.", "glz_tpu_torch.cli"),
    "glz_tpu_torch.models.": (API, "glz_tpu_torch.parallel.", "glz_tpu_torch.cli"),
    "glz_tpu_torch.ops.": ("glz_tpu_torch.models.", API, "glz_tpu_torch.parallel.",
                           "glz_tpu_torch.cli"),
    "glz_tpu_torch.models.transfer": ("glz_tpu_torch.models.",),
}
# the modules that may import the front door
ABOVE = ("glz_tpu_torch", "glz_tpu_torch.cli", "glz_tpu_torch.parallel.")


def _modules() -> dict[str, ast.Module]:
    out = {}
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = path.relative_to(PACKAGE.parent).with_suffix("").parts
        name = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
        out[name] = ast.parse(path.read_text(), str(path))
    return out


MODULES = _modules()


def _imports(tree: ast.Module):
    """(module imported, names taken from it, whether at the top level) of
    each import of the package in `tree`; `from pkg import mod` counts as
    an import of pkg.mod."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith("glz_tpu_torch"):
                    yield a.name, (), id(node) in top
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith("glz_tpu_torch"):
            for a in node.names:
                sub = f"{node.module}.{a.name}"
                if sub in MODULES:
                    yield sub, (), id(node) in top
                else:
                    yield node.module, (a.name,), id(node) in top


def _matches(name: str, prefix: str) -> bool:
    return name == prefix.rstrip(".") or (prefix.endswith(".") and name.startswith(prefix))


def _below(module: str, prefix: str) -> bool:
    return module != API and _matches(module, prefix)


def _violations(module: str, tree: ast.Module) -> list[str]:
    out = []
    for target, names, at_top in _imports(tree):
        where = f"{module} imports {target}" + (f" ({', '.join(names)})" if names else "")
        for prefix, banned in BELOW.items():
            if _below(module, prefix) and target != module and any(
                    _matches(target, b) for b in banned):
                out.append(f"{where}: {prefix} sits below it")
        if target == API and module != API and not any(_matches(module, p) for p in ABOVE):
            out.append(f"{where}: only {', '.join(ABOVE)} import the front door")
        if module == API and not at_top:
            out.append(f"{where} inside a function: the front door imports at the top")
        hidden = [n for n in names if n.startswith("_") and not n.startswith("__")]
        last = target.rsplit(".", 1)[-1]
        if target != module and (hidden or (last.startswith("_") and last != "_kernels")):
            out.append(f"{where}: a private name crosses modules")
    return out


@pytest.mark.parametrize("module", sorted(MODULES))
def test_imports_point_down_the_layers(module):
    assert _violations(module, MODULES[module]) == []


@pytest.mark.parametrize("source, bad", [
    ("from glz_tpu_torch.core.api import _pipelined", True),
    ("import glz_tpu_torch.core.api", True),
    ("from glz_tpu_torch.models import transfer", False),
    ("from glz_tpu_torch.models.huffword import huffword_cb_blob", False),
    ("from glz_tpu_torch.ops import _kernels", False),
    ("from glz_tpu_torch.models.transfer import _hidden", True),
    ("def f():\n    from glz_tpu_torch.ops.lockstep_encode import MAX_FUSED_LEN", True),
], ids=["private-upward", "upward", "transfer", "sibling-model", "kernels", "private",
        "ops-from-core"])
def test_the_scan_sees_a_wrong_import(source, bad):
    """A model importing each line, and core/lockstep.py importing the last."""
    module = ("glz_tpu_torch.core.lockstep" if "ops.lockstep" in source
              else "glz_tpu_torch.models.canonical_byte")
    assert bool(_violations(module, ast.parse(source))) == bad
