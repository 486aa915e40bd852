"""glz_tpu_torch's command line against glz_tpu's.

tests/test_cli.py's cases, each run on glz_tpu_torch.cli.main under
GLZ_PLATFORM=cpu (the kernels' plain versions) and on glz_tpu.cli.main with
the same arguments, each package in a directory of its own holding the same
input files.  Every file either writes (.glz, .glzb, .crs, .crs2, .crs3, .de,
.dot) must be byte-identical, the exit codes equal, and the printed text
equal once the timings are masked.  Then the three repairs the port makes to
glz_tpu's command line, and its refusal to run without a card.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from glz_tpu import cli as tpu_cli

from glz_tpu_torch import cli
from glz_tpu_torch.core import container
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_TIMES = re.compile(r"in [0-9.]+ ms|\[[0-9.]+ MB/s\]")


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setenv("GLZ_PLATFORM", "cpu")


@pytest.fixture
def sample(text_100kb):
    return {"sample.txt": text_100kb[:30_000]}


def run_both(tmp_path, capsys, inputs: dict[str, bytes], *argvs: list[str]) -> dict:
    """Run each argv ("{d}" in an argument is the run's directory) through
    glz_tpu's CLI and then the port's, each in its own directory that holds
    `inputs`.  Asserts equal exit codes, equal printed text (timings and
    directories masked) and byte-identical files; returns the port's
    {"dir", "rcs", "out", "err"}."""
    runs = {}
    for name, main in (("tpu", tpu_cli.main), ("port", cli.main)):
        d = tmp_path / name
        d.mkdir()
        for fname, data in inputs.items():
            (d / fname).write_bytes(data)
        capsys.readouterr()
        rcs = [main([a.replace("{d}", str(d)) for a in argv]) for argv in argvs]
        cap = capsys.readouterr()
        runs[name] = {"dir": d, "rcs": rcs,
                      "out": _TIMES.sub("<t>", cap.out.replace(str(d), "{d}")),
                      "err": cap.err.replace(str(d), "{d}")}
    tpu, port = runs["tpu"], runs["port"]
    assert port["rcs"] == tpu["rcs"]
    assert port["out"] == tpu["out"]
    names = sorted(p.name for p in tpu["dir"].iterdir())
    assert sorted(p.name for p in port["dir"].iterdir()) == names
    for n in names:
        assert (port["dir"] / n).read_bytes() == (tpu["dir"] / n).read_bytes(), n
    return port


def test_cli_roundtrip_glz(tmp_path, capsys, sample):
    port = run_both(tmp_path, capsys, sample, ["compress", "{d}/sample.txt"],
                    ["decompress", "{d}/sample.txt.glz"])
    assert port["rcs"] == [0, 0]
    d = port["dir"]
    assert (d / "sample.txt.glz.de").read_bytes() == sample["sample.txt"]


def test_cli_huffword(tmp_path, capsys, sample):
    port = run_both(tmp_path, capsys, sample,
                    ["compress", "{d}/sample.txt", "{d}/sample.txt.w.glz", "--model", "huffword"],
                    ["decompress", "{d}/sample.txt.w.glz"])
    assert port["rcs"] == [0, 0]
    assert (port["dir"] / "sample.txt.w.glz.de").read_bytes() == sample["sample.txt"]


def test_cli_utet_modes(tmp_path, capsys, sample):
    # canonical: mode 3 compress, 4/5/6 decompress; normal: mode 1, then 2
    argvs = [["utet", "{d}/sample.txt", "3"]]
    argvs += [["utet", "{d}/sample.txt.crs2", m] for m in ("4", "5", "6")]
    argvs += [["utet", "{d}/sample.txt", "1"], ["utet", "{d}/sample.txt.crs", "2"],
              ["utet", "{d}/sample.txt", "7"]]
    port = run_both(tmp_path, capsys, sample, *argvs)
    assert port["rcs"] == [0] * 6 + [2]
    d = port["dir"]
    assert (d / "sample.txt.crs2.de").read_bytes() == sample["sample.txt"]
    assert (d / "sample.txt.crs.de").read_bytes() == sample["sample.txt"]


def test_cli_info(tmp_path, capsys, sample):
    port = run_both(tmp_path, capsys, sample, ["compress", "{d}/sample.txt"],
                    ["info", "{d}/sample.txt.glz"])
    assert "canonical_byte" in port["out"] and "streams=" in port["out"]


def test_cli_info_stats(tmp_path, capsys, sample):
    port = run_both(tmp_path, capsys, sample, ["compress", "{d}/sample.txt"],
                    ["info", "{d}/sample.txt.glz", "--stats", "--original", "{d}/sample.txt"])
    assert "average code length" in port["out"] and "predicted ratio" in port["out"]


def test_stats_predicted_matches_actual(tmp_path, capsys, sample):
    """predicted ratio (avg code length / 8) ~= payload_bits/(8*n_symbols),
    and the report equals glz_tpu's for the same container."""
    from glz_tpu_torch.core.codebook import histogram_bytes

    port = run_both(tmp_path, capsys, sample, ["compress", "{d}/sample.txt"])
    data = sample["sample.txt"]
    f = container.read_container((port["dir"] / "sample.txt.glz").read_bytes())
    rep = cli.stats_report(f, histogram_bytes(data))
    assert rep == tpu_cli.stats_report(f, histogram_bytes(data))
    predicted = float(re.search(r"predicted ratio: ([0-9.]+)", rep).group(1))
    actual = float(re.search(r"actual payload ratio: ([0-9.]+)", rep).group(1))
    assert abs(predicted - actual) < 0.001


def test_cli_info_stats_huffword(tmp_path, capsys, sample):
    port = run_both(tmp_path, capsys, sample,
                    ["compress", "{d}/sample.txt", "{d}/w.glz", "--model", "huffword"],
                    ["info", "{d}/w.glz", "--stats", "--original", "{d}/sample.txt"],
                    ["info", "{d}/w.glz", "--stats"])
    rep = port["out"]
    assert "word dictionary" in rep and "nonword dictionary" in rep
    assert "avg code length" in rep
    predicted = float(re.search(r"predicted ratio: ([0-9.]+)", rep).group(1))
    actual = float(re.search(r"actual ratio: ([0-9.]+)", rep).group(1))
    assert 0 < predicted <= actual + 1e-6
    assert abs(predicted - actual) < 0.01


def test_cli_info_stats_normal_tree(tmp_path, capsys, sample):
    port = run_both(tmp_path, capsys, sample,
                    ["compress", "{d}/sample.txt", "{d}/nt.glz", "--model", "normal_tree"],
                    ["info", "{d}/nt.glz", "--stats", "--original", "{d}/sample.txt"])
    rep = port["out"]
    assert "average code length" in rep and "predicted ratio" in rep
    assert "length  code" in rep


def test_cli_preset_and_layout(tmp_path, capsys, sample):
    port = run_both(tmp_path, capsys, sample,
                    ["compress", "{d}/sample.txt", "{d}/ls.glz", "--preset", "throughput",
                     "--checksum"],
                    ["info", "{d}/ls.glz"], ["decompress", "{d}/ls.glz"])
    assert port["rcs"] == [0, 0, 0]
    assert (port["dir"] / "ls.glz.de").read_bytes() == sample["sample.txt"]


def test_cli_normal_tree_front_door(tmp_path, capsys, sample):
    port = run_both(tmp_path, capsys, sample,
                    ["compress", "{d}/sample.txt", "{d}/nt.glz", "--model", "normal_tree"],
                    ["decompress", "{d}/nt.glz"])
    assert (port["dir"] / "nt.glz.de").read_bytes() == sample["sample.txt"]


@pytest.mark.parametrize("compat", ["crs", "crs2", "crs3"])
def test_cli_compat_flag(tmp_path, capsys, sample, compat):
    port = run_both(tmp_path, capsys, sample,
                    ["compress", "{d}/sample.txt", "--compat", compat],
                    ["decompress", f"{{d}}/sample.txt.{compat}"])
    assert port["rcs"] == [0, 0]
    assert (port["dir"] / f"sample.txt.{compat}.de").read_bytes() == sample["sample.txt"]


def test_cli_info_dot_tree(tmp_path, capsys, sample):
    port = run_both(tmp_path, capsys, sample,
                    ["compress", "{d}/sample.txt", "{d}/nt.glz", "--model", "normal_tree"],
                    ["info", "{d}/nt.glz", "--dot", "{d}/tree.dot"],
                    ["compress", "{d}/sample.txt"],
                    ["info", "{d}/sample.txt.glz", "--dot", "{d}/tree2.dot"])
    assert port["rcs"] == [0, 0, 0, 2]  # byte-mode containers have no explicit tree
    text = (port["dir"] / "tree.dot").read_text()
    assert text.startswith("digraph hufftree")
    assert text.count('[label="0"]') == text.count('[label="1"]') > 10


def test_cli_group_rows_flag(tmp_path, capsys, sample):
    port = run_both(tmp_path, capsys, sample,
                    ["compress", "{d}/sample.txt", "{d}/g16.glz", "--layout", "lockstep",
                     "--stream-symbols", "64", "--group-rows", "16"],
                    ["decompress", "{d}/g16.glz"])
    assert container.read_container((port["dir"] / "g16.glz").read_bytes()).group_rows == 16
    assert (port["dir"] / "g16.glz.de").read_bytes() == sample["sample.txt"]


def _two_files(text_100kb):
    return {"a.txt": text_100kb[:30_000], "b.txt": text_100kb[30_000:55_000]}


@pytest.mark.parametrize("extra", [["--checksum"],
                                   ["--model", "huffword", "--layout", "lockstep",
                                    "--stream-symbols", "64"]])
def test_cli_archive_roundtrip(tmp_path, capsys, text_100kb, extra):
    files = _two_files(text_100kb)
    port = run_both(tmp_path, capsys, files,
                    ["archive", "{d}/x.glzb", "{d}/a.txt", "{d}/b.txt", *extra],
                    ["unarchive", "{d}/x.glzb", "{d}/a.out", "{d}/b.out"])
    assert port["rcs"] == [0, 0]
    assert (port["dir"] / "a.out").read_bytes() == files["a.txt"]
    assert (port["dir"] / "b.out").read_bytes() == files["b.txt"]


def test_cli_unarchive_wrong_count(tmp_path, capsys, text_100kb):
    port = run_both(tmp_path, capsys, {"a.txt": text_100kb[:10_000]},
                    ["archive", "{d}/x.glzb", "{d}/a.txt"],
                    ["unarchive", "{d}/x.glzb", "{d}/1", "{d}/2"])
    assert port["rcs"] == [0, 2]
    assert "archive holds 1 files but 2 output names given" in port["err"]


def test_cli_info_archive(tmp_path, capsys, text_100kb):
    files = {"a.txt": text_100kb[:12_000], "b.txt": text_100kb[12_000:20_000]}
    port = run_both(tmp_path, capsys, files,
                    ["archive", "{d}/x.glzb", "{d}/a.txt", "{d}/b.txt"], ["info", "{d}/x.glzb"])
    out = port["out"]
    assert "archive mode=canonical_byte files=2" in out
    assert "file 0: symbols=12000" in out
    assert "file 1: symbols=8000" in out


# ---- the port's own repairs --------------------------------------------------

@pytest.mark.parametrize("cut", [20, 16 + 6, -5])
def test_info_on_a_truncated_archive_raises_value_error(tmp_path, text_100kb, cut):
    """A truncated .glzb (inside the shared codebook, inside an entry
    header, inside the last entry) raises ValueError, not struct.error."""
    files = _two_files(text_100kb)
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    arc = tmp_path / "x.glzb"
    assert cli.main(["archive", str(arc), *(str(tmp_path / n) for n in files)]) == 0
    blob = arc.read_bytes()
    bad = tmp_path / "bad.glzb"
    if cut == 16 + 6:  # the shared codebook ends in the middle of entry 0's header
        cut = 16 + int.from_bytes(blob[12:16], "little") + 6
    bad.write_bytes(blob[:cut])
    with pytest.raises(ValueError, match="corrupt .glzb archive"):
        cli.main(["info", str(bad)])


@pytest.mark.parametrize("model", ["normal_tree", "nonsense"])
def test_archive_accepts_only_byte_and_huffword(tmp_path, capsys, model):
    (tmp_path / "a.txt").write_bytes(b"abc " * 100)
    with pytest.raises(SystemExit) as e:
        cli.main(["archive", str(tmp_path / "x.glzb"), str(tmp_path / "a.txt"),
                  "--model", model])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err
    assert not (tmp_path / "x.glzb").exists()


def test_unarchive_checks_the_name_count_before_decoding(tmp_path, capsys, monkeypatch,
                                                        text_100kb):
    import glz_tpu_torch

    (tmp_path / "a.txt").write_bytes(text_100kb[:10_000])
    arc = tmp_path / "x.glzb"
    assert cli.main(["archive", str(arc), str(tmp_path / "a.txt")]) == 0
    calls = []
    monkeypatch.setattr(glz_tpu_torch, "decompress_archive",
                        lambda *a, **k: calls.append(a) or [])
    assert cli.main(["unarchive", str(arc), str(tmp_path / "1"), str(tmp_path / "2")]) == 2
    assert calls == []
    assert "archive holds 1 files but 2 output names given" in capsys.readouterr().err
    assert not (tmp_path / "1").exists()


def test_no_card_fails_at_once(tmp_path, capsys, monkeypatch):
    """Without GLZ_PLATFORM=cpu the command line runs on the card; with no
    card it fails before reading its input and writes nothing."""
    monkeypatch.delenv("GLZ_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "a.txt"
    src.write_bytes(b"abc " * 100)
    assert cli.main(["compress", str(src)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a.txt"]


def test_module_entry_point(tmp_path, text_100kb):
    """python -m glz_tpu_torch.cli runs main() and exits with its code."""
    src = tmp_path / "a.txt"
    src.write_bytes(text_100kb[:5_000])
    root = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, "GLZ_PLATFORM": "cpu"}
    for argv in (["compress", str(src)], ["decompress", f"{src}.glz"]):
        r = subprocess.run([sys.executable, "-m", "glz_tpu_torch.cli", *argv], cwd=root,
                           env=env, capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
    assert (tmp_path / "a.txt.glz.de").read_bytes() == src.read_bytes()
    r = subprocess.run([sys.executable, "-m", "glz_tpu_torch.cli"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "usage: glz" in r.stderr
