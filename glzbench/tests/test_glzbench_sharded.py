"""The cell of several processes (glzbench/spmd.py) on the CPU: gloo ranks
on the program's plain path (device="cpu"), at a test geometry (64-symbol
streams in 8-row groups, 64 KiB a group) and a 610,000-byte file, so each
of the four ranks holds two groups or more of its shard and of its slice.
The ranks run as the benchmark's do, past the look for the cards."""

import dataclasses
import hashlib
import inspect
import time

import numpy as np
import pytest

from glzbench import faults, harness, spmd, traffic
from glzbench.reference import glz_sharded

WORKLOAD = "byte-sharded.enwik9"
SEED = 2**31 + 61
BYTES = 610_000


def small_cell():
    """The cell at the test geometry and size."""
    cell = harness.load_cell(WORKLOAD)
    spec = dict(cell.traffic, files=[dict(f, bytes=BYTES) for f in cell.traffic["files"]])
    return dataclasses.replace(cell, config=dict(cell.config, conf=dict(
        cell.config["conf"], stream_symbols=64, group_rows=8)), traffic=spec)


def test_the_shards_follow_the_drivers_rule():
    cell = harness.load_cell(WORKLOAD)
    assert spmd.group_bytes(cell.config) == 4_194_304
    assert spmd.shard_bounds(10**9, 4, 4_194_304) == [0, 247_463_936, 499_122_176,
                                                       746_586_112, 10**9]
    small = small_cell()
    align = spmd.group_bytes(small.config)
    data = traffic.make_files(small.traffic, SEED)[0][1]
    shards = [spmd._make_files(small, SEED, 1.0, k, 4)[0].shard for k in range(4)]
    assert b"".join(shards) == data
    assert [len(s) for s in shards] == [2 * align, 2 * align, 2 * align, BYTES - 6 * align]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_multi_rank_run_is_correct(trace):
    cell = small_cell()
    code, result = harness.run_cell(cell, SEED, 1.0, bool(trace), time.perf_counter(),
                                    device="cpu")
    assert code == 0 and result["correct"], result
    assert result["device"]["count"] == 4 and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if trace:
        want -= {"device_idle.compress", "device_idle.decompress"}  # no device on the CPU
        assert 0 < result["metrics"]["collective_share.compress"]["value"] < 100
    assert want == set(result["metrics"])
    assert want and result["attempted"] >= 2


def test_one_process_leaves_entry_and_step_as_they_were(monkeypatch):
    """A configuration of one process runs harness.Entry and harness._step,
    whose sources are what they were before the cells of several
    processes, and never reaches glzbench/spmd.py."""
    source = {f.__name__: hashlib.sha256(inspect.getsource(f).encode()).hexdigest()[:16]
              for f in (harness.Entry, harness._step)}
    assert source == {"Entry": "0be7e920c6241bee", "_step": "78adb13cfb6a7680"}

    def refuse(*args, **kwargs):
        raise AssertionError("a one-process cell reached spmd.run_cell")

    monkeypatch.setattr(spmd, "run_cell", refuse)
    cell = harness.load_cell("byte-throughput.and3-100MB")
    assert "processes" not in cell.config
    code, result = harness.run_cell(cell, SEED, 0.01, False, time.perf_counter(),
                                    device="cpu", scale=1e-5)
    assert code == 0 and result["correct"] and result["device"]["count"] == 1


def test_a_rank_that_raises_ends_the_run_well_inside_the_timeout():
    start = time.monotonic()
    code, result = spmd.run_cell(small_cell(), SEED, 30.0, False, time.perf_counter(),
                                 device="cpu", path="raises")
    assert code != 0 and result is None
    assert time.monotonic() - start < 60 < spmd.JOIN_TIMEOUT


def test_a_cell_that_asks_for_other_chips_is_refused():
    cell = dataclasses.replace(small_cell(), chips=1)
    assert spmd.run_cell(cell, SEED, 1.0, False, time.perf_counter(), device="cpu") == (2, None)


def test_every_broken_path_reads_not_correct():
    """glzbench.control's readings on the CPU: one launch of the ranks for
    every path (one more after `raises`, which ends them)."""
    paths = ["sound", *faults.SHARDED]
    readings = {r["path"]: r for r in spmd.control(small_cell(), [SEED], 0.01, paths, "cpu")}
    assert list(readings) == paths
    assert readings["sound"]["correct"], readings["sound"]
    assert all(v == 0 for v in readings["sound"]["checks"].values())
    for path in faults.SHARDED:
        assert not readings[path]["correct"], path
        assert any(v > 0 for v in readings[path]["checks"].values()), readings[path]
    assert readings["raises"]["checks"]["failed_ranks"] >= 1  # the last rank, and those its end cut off
    assert readings["local_codebook"]["checks"]["reference_wrong_bytes"] > 0
    assert readings["shard_dropped"]["checks"]["format_faults"] > 0


def test_the_untiled_bytes_count_gaps_overlaps_and_strays():
    assert spmd.untiled_bytes(100, [(0, 40), (40, 60)]) == 0
    assert spmd.untiled_bytes(100, [(0, 40), (50, 50)]) == 10
    assert spmd.untiled_bytes(100, [(0, 60), (40, 60)]) == 20
    assert spmd.untiled_bytes(100, [(0, 100), (100, 5)]) == 5
    assert spmd.untiled_bytes(100, [(0, 100), (0, 0)]) == 0


def _lockstep(data: bytes, conf: dict, counts: np.ndarray) -> bytes:
    """The program's lockstep container of `data` under the code of `counts`."""
    import glz_tpu_torch
    from glz_tpu_torch.core.codebook import build_codebook
    from glz_tpu_torch.models.canonical_byte import compress_bytes_lockstep

    return compress_bytes_lockstep(data, glz_tpu_torch.GlzConfig(**conf["conf"]),
                                   codebook=build_codebook(counts.astype(np.int64), 26),
                                   device="cpu")


def test_the_reference_flags_a_code_not_least_for_the_whole_file():
    """A container coded with one shard's histogram decodes right and is
    still refused: its code is not the least for the whole file's counts."""
    cell = small_cell()
    rng = np.random.default_rng(7)
    half = BYTES // 2
    data = (traffic._and(rng, half, {"draws": 3}).tobytes()
            + rng.integers(0, 256, BYTES - half, dtype=np.uint8).tobytes())
    arr = np.frombuffer(data, np.uint8)
    whole = np.bincount(arr, minlength=256)
    assert glz_sharded.check(_lockstep(data, cell.config, whole), data, cell.config,
                             "cpu") == (0, [])
    one_shard = np.bincount(arr[:half], minlength=256) + 1  # every byte keeps a code
    wrong, found = glz_sharded.check(_lockstep(data, cell.config, one_shard), data,
                                     cell.config, "cpu")
    assert wrong == 0 and len(found) == 1 and "not optimal" in found[0]


def test_the_reference_decodes_in_slices(monkeypatch):
    """Slices of one group each read the same as one slice."""
    cell = small_cell()
    data = traffic.make_files(cell.traffic, SEED)[0][1]
    blob = _lockstep(data, cell.config, np.bincount(np.frombuffer(data, np.uint8),
                                                    minlength=256))
    monkeypatch.setattr(glz_sharded, "SLICE_SYMBOLS", spmd.group_bytes(cell.config))
    assert glz_sharded.check(blob, data, cell.config, "cpu") == (0, [])
    flipped = bytearray(blob)
    flipped[-5] ^= 0x10  # a payload bit of the last group
    wrong, found = glz_sharded.check(bytes(flipped), data, cell.config, "cpu")
    assert wrong > 0 or found
