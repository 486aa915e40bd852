"""The readings the limits of `correct` are set from, on the card at a
cell's own size: `python3 -m glzbench.control --workload <cell> --seeds
<n> ... --seconds <s>`.

For each seed the cell's files are made once; then the sound program and
each broken path of glzbench/faults.py run one short window of the cell's
own traffic, and the numbers `correct` compares are read as a run reads
them.  One JSON line a (seed, path).  A cell of several processes runs
the paths of faults.SHARDED on one launch of its ranks (spmd.control): a
path that ends the ranks reads as not correct, with the number of ranks
that failed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from glzbench import faults, harness, spmd, traffic


def readings(cell: harness.Cell, entry, files: list, seconds: float,
             device=None) -> tuple[bool, dict]:
    """(correct, the numbers compared) of one window of `entry` on `files`."""
    run, tally = harness.measure(cell, entry, files, seconds, False, device)
    checks = harness.judge(cell, files, tally, device)
    return bool(run.calls) and all(v <= limit for v, limit in checks.values()), checks


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m glzbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--paths", nargs="+")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("glzbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if cell.config.get("processes", 1) > 1:
        for reading in spmd.control(cell, args.seeds, args.seconds,
                                    args.paths or ["sound", *faults.SHARDED]):
            print(json.dumps(reading), flush=True)
        return 0
    args.paths = args.paths or ["sound", *faults.FAULTS]
    for seed in args.seeds:
        files = traffic.make_files(cell.traffic, seed)
        for path in args.paths:
            entry = (harness.Entry if path == "sound" else faults.FAULTS[path])(cell.config)
            t = time.perf_counter()
            correct, checks = readings(cell, entry, files, args.seconds)
            print(json.dumps({"workload": cell.name, "seed": seed, "path": path,
                              "correct": correct, "seconds": time.perf_counter() - t,
                              "checks": {k: v for k, (v, _) in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
