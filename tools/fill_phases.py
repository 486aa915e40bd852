#!/usr/bin/env python3
"""Time how a call's result `bytes` gets its memory, on the host of the card.

    python3 tools/fill_phases.py            # from the repository root
    python3 tools/fill_phases.py --quick    # 3 repeats, fewer sizes (a smoke run)

A decompress returns its output, a compress its container, each as one new
`bytes` object copied once from a buffer (utils/fill.py fresh_bytes).  Each
result is dropped before the next is made, as the benchmark drops a call's
answer before its next call: one above glibc's 32 MiB mmap ceiling starts
cold every time, a smaller one may get the heap's pages back.  The source
is page-locked memory on the card's host (what host_array hands
host_bytes), else a warm numpy array.  Rows, the median (min-max) of 9:

  tobytes        numpy's tobytes of the source: the plain copy, the result's
                 pages faulting one by one under it
  bulk<p>        fresh_bytes(n) from 0 bytes on (BULK_FLOOR 0), its
                 population on at most p threads: `now` fills at once
                 (the wait for the population and the copy), `lead` fills
                 after n / 4 GB/s of sleep (the card's share of such a call),
                 the time the caller still waits
  silesia        the twelve Silesia members' sizes in the corpus's order,
                 5 rounds: for each, a 0.6-size container and then the
                 output made and dropped as a call makes them, plainly and
                 in bulk (with the lead); the output's time, member by member
  beside_h2d<p>  on the card: a pageable 56,012,000-B H2D (the `and3-100MB`
                 payload) alone, and with a 10^8-B population started
                 before it; then the fill's wait after it

Prints one JSON line a row and writes them all to build/fill_phases.json.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import platform
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from glz_tpu_torch.utils import fill  # noqa: E402

SIZES = (100_000_000, 56_012_000, 51_220_480, 16_777_216, 12_582_912, 8_388_608, 4_194_304,
         1_048_576)
SILESIA = (10_192_446, 51_220_480, 9_970_564, 33_553_445, 6_152_192, 10_085_684, 6_627_202,
           21_606_400, 7_251_944, 41_458_703, 5_345_280, 8_474_240)
POPULATE = (1, 2, 4)
LEAD_BYTES_PER_S = 4e9
H2D_BYTES = 56_012_000
POPULATE_BESIDE = 100_000_000


def stats(xs: list[float]) -> dict:
    ms = [x * 1e3 for x in xs]
    return {"median_ms": round(statistics.median(ms), 3), "min_ms": round(min(ms), 3),
            "max_ms": round(max(ms), 3)}


def source(n: int, on_card: bool) -> np.ndarray:
    t = torch.empty(n, dtype=torch.uint8, pin_memory=on_card)
    a = t.numpy()
    a[:] = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    return a


def bulk(populate: int):
    """fresh_bytes on the bulk path at every size, on `populate` threads."""
    fill.BULK_FLOOR, fill.MAX_POPULATE = 0, populate


def plain():
    fill.BULK_FLOOR = 1 << 62


def made(src: np.ndarray, lead: bool) -> tuple[bytes, float]:
    """src's bytes by fresh_bytes, and the seconds the caller waited (after
    the lead, when there is one)."""
    with fill.fresh_bytes(src.size) as dest:
        if lead:
            time.sleep(src.size / LEAD_BYTES_PER_S)
        t0 = time.perf_counter()
        out = dest.fill((src,))
        return out, time.perf_counter() - t0


def time_plain(src: np.ndarray, reps: int) -> dict:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = src.tobytes()
        ts.append(time.perf_counter() - t0)
        del out
    return stats(ts)


def time_bulk(src: np.ndarray, reps: int, lead: bool) -> dict:
    ts = []
    for _ in range(reps):
        out, t = made(src, lead)
        assert out[:64] == src[:64].tobytes() and out[-64:] == src[-64:].tobytes()
        ts.append(t)
        del out
    return stats(ts)


def silesia(on_card: bool, rounds: int, populate: int) -> list[dict]:
    """Each member's output time in the corpus's order, plainly and in bulk."""
    srcs = [source(n, on_card) for n in SILESIA]
    boxes = [source(int(0.6 * n), on_card) for n in SILESIA]
    times = {"plain": [[] for _ in SILESIA], "bulk": [[] for _ in SILESIA]}
    for _ in range(rounds):
        for how in times:
            plain() if how == "plain" else bulk(populate)
            for i, (src, box) in enumerate(zip(srcs, boxes)):
                container, _ = made(box, how == "bulk")
                out, t = made(src, how == "bulk")
                times[how][i].append(t)
                del container, out
    return [{"row": "silesia", "n": n, "plain": stats(times["plain"][i]),
             "bulk": stats(times["bulk"][i])} for i, n in enumerate(SILESIA)]


def beside_h2d(reps: int, populate: int) -> dict:
    bulk(populate)
    host = torch.from_numpy(np.random.default_rng(3).integers(0, 256, H2D_BYTES, np.uint8))
    dev = torch.empty(H2D_BYTES, dtype=torch.uint8, device="cuda")
    src = source(POPULATE_BESIDE, True)

    def h2d() -> float:
        t0 = time.perf_counter()
        dev.copy_(host)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    h2d()
    alone, beside, wait = [], [], []
    for _ in range(reps):
        alone.append(h2d())
        with fill.fresh_bytes(POPULATE_BESIDE) as dest:
            beside.append(h2d())
            t0 = time.perf_counter()
            out = dest.fill((src,))
            wait.append(time.perf_counter() - t0)
        del out
    return {"h2d_alone": stats(alone), "h2d_beside": stats(beside), "fill_after": stats(wait)}


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "none"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    reps = 3 if args.quick else 9
    sizes = SIZES[::4] if args.quick else SIZES
    on_card = torch.cuda.is_available()
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    emit({"row": "host", "kernel": platform.release(), "cores": len(os.sched_getaffinity(0)),
          "card": card(), "page": fill.PAGE, "bulk_floor": fill.BULK_FLOOR,
          "slice_bytes": fill.SLICE_BYTES, "max_slices": fill.MAX_SLICES,
          "max_populate": fill.MAX_POPULATE})
    floor, populate = fill.BULK_FLOOR, fill.MAX_POPULATE
    try:
        for n in sizes:
            src = source(n, on_card)
            emit({"row": "tobytes", "n": n, **time_plain(src, reps)})
            for p in POPULATE:
                bulk(p)
                emit({"row": f"bulk{p}", "n": n, "now": time_bulk(src, reps, False),
                      "lead": time_bulk(src, reps, True)})
        for row in silesia(on_card, 2 if args.quick else 5, populate):
            emit(row)
        if on_card:
            for p in POPULATE:
                emit({"row": f"beside_h2d{p}", "n": POPULATE_BESIDE, **beside_h2d(reps, p)})
    finally:
        fill.BULK_FLOOR, fill.MAX_POPULATE = floor, populate
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "fill_phases.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
