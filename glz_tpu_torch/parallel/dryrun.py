"""Entry points: one dispatch of the block encoder, and a multi-device dry
run of the sharded codec.  The port's counterpart of the repository's
__graft_entry__.py (which drives glz_tpu).

    python -m glz_tpu_torch.parallel.dryrun                  # every card, one rank each
    python -m glz_tpu_torch.parallel.dryrun --cpu --devices 8  # 8 gloo ranks on the CPU

dryrun_multichip(n_devices, device=None) spawns n_devices ranks
(parallel/ranks.py) that run two phases on tiny shapes, each checked for
an exact round trip on every rank:
  1. the sharded histogram (a 2-axis mesh when n_devices is even and above
     2), the codebook built from it, and codec_step at S = 256, two streams
     a rank;
  2. lockstep_codec_step at rows 16, S 32, one group a rank.
On the card it needs one card a rank (NCCL); with device='cpu' the ranks
are gloo processes.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from glz_tpu_torch.core.codebook import build_codebook
from glz_tpu_torch.core.lockstep import LANES
from glz_tpu_torch.models.canonical_byte import decode_tables, entry_table
from glz_tpu_torch.models.transfer import i32_tensor, resolve_device
from glz_tpu_torch.ops.encode import encode_block_fast
from glz_tpu_torch.parallel import mesh as pmesh
from glz_tpu_torch.parallel import ranks


def entry(device=None):
    """(fn, example_args): one dispatch of the block encoder (K7 + the
    pack) at S 1024 on 8,192 symbols, 100 of them past n_valid, with a
    fixed uniform 8-bit code."""
    dev = resolve_device(device)
    S = 1 << 10
    n = S * 8
    rng = np.random.default_rng(0)
    sym = torch.from_numpy(rng.integers(0, 256, size=n, dtype=np.uint8)).to(dev)
    n_valid = n - 100
    lj_tbl = i32_tensor(np.arange(256, dtype=np.uint32) << 24, dev)
    len_tbl = torch.full((256,), 8, dtype=torch.int32, device=dev)

    def fn(sym, n_valid, lj_tbl, len_tbl):
        return encode_block_fast(sym, n_valid, lj_tbl, len_tbl, S)

    return fn, (sym, n_valid, lj_tbl, len_tbl)


def _rank_step(n_devices: int, device_type: str) -> dict:
    """One rank of the dry run (see the module docstring); raises on a
    mismatch."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" \
        else torch.device("cpu")
    if n_devices % 2 == 0 and n_devices > 2:
        mesh = pmesh.make_mesh(n_devices, axis_names=("data", "stream"),
                               shape=(n_devices // 2, 2), device=device_type)
    else:
        mesh = pmesh.make_mesh(n_devices, device=device_type)
    idx = pmesh._flat_device_index(mesh)

    S = 256
    n = n_devices * 2 * S
    rng = np.random.default_rng(1)
    data = rng.integers(0, 64, size=n, dtype=np.uint8)
    n_valid = n - 17
    data[n_valid:] = 0
    local_n = n // n_devices
    local = torch.from_numpy(data[idx * local_n : (idx + 1) * local_n].copy()).to(dev)
    hist = pmesh.sharded_histogram(mesh, local).cpu().numpy()
    hist[0] -= n - n_valid
    cb = build_codebook(hist)
    words, total_bits, stream_bits, out = pmesh.codec_step(
        mesh, local, n_valid, i32_tensor(cb.left_justified_codes(), dev),
        i32_tensor(cb.lengths, dev), *decode_tables(cb, dev), cb.min_len, cb.max_len, S)
    want = data[idx * local_n : min((idx + 1) * local_n, n_valid)]
    if not np.array_equal(out.cpu().numpy(), want):
        raise AssertionError(f"multi-device round trip mismatch (layout 0) on rank {idx}")

    rows2, S2 = 16, 32
    group_syms = rows2 * LANES * S2
    n2 = n_devices * group_syms
    data2 = rng.integers(0, 64, size=n2, dtype=np.uint8)
    n_valid2 = n2 - 4321
    cb2 = build_codebook(np.bincount(data2[:n_valid2], minlength=256).astype(np.int64), 26)
    local2 = torch.from_numpy(data2[idx * group_syms : (idx + 1) * group_syms].copy()).to(dev)
    _, gw_all, out2 = pmesh.lockstep_codec_step(
        mesh, local2, n_valid2, entry_table(cb2, dev), *decode_tables(cb2, dev), S2,
        cb2.min_len, cb2.max_len, rows=rows2)
    want2 = data2[idx * group_syms : min((idx + 1) * group_syms, n_valid2)]
    if not np.array_equal(out2.cpu().numpy(), want2):
        raise AssertionError(f"multi-device round trip mismatch (layout 2) on rank {idx}")
    return {"total_bits": total_bits, "streams": stream_bits.numel(),
            "gw_all": gw_all.cpu().tolist(), "rows": rows2}


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600.0) -> list[dict]:
    """Run the dry run on n_devices ranks (one card each, or gloo processes
    with device='cpu'), print one line a phase and return every rank's
    summary."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"the dry run needs one card a rank: {n_devices} ranks, "
                           f"{torch.cuda.device_count()} cards")
    got = ranks.run("glz_tpu_torch.parallel.dryrun:_rank_step", n_devices, n_devices,
                    dev.type, timeout=timeout)
    print(f"dryrun_multichip({n_devices}) layout=bitstream on {dev.type}: OK — "
          f"{sum(r['total_bits'] for r in got)} payload bits across "
          f"{sum(r['streams'] for r in got)} streams")
    gw_all = got[0]["gw_all"]
    print(f"dryrun_multichip({n_devices}) layout=lockstep on {dev.type}: OK — "
          f"{sum(gw_all)} payload words across {len(gw_all)} wide groups "
          f"({n_devices * got[0]['rows'] * LANES} lockstep streams, rows={got[0]['rows']})")
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks (default: every card, or 8 with --cpu)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    dev = resolve_device(device)
    n = args.devices or (8 if args.cpu else torch.cuda.device_count())
    dryrun_multichip(n, device=device)
    fn, example = entry(device=dev)
    print("entry total_bits:", fn(*example)[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
