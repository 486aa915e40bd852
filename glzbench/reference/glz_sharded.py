"""The plain reference of the sharded configuration: the file-order lockstep
container (layout 2, byte mode) that several processes write together,
each coding its shard with one code of the whole file's byte counts.

It reads the container with glz_lockstep's reader (the format is the one
described there) and holds it to two more guarantees: the code is an
optimal prefix code of the whole file's exact byte counts among those with
no code longer than the lockstep layout's limit (the configuration's
length_limit, at most the 26 bits a fused entry word leaves the code:
glz_lockstep.MAX_LEN), and the whole container decodes in one process.
The decode runs in slices of whole groups, at most SLICE_SYMBOLS symbols
each, so a 10^9-byte file decodes in a few GB of the card's memory.

It imports nothing of the program and takes nothing the program made but
the container it judges.  `check(blob, data, conf, device)` gives the
number of output bytes that differ from the input (a missing or extra
byte counts as one) and the list of format faults found.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import glz_lockstep as lockstep
from .glz_bitstream import least_cost

SLICE_SYMBOLS = 1 << 28  # symbols decoded at a time, in whole groups
COUNT_CHUNK = 1 << 28    # bytes counted at a time


def byte_counts(ref: torch.Tensor) -> np.ndarray:
    """The exact count of each byte value (int64) of a uint8 tensor."""
    counts = torch.zeros(256, dtype=torch.int64, device=ref.device)
    for a in range(0, ref.numel(), COUNT_CHUNK):
        counts += torch.bincount(ref[a : a + COUNT_CHUNK].int(), minlength=256)
    return counts.cpu().numpy()


def check(blob: bytes, data: bytes, conf: dict, device) -> tuple:
    """(wrong bytes, faults) of one container against its input under the
    configuration `conf` (its mode, stream_symbols, group_rows,
    length_limit and checksum)."""
    c = lockstep.parse(blob, len(data), conf)
    faults = c.faults
    if c.words is None or faults:
        return len(data), faults
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # read-only bytes: only read
        ref = (torch.frombuffer(data, dtype=torch.uint8) if data
               else torch.zeros(0, dtype=torch.uint8)).to(device)
    counts = byte_counts(ref)
    lengths = c.lengths[0]
    faults.need(not ((counts > 0) & (lengths == 0)).any(), "a byte of the input has no code")
    limit = min(conf["conf"]["length_limit"] or lockstep.MAX_LEN, lockstep.MAX_LEN)
    best = least_cost(counts, limit)
    cost = int((counts * lengths).sum())
    faults.need(cost == best, f"a code of {cost} bits where the least is {best} (not optimal "
                f"for the whole file's exact byte counts at {limit} bits)")
    S, rows = conf["conf"]["stream_symbols"], conf["conf"]["group_rows"]
    group = rows * lockstep.LANES * S
    per = max(1, SLICE_SYMBOLS // group)
    first_word = np.cumsum(c.table) - c.table
    wrong = 0
    for g0 in range(0, c.table.size, per):
        g1 = min(c.table.size, g0 + per)
        w0, w1 = int(first_word[g0]), int(first_word[g1 - 1] + c.table[g1 - 1])
        part = lockstep.Container(min(c.n, g1 * group) - g0 * group, c.table[g0:g1],
                                  c.words[w0:w1], c.lengths, faults)
        out, = lockstep.decode_lockstep([part], S, rows, device)
        wrong += int((out.to(torch.uint8) != ref[g0 * group : g0 * group + out.numel()]).sum())
    return wrong, faults


def check_all(items: list, conf: dict, device) -> list:
    """[(wrong bytes, faults)] of each (container, the input it was made
    from) under the configuration `conf`, one container at a time."""
    return [check(blob, data, conf, device) for blob, data in items]
