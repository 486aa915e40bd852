"""glz_tpu_torch's lockstep kernel modules against glz_tpu on the CPU.

The same inputs go through the JAX package (its Pallas kernels in interpret
mode, and its numpy schedule oracles) and through the port's plain PyTorch
versions, which are what the port's wrappers run for CPU tensors.  All data
are integers, so every comparison is exact (tolerance 0).

Cases: rows 8/16/32/64 at S=64 with ragged valid counts, a depth-26
codebook, and identical lanes (dense refill steps).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from glz_tpu.core import lockstep as tpu_lockstep
from glz_tpu.core.codebook import build_codebook as tpu_build_codebook
from glz_tpu.core.codebook import canonical_codebook as tpu_canonical_codebook
from glz_tpu.ops import pallas_decode as pd
from glz_tpu.ops import pallas_encode as pe

import chip_smoke
from glz_tpu_torch.core import lockstep as port_lockstep
from glz_tpu_torch.core.codebook import codebook_from_lengths
from glz_tpu_torch.models.canonical_byte import decode_tables, entry_table, group_tables
from glz_tpu_torch.ops import _kernels
from glz_tpu_torch.ops import lockstep_decode as kd
from glz_tpu_torch.ops import lockstep_encode as ke
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
LANES = 128
S = 64

# name -> (rows, recipe); text cases cut the text fixture raggedly
CASES = {
    "rows8": 8, "rows16": 16, "rows32": 32, "rows64": 64,
    "deep26": 8, "dense": 32,
}


def _case_input(name, text):
    """(symbols u8, n_valid, rows, code lengths)."""
    rows = CASES[name]
    group = rows * LANES * S
    if name == "deep26":
        arr, cb = chip_smoke.deep_case(2 * group - 4321)
        return arr, arr.size, rows, cb.lengths
    if name == "dense":
        arr, cb = chip_smoke.dense_case(S, rows)
        return arr, arr.size, rows, cb.lengths
    n = {8: 2 * group - 999, 16: 2 * group - 999,
         32: group + 12345, 64: group - 777}[rows]
    arr = np.frombuffer((text * 2)[:n], dtype=np.uint8)
    cb = tpu_build_codebook(np.bincount(arr, minlength=256).astype(np.int64), 26)
    return arr, n, rows, cb.lengths


class Case:
    """One input run through glz_tpu once; the port's side is computed in
    the tests."""

    def __init__(self, name, text):
        arr, n, rows, lengths = _case_input(name, text)
        self.rows, self.n = rows, n
        self.G = rows * LANES
        group = self.G * S
        self.sym_np = np.zeros(-(-n // group) * group, np.uint8)
        self.sym_np[:n] = arr[:n]
        self.tpu_cb = tpu_canonical_codebook(lengths)
        self.cb = codebook_from_lengths(lengths)
        assert self.cb.max_len <= 26
        ent = jnp.asarray(self.tpu_cb.left_justified_codes()
                          | self.tpu_cb.lengths.astype(np.uint32))
        sym = jnp.asarray(self.sym_np)
        ctot, gw = pe.lane_totals(pe.bytes_stepmajor(sym, S, rows), ent,
                                  jnp.int32(n), S, pe.pick_chunk(S, rows),
                                  interpret=True, rows=rows)
        self.tpu_ctot, self.tpu_gw = np.asarray(ctot), np.asarray(gw)
        payload, padded = pe.encode_payload_from_symbols(
            sym, jnp.int32(n), ent, S, interpret=True, rows=rows)
        total = int(padded.sum())
        self.tpu_payload = np.asarray(payload)[:total].astype(np.uint32)
        self.tpu_padded = np.asarray(padded).astype(np.int64)
        starts = np.cumsum(self.tpu_padded) - self.tpu_padded
        counts = np.clip(n - np.arange(padded.size) * group, 0, group)
        mgw = max(-(-(int(padded.max()) + self.G + 256) // (1 << 16)) * (1 << 16), 1 << 12)
        symtab = np.zeros(256, np.uint32)
        symtab[: self.tpu_cb.symbols.size] = self.tpu_cb.symbols
        out = pd.decode_groups(
            jnp.asarray(self.tpu_payload), jnp.asarray(starts.astype(np.int32)),
            jnp.asarray(counts.astype(np.int32)),
            jnp.asarray(self.tpu_cb.first_code_left_justified()),
            jnp.asarray(self.tpu_cb.decode_offsets()), jnp.asarray(symtab),
            S, self.tpu_cb.min_len, self.tpu_cb.max_len, mgw, interpret=True,
            rows=rows)
        self.tpu_decoded = np.asarray(pd.unpack_symbols(out, S, rows))

    # ---- the port's inputs
    def sym(self):
        return torch.from_numpy(self.sym_np.copy())

    def tbl(self):
        return entry_table(self.cb, CPU)

    def lens_lj(self, g):
        """Group g's [G, S] code lengths and left-justified codes (0 past
        n_valid), the inputs of the numpy schedule oracles."""
        group = self.G * S
        syms = self.sym_np[g * group:(g + 1) * group]
        valid = np.arange(g * group, (g + 1) * group) < self.n
        lens = np.where(valid, self.cb.lengths[syms], 0).astype(np.int64)
        lj = np.where(valid, self.cb.left_justified_codes()[syms], 0).astype(np.uint32)
        return lens.reshape(self.G, S), lj.reshape(self.G, S)


@pytest.fixture(scope="module", params=list(CASES))
def case(request, text_1mb):
    return Case(request.param, text_1mb)


def test_refill_masks_match_reference(rng):
    lens = rng.integers(0, 27, size=(256, 40)).astype(np.int64)
    lens[3] = 0
    lens[7, 20:] = 0
    assert np.array_equal(port_lockstep.refill_masks(lens),
                          tpu_lockstep.refill_masks(lens))
    assert (port_lockstep.LANES, port_lockstep.ROWS) == (tpu_lockstep.LANES, tpu_lockstep.ROWS)
    assert ke.MAX_FUSED_LEN == pe.MAX_FUSED_LEN


def test_lane_totals_matches_reference(case):
    ctot, gw = ke.lane_totals(case.sym(), case.tbl(), case.n, S, case.rows)
    assert np.array_equal(ctot.numpy(), case.tpu_ctot)
    assert np.array_equal(gw.numpy(), case.tpu_gw)


def test_encode_matches_reference(case):
    """Payload words and padded per-group counts equal glz_tpu's."""
    payload, padded = ke.encode_payload_from_symbols(case.sym(), case.n, case.tbl(),
                                                     S, case.rows)
    assert np.array_equal(padded, case.tpu_padded)
    assert np.array_equal(payload.numpy().view(np.uint32), case.tpu_payload)


def test_encode_matches_host_schedule(case):
    """Each group's segment is reorder_payload_reverse_host's output, then
    zeros to the next 128-word boundary."""
    payload, padded = ke.encode_payload_from_symbols(case.sym(), case.n, case.tbl(),
                                                     S, case.rows)
    words = payload.numpy().view(np.uint32)
    start = 0
    for g, count in enumerate(padded):
        want, n_words = tpu_lockstep.reorder_payload_reverse_host(*case.lens_lj(g))
        seg = words[start:start + int(count)]
        assert int(count) == -(-int(n_words) // LANES) * LANES
        assert np.array_equal(seg[:int(n_words)], want)
        assert not seg[int(n_words):].any()
        start += int(count)


def test_decode_matches_reference(case):
    """decode_groups on the reference payload: the bytes of glz_tpu's
    decode kernel, and decode_group_host's full output (0 past each lane's
    count) group by group."""
    starts, counts = group_tables(case.tpu_padded, case.n, case.G, S, CPU)
    payload = torch.from_numpy(case.tpu_payload.view(np.int32).copy())
    out = kd.decode_groups(payload, starts, counts, *decode_tables(case.cb, CPU), S,
                           case.cb.min_len, case.cb.max_len, case.rows).numpy()
    assert np.array_equal(out[:case.n], case.tpu_decoded[:case.n])
    assert np.array_equal(out[:case.n], case.sym_np[:case.n])
    symtab = case.tpu_cb.symbols.astype(np.uint32)
    for g, count in enumerate(counts.numpy()):
        lane_counts = np.clip(int(count) - np.arange(case.G) * S, 0, S)
        s0 = int(starts[g])
        want = tpu_lockstep.decode_group_host(
            case.tpu_payload[s0:], case.tpu_padded[g], lane_counts, S,
            case.tpu_cb.first_code_left_justified(), case.tpu_cb.decode_offsets(),
            symtab, case.tpu_cb.min_len, case.tpu_cb.max_len)
        group = case.G * S
        assert np.array_equal(out[g * group:(g + 1) * group], want.T.reshape(-1))


def test_cpu_wrappers_launch_nothing():
    """CPU tensors take the plain versions and leave the launch counts."""
    _kernels.reset_launch_counts()
    arr = chip_smoke.make_corpus(8 * LANES * S)
    cb = codebook_from_lengths(tpu_build_codebook(np.bincount(arr, minlength=256), 26).lengths)
    payload, padded = ke.encode_payload_from_symbols(torch.from_numpy(arr), arr.size,
                                                     entry_table(cb, CPU), S, 8)
    starts, counts = group_tables(padded, arr.size, 8 * LANES, S, CPU)
    out = kd.decode_groups(payload, starts, counts, *decode_tables(cb, CPU), S,
                           cb.min_len, cb.max_len, 8)
    assert np.array_equal(out.numpy(), arr)
    counts = _kernels.launch_counts()
    assert {"lane_totals", "encode_groups", "decode_groups"} <= set(counts)
    assert not any(counts.values()), counts


@pytest.mark.parametrize("bad", ["dtype", "shape", "rows", "S", "device"])
def test_wrappers_reject_bad_inputs(bad):
    sym = torch.zeros(8 * LANES * S, dtype=torch.uint8)
    tbl = torch.zeros(256, dtype=torch.int32)
    kwargs = dict(S=S, rows=8)
    if bad == "dtype":
        sym = sym.to(torch.int32)
    elif bad == "shape":
        sym = sym[:-1]
    elif bad == "rows":
        kwargs["rows"] = 12
    elif bad == "S":
        kwargs["S"] = 96
    else:
        sym, tbl = sym.to("meta"), tbl.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ke.lane_totals(sym, tbl, sym.numel(), **kwargs)
