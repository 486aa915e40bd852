"""glz_tpu_torch's HuffWord kernel modules against glz_tpu on the CPU.

The same token ids and codebooks go through the JAX package (its Pallas
kernels in interpret mode: huffword._device_fns' gather_entries and
map_ranks, pallas_encode.prepare_entry_words and
encode_payload_from_entries, pallas_decode.decode_groups_dual with its
unpack) and through the port's plain PyTorch versions, which are what the
port's wrappers run for CPU tensors.  All data are integers, so every
comparison is exact (tolerance 0).

Cases: rows 8/16/32/64 at S = 64 with ragged token counts, pack2 and the
u32 (>64K vocabulary) path, a single-symbol and an empty dictionary,
nonword-first input (even_is_dict0 False).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from glz_tpu.core.codebook import build_codebook as tpu_build_codebook
from glz_tpu.models import huffword as tpu_hw
from glz_tpu.ops import pallas_decode as pd
from glz_tpu.ops import pallas_encode as pe

from glz_tpu_torch.core import container
from glz_tpu_torch.core.codebook import codebook_from_lengths
from glz_tpu_torch.models import huffword as port_hw
from glz_tpu_torch.models.canonical_byte import group_tables
from glz_tpu_torch.ops import _kernels
from glz_tpu_torch.ops import lockstep_decode as kd
from glz_tpu_torch.ops import lockstep_encode as ke
from glz_tpu_torch.ops import lut
from glz_tpu_torch.utils import tokenizer as tok
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
LANES = 128
S = 64

# name -> rows
CASES = {"rows8": 8, "rows16": 16, "rows32": 32, "rows64": 64,
         "nonword_first": 8, "single_symbol": 8, "one_token": 8, "big_vocab": 8}


def big_vocab_text(n_distinct: int = 70_000, n_repeats: int = 10_000,
                   seed: int = 0xB16) -> bytes:
    """Every one of 70K distinct words once, in random order, then random
    repeats: more words than a u16 id holds."""
    rng = np.random.default_rng(seed)
    words = [f"w{i:05d}".encode() for i in range(n_distinct)]
    order = np.concatenate([rng.permutation(n_distinct),
                            rng.choice(n_distinct, size=n_repeats)])
    return b" ".join(words[int(i)] for i in order)


def case_text(name: str, realtext: bytes) -> bytes:
    group = CASES[name] * LANES * S
    if name == "nonword_first":
        return b"  ...  " + realtext[:200_000]
    if name == "single_symbol":
        return b"word " * 20_000
    if name == "one_token":
        return b"a"
    if name == "big_vocab":
        return big_vocab_text()
    # about 1.1 groups of tokens (realtext has ~3.5 bytes per token); rows
    # 64 takes all of it, less than one group.  realtext starts with a
    # non-word, so a word goes first.
    return b"The " + realtext[: int(group * 1.5 * 2.6) - 777]


class Case:
    """One input through glz_tpu's HuffWord device functions once; the
    port's side is computed in the tests."""

    def __init__(self, name: str, realtext: bytes):
        self.name = name
        self.rows = CASES[name]
        self.G = self.rows * LANES
        data = case_text(name, realtext)
        _, _, wf, wv, nv, ids = tok.build_vocabs(data)
        self.T, self.word_first, self.ids = ids.size, wf, ids
        self.n_word, self.n_nonword = wv.n, nv.n
        self.small = max(wv.n, nv.n) <= 0xFFFF
        tpu_cbs = [tpu_build_codebook(v.counts, 26) for v in (wv, nv)]
        self.tpu_cbs = tpu_cbs
        self.cbs = [codebook_from_lengths(cb.lengths) for cb in tpu_cbs]
        ent_tbls = [cb.left_justified_codes() | cb.lengths.astype(np.uint32)
                    for cb in tpu_cbs]
        self.n0 = max(wv.n, 1)
        self.ent_tbl = np.concatenate([ent_tbls[0] if wv.n else np.zeros(1, np.uint32),
                                       ent_tbls[1] if nv.n else np.zeros(1, np.uint32)])
        group = self.G * S
        self.ids_pad = np.zeros(-(-max(self.T, 1) // group) * group,
                                np.uint16 if self.small else np.uint32)
        self.ids_pad[: self.T] = ids
        gather, map_ranks = tpu_hw._device_fns()

        ent = gather(jnp.asarray(self.ids_pad), jnp.asarray(self.ent_tbl), jnp.int32(0),
                     jnp.int32(self.n0), jnp.int32(self.T), even_is_dict0=bool(wf),
                     interpret=True)
        self.tpu_ent = np.asarray(ent).astype(np.uint32)
        _, ctot, gw = pe.prepare_entry_words(ent, S, self.rows)
        self.tpu_ctot, self.tpu_gw = np.asarray(ctot), np.asarray(gw)
        payload, padded = pe.encode_payload_from_entries(ent, S, interpret=True,
                                                         rows=self.rows)
        total = int(padded.sum())
        self.tpu_payload = np.asarray(payload)[:total].astype(np.uint32)
        self.tpu_padded = np.asarray(padded).astype(np.int64)

        cb_even, cb_odd = (tpu_cbs[0], tpu_cbs[1]) if wf else (tpu_cbs[1], tpu_cbs[0])
        self.cb_even, self.cb_odd = cb_even, cb_odd
        starts = np.cumsum(self.tpu_padded) - self.tpu_padded
        counts = np.clip(self.T - np.arange(padded.size) * group, 0, group)
        need = int(self.tpu_padded.max()) + self.G + 2 * LANES
        mgw = max(-(-need // (1 << 16)) * (1 << 16), 1 << 12)
        raw = pd.decode_groups_dual(
            jnp.asarray(self.tpu_payload), jnp.asarray(starts.astype(np.int32)),
            jnp.asarray(counts.astype(np.int32)),
            jnp.asarray(cb_even.first_code_left_justified()),
            jnp.asarray(cb_even.decode_offsets()),
            jnp.asarray(cb_odd.first_code_left_justified()),
            jnp.asarray(cb_odd.decode_offsets()),
            S, cb_even.min_len, cb_even.max_len, cb_odd.min_len, cb_odd.max_len,
            mgw, pack2=self.small, interpret=True, rows=self.rows)
        unpack = pd.unpack_ranks_packed if self.small else pd.unpack_ranks
        self.tpu_ranks = np.asarray(unpack(raw, S, self.rows)).astype(np.uint32)
        self.n_even = max(cb_even.symbols.size, 1)
        self.sym_cat = np.concatenate(
            [cb_even.symbols if cb_even.symbols.size else np.zeros(1, np.uint32),
             cb_odd.symbols if cb_odd.symbols.size else np.zeros(1, np.uint32)]
        ).astype(np.uint32)
        self.tpu_ids = np.asarray(map_ranks(raw, jnp.asarray(self.sym_cat),
                                            jnp.int32(self.n_even), S=S, small=self.small,
                                            rows=self.rows, interpret=True))

    # ---- the port's inputs
    def ids_tensor(self):
        return torch.from_numpy(self.ids_pad.view(np.int16 if self.small else np.int32).copy())

    def ent_tensor(self):
        return torch.from_numpy(self.tpu_ent.view(np.int32).copy())

    def port_tables(self):
        """(fc_lj [2, 34], offsets [2, 34]) from the port's codebooks."""
        even, odd = (self.cbs[0], self.cbs[1]) if self.word_first else (self.cbs[1], self.cbs[0])
        fc = np.stack([even.first_code_left_justified(), odd.first_code_left_justified()])
        off = np.stack([even.decode_offsets(), odd.decode_offsets()])
        return (torch.from_numpy(fc.view(np.int32).copy()),
                torch.from_numpy(off.view(np.int32).copy()),
                (even.min_len, odd.min_len), (even.max_len, odd.max_len))


@pytest.fixture(scope="module", params=list(CASES))
def case(request, realtext):
    return Case(request.param, realtext)


def test_case_shapes(case):
    """The cases cover what they are named for."""
    assert case.small == (case.name != "big_vocab")
    assert case.word_first == (case.name != "nonword_first")
    if case.name == "single_symbol":
        assert [(cb.min_len, cb.max_len) for cb in case.tpu_cbs] == [(1, 1), (1, 1)]
    if case.name == "one_token":
        assert case.T == 1 and case.n_nonword == 0
        assert (case.cb_odd.min_len, case.cb_odd.max_len) == (0, 0)
    else:
        assert case.T % (case.G * S)  # ragged


def test_gather_entries_matches_reference(case):
    tbl = torch.from_numpy(case.ent_tbl.view(np.int32).copy())
    ent = lut.gather_entries(case.ids_tensor(), tbl, 0, case.n0, case.T,
                             bool(case.word_first))
    assert ent.dtype == torch.int32
    assert np.array_equal(ent.numpy().view(np.uint32), case.tpu_ent)


def test_lane_totals_entries_matches_reference(case):
    ctot, gw = ke.lane_totals_entries(case.ent_tensor(), S, case.rows)
    assert np.array_equal(ctot.numpy(), case.tpu_ctot)
    assert np.array_equal(gw.numpy(), case.tpu_gw)


def test_encode_entries_matches_reference(case):
    """Payload words and padded per-group counts equal glz_tpu's."""
    payload, padded = ke.encode_payload_from_entries(case.ent_tensor(), S, case.rows)
    assert np.array_equal(padded, case.tpu_padded)
    assert np.array_equal(payload.numpy().view(np.uint32), case.tpu_payload)


def test_decode_dual_matches_reference(case):
    """Ranks of glz_tpu's dual kernel (after its unpack), 0 for inactive
    tokens, in file order."""
    starts, counts = group_tables(case.tpu_padded, case.T, case.G, S, CPU)
    fc, off, mins, maxs = case.port_tables()
    payload = torch.from_numpy(case.tpu_payload.view(np.int32).copy())
    ranks = kd.decode_groups_dual(payload, starts, counts, fc, off, S, mins, maxs,
                                  case.rows)
    assert np.array_equal(ranks.numpy().view(np.uint32), case.tpu_ranks)


def test_map_ranks_matches_reference(case):
    ranks = torch.from_numpy(case.tpu_ranks.view(np.int32).copy())
    tbl = torch.from_numpy(case.sym_cat.view(np.int32).copy())
    ids = lut.map_ranks(ranks, tbl, case.n_even, case.small)
    assert ids.dtype == (torch.int16 if case.small else torch.int32)
    got = ids.numpy().view(np.uint16 if case.small else np.uint32)
    assert np.array_equal(got, case.tpu_ids)
    assert np.array_equal(got[: case.T].astype(np.int64), case.ids)


def test_encode_lockstep_tokens_matches_reference(case):
    """The model's encode with the same ids and codebooks."""
    want = tpu_hw.encode_lockstep_tokens(case.ids, case.T, case.word_first, case.tpu_cbs,
                                         case.n_word, case.n_nonword, S, rows=case.rows)
    got = port_hw.encode_lockstep_tokens(case.ids, case.T, case.word_first, case.cbs,
                                         case.n_word, case.n_nonword, S, rows=case.rows,
                                         device="cpu")
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[0], want[0])


def test_gather_clips_like_take():
    """Indices past the table read its last entry, as jnp.take(mode="clip")
    does for the JAX package's tables above 64K entries; both parities and
    both index widths."""
    rng = np.random.default_rng(0x7A)
    tbl = rng.integers(0, 1 << 32, size=70_000, dtype=np.uint64).astype(np.uint32)
    for dtype, hi in ((np.uint16, 1 << 16), (np.uint32, 100_000)):
        idx = rng.integers(0, hi, size=4_097).astype(dtype)
        for n0, even_is_dict0 in ((0, True), (12_345, True), (12_345, False)):
            pos = np.arange(idx.size)
            add = np.where((pos % 2 == 0) == even_is_dict0, 0, n0)
            want = np.take(tbl, idx.astype(np.int64) + add, mode="clip")
            want[pos >= 4_000] = 0
            got = lut.gather_entries(
                torch.from_numpy(idx.view(np.int16 if dtype == np.uint16 else np.int32)),
                torch.from_numpy(tbl.view(np.int32)), 0, n0, 4_000, even_is_dict0)
            assert np.array_equal(got.numpy().view(np.uint32), want)


def test_cpu_wrappers_launch_nothing(realtext):
    """CPU tensors take the plain versions and leave the launch counts."""
    _kernels.reset_launch_counts()
    conf = port_hw.cfg.GlzConfig(stream_symbols=S, layout="lockstep")
    data = realtext[:50_000]
    blob = port_hw.compress_huffword_lockstep(data, conf, device="cpu")
    assert port_hw.decompress_huffword(container.read_container(blob), device="cpu") == data
    assert not any(_kernels.launch_counts().values())


@pytest.mark.parametrize("bad", ["dtype", "rows", "S", "lens", "device"])
def test_wrappers_reject_bad_inputs(bad):
    n = 8 * LANES * S
    ent = torch.zeros(n, dtype=torch.int32)
    kw = dict(S=S, rows=8)
    if bad == "dtype":
        ent = ent.to(torch.int64)
    elif bad == "rows":
        kw["rows"] = 12
    elif bad == "S":
        kw["S"] = 96
    elif bad == "device":
        ent = ent.to("meta")
    if bad == "lens":
        starts, counts = torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int32)
        fc = torch.zeros((2, 34), dtype=torch.int32)
        for mins, maxs in (((0, 1), (3, 5)), ((2, 1), (1, 1)), ((1, 1), (33, 1))):
            with pytest.raises(ValueError, match="code length range"):
                kd.decode_groups_dual(ent, starts, counts, fc, fc, S, mins, maxs, 8)
        return
    with pytest.raises((TypeError, ValueError)):
        ke.lane_totals_entries(ent, **kw)
    with pytest.raises((TypeError, ValueError)):
        lut.gather_entries(ent.to(torch.float32) if bad != "device" else ent,
                           torch.zeros(4, dtype=torch.int32), 0, 1, 5, True)
