#!/usr/bin/env python3
"""Drive glz_tpu_torch's paths on one CUDA card and check its kernels.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Four paths: the byte-mode lockstep codec (THROUGHPUT), the HuffWord
lockstep codec, and the bitstream (layout 0) codec in byte and HuffWord
mode (DEFAULT), the byte one through glz_tpu's default front door
(backend "host") and the device backend.  Phases (each prints one line or
more; any failure exits non-zero before the last):
  1. environment: torch, the card, nvidia-smi, nvcc;
  2. build: compile csrc/lockstep.cu and csrc/bitstream.cu (which share
     csrc/decode_table.cuh) for sm_90a (one nvcc each, in parallel), with
     ptxas register/spill figures per kernel;
  3. kernels against their plain PyTorch versions on the card, bit-exact
     (integer data, tolerance 0):
     - byte path: K1 lane_totals, K2 encode_groups and K3 decode_groups on
       rows 8/16/32/64 at S 64/512 and rows 8 at S 8192, each with a ragged
       n_valid, a depth-26 codebook, and identical lanes (dense refill
       steps);
     - HuffWord path: K6 lut_gather at both call sites (gather_entries,
       map_ranks), the entry-word lane totals, K4 encode_entries and K5
       decode_dual (one block a group at rows 8 and 16, a cluster of rows/8
       blocks at rows 32 and 64) on
       rows 8/16/32 at S 64/512, rows 64 at S 64 and 256 and rows 8 at S
       1024 (ragged token counts), nonword-first text, single-symbol
       dictionaries, one token (an empty dictionary) and a >64K-word
       vocabulary (u32 ids); each case also round-trips its tokens; and K5
       alone on random words at S 66 (rows 8) and 130 (rows 64);
  3c. bitstream kernels: K7 lookup_lj_lens, the pack (pack_scan, pack_tiles,
     from bit 0 and from bit 13, and the whole step) and decode_streams on
     byte cases (ragged n_valid with garbage past it, S 1000 (not a power
     of two), codes of 27-32 bits, one symbol, a one-code codebook, three
     DEFAULT-sized streams, 64 MiB of uniform bytes (all codes 8 bits; its
     decode time is printed), two dispatches of one stream each, word-
     aligned (the device container) or the second packed from the first's
     last bit (the host container)), and K6 on the lj and length tables,
     the pack and decode_streams_dual on HuffWord cases (S 16384, odd S,
     nonword-first text, one token (an empty dictionary), a >64K-word
     vocabulary, codes of 27-32 bits, 256 equiprobable 8-bit words with
     1-3-bit separators (its decode time and rounds are printed)); each
     case also round-trips;
  4. byte main path: compress + decompress of a 512 MiB corpus under
     THROUGHPUT with checksum, launch counts read just after;
  4b. HuffWord main path: compress + decompress of 100 MiB of English-like
     text (20,000 Zipf words) at S 512, rows 32, with checksum, launch
     counts read just after, and the host steps re-run alone;
  4c. byte bitstream path: the same 512 MiB under DEFAULT with checksum
     (2,048 streams of 2^18 symbols in four dispatches of 2^27) through
     backend "host" (glz_tpu's default container) and then "device",
     launch counts read just after each, and the host steps re-run alone;
  4d. HuffWord bitstream path: phase 4b's text under DEFAULT with checksum
     (streams of 16,384 tokens), launch counts read just after;
  5. kernel times at each main path's shapes (CUDA events), each kernel
     held against its plain version on the same inputs (the stream decodes
     also against the input); the whole pack step against the first
     port's (torch.cumsum and pack_lj_kernel, tools/pack_phases.py) on the
     same codes; the decodes
     again at each swept decode table size (and the stream decodes'
     subsequence length), each against the input or the plain version, and
     the share of the main corpora's symbols (tokens) the tables resolve in
     one probe; the registers and spills of the pack's and K5's kernels;
  6. pinned digests: the containers of tests/fixtures/realtext.txt[:1 MiB]
     under ten configurations must have the SHA-256 that the JAX
     reference writes (pinned by tests/test_torch_canonical_byte.py,
     tests/test_torch_huffword.py, tests/test_torch_bitstream.py and
     tests/test_torch_front_door.py).
Then the kernels JSON line, the nvidia-smi line and the result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

import glz_tpu_torch as gt
from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import bitio, container
from glz_tpu_torch.core.codebook import (build_codebook, codebook_from_lengths,
                                         histogram_bytes, sampled_histogram)
from glz_tpu_torch.core.lockstep import LANES
from glz_tpu_torch.models import huffword as hw_model
from glz_tpu_torch.models import canonical_byte as cb_model
from glz_tpu_torch.models.canonical_byte import (_i32_tensor, _round_up, decode_tables,
                                                 entry_table, group_tables)
from glz_tpu_torch.ops import _kernels
from glz_tpu_torch.ops import decode as bd
from glz_tpu_torch.ops import decode_table
from glz_tpu_torch.ops import encode as be
from glz_tpu_torch.ops import lockstep_decode as kd
from glz_tpu_torch.ops import lockstep_encode as ke
from glz_tpu_torch.ops import lut
from glz_tpu_torch.utils import tokenizer as tok

ROOT = pathlib.Path(__file__).resolve().parent
MAIN_BYTES = 512 << 20
HUFFWORD_BYTES = 100 << 20
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12    # H100 SXM 32-bit rate outside the tensor cores
# 32-bit integer operations the algorithms need per valid symbol (counted
# from the plain versions: table lookup, masks, shifts, compares, selects)
OPS_PER_SYMBOL = {"lane_totals": 2, "encode_groups": 16, "lane_totals_entries": 2,
                  "encode_entries": 15, "lut_gather": 5, "lookup_lj_lens": 4,
                  "pack_scan": 1, "pack_tiles": 10}
# A decode's operations per symbol: the window, one table probe, the
# advance and the output.  The canonical scan's levels are one
# implementation's work, not the function's (a table resolves ~99% of codes
# in one probe), so no decode's bound counts them.
DECODE_OPS_BASE = 12
# The sweep of phase 5: the decode table's index bits (both byte decodes)
# and the stream decode's subsequence length in bits.
TABLE_BITS_SWEEP = (10, 11, 12)
SUBSEQ_BITS_SWEEP = (1024, 2048, 4096)
# The dual stream decode's sweep: its word table's bits and its subsequence
# length in bits.
DUAL_TABLE_BITS_SWEEP = (11, 12, 13, 14)
DUAL_SUBSEQ_BITS_SWEEP = (256, 384, 512, 768)

# SHA-256 of the containers of realtext.txt[:1 MiB] written by glz_tpu.
PINNED = {
    "throughput": "55f3d4a23d26dda8b1117a8d6016718ee20181ab3da2ee7f85ff4b682dd44422",
    "rows8_s256": "57892cd61186c775eb338aa2c212ed076db4727386beef3e0604f5642b5b1e24",
}
HUFFWORD_PINNED = {
    "hw_s512_r32": "5fc26488cd8b36f480b7535b1c810f83a545512d26736f25ed2288ff98d0c7f4",
    "hw_s64_r8": "8ae343d0d7b51e4f6b15c8e68c07d54c63a92a0ea7676620cada47ed5e9b3573",
    "hw_ratio": "9a3d1efc739b17791d7010cff6be7c8a473e1243723b4c0574c28b42bd680116",
}
BITSTREAM_PINNED = {
    "byte_default": "1e9bfdda8cebb3c622568ffb1595e42122acafd0354078bc3ab7a2dd445f1fc8",
    "byte_ratio": "c5e2edb717109d38f77dfe1aa0da773a920b8074c3061e4299f5ca5524e2fcf3",
    "hw_default": "718655c9744a36624676ef06248d30d69512a164236078559c35198cda45870a",
    "byte_default_host": "6e3eff1670f7dc5a595737ca1c8e8e91248f2c9d5c88636bd401327a36f59065",
    "byte_ratio_host": "5a1f850548aeb05d8b643941d299de2e7c95e25e9abe540f97da1699abdf86b8",
}

REPLACES = {
    "lane_totals": "glz_tpu/ops/pallas_encode.py:449",
    "encode_groups": "glz_tpu/ops/pallas_encode.py:96",
    "decode_groups": "glz_tpu/ops/pallas_decode.py:205",
    "lane_totals_entries": "glz_tpu/ops/pallas_encode.py:591",
    "encode_entries": "glz_tpu/ops/pallas_encode.py:96",
    "decode_dual": "glz_tpu/ops/pallas_decode.py:471",
    "lut_gather": "glz_tpu/ops/pallas_lut.py:47",
    "lookup_lj_lens": "glz_tpu/ops/pallas_lut.py:32",
    "pack_scan": "glz_tpu/ops/encode.py:75",
    "pack_tiles": "glz_tpu/ops/encode.py:75",
    "decode_streams": "glz_tpu/ops/decode.py:37",
    "decode_streams_dual": "glz_tpu/models/huffword.py:502",
}
BYTE_KERNELS = ("lane_totals", "encode_groups", "decode_groups")
HUFFWORD_KERNELS = ("lut_gather", "lane_totals_entries", "encode_entries", "decode_dual")
BITSTREAM_KERNELS = ("lookup_lj_lens", "pack_scan", "pack_tiles", "decode_streams")
HUFFWORD_BITSTREAM_KERNELS = ("lut_gather", "pack_scan", "pack_tiles", "decode_streams_dual")


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def pinned_configs() -> dict[str, cfg.GlzConfig]:
    base = dataclasses.replace(cfg.THROUGHPUT, checksum=True)
    return {"throughput": base,
            "rows8_s256": dataclasses.replace(base, group_rows=8, stream_symbols=256)}


def huffword_conf(S: int = 512, rows: int = 32, base: cfg.GlzConfig | None = None
                  ) -> cfg.GlzConfig:
    """A HuffWord lockstep configuration with checksum; the default is the
    HuffWord benchmark's (S 512, rows 32)."""
    if base is not None:
        return dataclasses.replace(base, layout=cfg.LAYOUT_LOCKSTEP, checksum=True)
    return cfg.GlzConfig(stream_symbols=S, layout=cfg.LAYOUT_LOCKSTEP, group_rows=rows,
                         checksum=True)


def huffword_pinned_configs() -> dict[str, cfg.GlzConfig]:
    """The main path's configuration, a narrow one, and RATIO's stream size
    (a byte preset: HuffWord reads it as 512)."""
    return {"hw_s512_r32": huffword_conf(),
            "hw_s64_r8": huffword_conf(64, 8),
            "hw_ratio": huffword_conf(base=cfg.RATIO)}


def bitstream_pinned_configs() -> dict[str, tuple[cfg.GlzConfig, int, str]]:
    """(configuration, mode, backend) of the bitstream digests, each with
    checksum: byte DEFAULT and RATIO under backend "device" (the container
    of glz_tpu's compress_bytes_device) and "host" (glz_tpu.compress's
    default, compress_bytes_host's container), and HuffWord DEFAULT."""
    default = dataclasses.replace(cfg.DEFAULT, checksum=True)
    ratio = dataclasses.replace(cfg.RATIO, checksum=True)
    return {"byte_default": (default, cfg.MODE_BYTE, "device"),
            "byte_ratio": (ratio, cfg.MODE_BYTE, "device"),
            "hw_default": (default, cfg.MODE_HUFFWORD, "host"),
            "byte_default_host": (default, cfg.MODE_BYTE, "host"),
            "byte_ratio_host": (ratio, cfg.MODE_BYTE, "host")}


def make_word_corpus(n_bytes: int, seed: int = 0x3AD) -> bytes:
    """English-like text: Zipf(1.1) draws from 20,000 words, each followed
    by one of six separators (the repository's HuffWord benchmark recipe,
    bench_huffword.make_corpus)."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i:x}" for i in range(20000)]
    probs = (1.0 / np.arange(1, len(vocab) + 1)) ** 1.1
    probs /= probs.sum()
    seps = np.array([" ", " ", " ", ". ", ", ", "\n"], dtype=object)
    parts = []
    size = 0
    chunk = 1 << 16
    while size < n_bytes:
        ws = rng.choice(len(vocab), size=chunk, p=probs)
        ss = rng.choice(len(seps), size=chunk)
        s = "".join(vocab[w] + seps[k] for w, k in zip(ws, ss))
        parts.append(s.encode())
        size += len(parts[-1])
    return b"".join(parts)[:n_bytes]


def big_vocab_text(n_distinct: int = 70_000, n_repeats: int = 10_000,
                   seed: int = 0xB16) -> bytes:
    """Every one of 70K distinct words once, in random order, then random
    repeats: more words than a u16 id holds (the u32 id and rank path)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i:05d}".encode() for i in range(n_distinct)]
    order = np.concatenate([rng.permutation(n_distinct),
                            rng.choice(n_distinct, size=n_repeats)])
    return b" ".join(words[int(i)] for i in order)


def make_corpus(n_bytes: int, seed: int = 0xE58) -> np.ndarray:
    """Non-repeating corpus at ~4.4 bits/byte order-0 entropy: the AND of
    three uniform byte draws (the repository benchmark's recipe)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, size=n_bytes, dtype=np.uint8)
    out &= rng.integers(0, 256, size=n_bytes, dtype=np.uint8)
    out &= rng.integers(0, 256, size=n_bytes, dtype=np.uint8)
    return out


def deep_case(n: int, seed: int = 0xDEEB, limit: int = ke.MAX_FUSED_LEN):
    """Geometric corpus (the benchmark's deep-code recipe) and a codebook
    capped at `limit` bits from the corpus's own law, frequencies 2^(40-i),
    carried past what a sample of this size sees (the unlimited tree is 40
    deep), then a sprinkle of the deepest symbols so the payload carries the
    deepest codes.  Returns (symbols, codebook)."""
    rng = np.random.default_rng(seed)
    arr = (np.minimum(rng.geometric(0.5, size=n), 64) - 1).astype(np.uint8)
    freqs = np.left_shift(1, np.maximum(40 - np.arange(256), 0)).astype(np.int64)
    cb = build_codebook(freqs, limit)
    deepest = np.flatnonzero(cb.lengths == limit)
    require(cb.max_len == limit and deepest.size, f"deep codebook max_len {cb.max_len}")
    pos = rng.choice(n, size=max(1, n // 997), replace=False)
    arr[pos] = rng.choice(deepest, size=pos.size).astype(np.uint8)
    return arr, cb


def dense_case(S: int, rows: int, seed: int = 0x61F2):
    """Every lane identical: word-boundary crossings synchronize, so single
    steps refill all rows*128 lanes."""
    rng = np.random.default_rng(seed)
    lane = rng.choice(256, size=S, p=rng.dirichlet(np.ones(256) * 0.2)).astype(np.uint8)
    arr = np.tile(lane, rows * LANES)
    return arr, build_codebook(histogram_bytes(arr), ke.MAX_FUSED_LEN)


# name -> (S, rows); text cases are two groups with a ragged second one
CASES = {f"text_r{r}_s{s}": (s, r) for r in (8, 16, 32, 64) for s in (64, 512)}
CASES["text_r8_s8192"] = (8192, 8)  # the largest S: 2^13-step sweeps
CASES["deep26_r16_s512"] = (512, 16)
CASES["dense_r32_s64"] = (64, 32)
# rows 64: steps where every lane refills need 8,192 words, more than K3's
# refill ring holds ahead, so some are read from the payload directly
CASES["dense_r64_s64"] = (64, 64)


def case_data(name: str):
    """(symbols u8, n_valid, S, rows, codebook) of a kernel case."""
    S, rows = CASES[name]
    group = rows * LANES * S
    if name.startswith("deep26"):
        arr, cb = deep_case(group + 777)
        return arr, arr.size, S, rows, cb
    if name.startswith("dense"):
        arr, cb = dense_case(S, rows)
        return arr, arr.size, S, rows, cb
    n = group + 999 if S == 8192 else 2 * group - 12345
    arr = make_corpus(n, seed=S * 100 + rows)
    return arr, arr.size, S, rows, build_codebook(histogram_bytes(arr), ke.MAX_FUSED_LEN)


class KernelInputs:
    """Everything the three kernels take for one input, on one device."""

    def __init__(self, arr: np.ndarray, n_valid: int, S: int, rows: int, cb,
                 dev: torch.device):
        self.S, self.rows, self.n_valid, self.cb = S, rows, n_valid, cb
        self.G = rows * LANES
        group = self.G * S
        host = np.zeros(-(-n_valid // group) * group, np.uint8)
        host[:n_valid] = arr[:n_valid]
        self.arr = host
        self.sym = torch.from_numpy(host).to(dev)
        self.tbl = entry_table(cb, dev)
        ctot, gw = ke.lane_totals_ref(self.sym, self.tbl, n_valid, S, rows)
        self.ctot, self.gw = ctot, gw
        self.padded, grow = ke.group_layout(gw.cpu().numpy())
        self.grow = torch.from_numpy(grow.astype(np.int32)).to(dev)
        self.n_words = int(self.padded.sum())
        self.tables = decode_tables(cb, dev)
        self.starts, self.counts = group_tables(self.padded, n_valid, self.G, S, dev)

    def k1(self, fn):
        return fn(self.sym, self.tbl, self.n_valid, self.S, self.rows)

    def k2(self, fn):
        return fn(self.sym, self.tbl, self.n_valid, self.ctot, self.gw, self.grow,
                  self.S, self.rows, self.n_words)

    def k3(self, fn, payload):
        return fn(payload, self.starts, self.counts, *self.tables, self.S,
                  self.cb.min_len, self.cb.max_len, self.rows)


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over the outputs (integers)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise RuntimeError(f"shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def check_case(name: str, dev: torch.device) -> None:
    """K1, K2, K3 on the card against their plain versions for one case,
    bit-exact, plus the decode of the encoded payload against the input."""
    inp = KernelInputs(*case_data(name), dev)
    require(max_abs_err(inp.k1(ke.lane_totals), (inp.ctot, inp.gw)) == 0, f"{name}: K1")
    pay, cend = inp.k2(ke.encode_groups)
    pay_ref, cend_ref = inp.k2(ke.encode_groups_ref)
    require(max_abs_err((pay, cend), (pay_ref, cend_ref)) == 0, f"{name}: K2")
    require(not bool(cend.any()), f"{name}: encode cursor did not end at 0")
    out = inp.k3(kd.decode_groups, pay_ref)
    require(max_abs_err(out, inp.k3(kd.decode_groups_ref, pay_ref)) == 0, f"{name}: K3")
    require(np.array_equal(out[: inp.n_valid].cpu().numpy(), inp.arr[: inp.n_valid]),
            f"{name}: round trip")


# name -> (S, rows); word-corpus cases hold about 1.5 groups of tokens
HUFFWORD_CASES = {f"hw_r{r}_s{s}": (s, r) for r in (8, 16, 32) for s in (64, 512)}
HUFFWORD_CASES["hw_r64_s64"] = (64, 64)
HUFFWORD_CASES["hw_nonword_r8_s64"] = (64, 8)
HUFFWORD_CASES["hw_single_r16_s64"] = (64, 16)
HUFFWORD_CASES["hw_one_token_r8_s64"] = (64, 8)
HUFFWORD_CASES["hw_bigvocab_r8_s64"] = (64, 8)
# K5's extremes: rows 8 (one block a group) at the largest HuffWord S, and
# rows 64 (a cluster of eight blocks a group)
HUFFWORD_CASES["hw_r8_s1024"] = (1024, 8)
HUFFWORD_CASES["hw_r64_s256"] = (256, 64)
# K5 alone on random payload words at even S that is not a power of two
# (lanes not 16-byte aligned when S % 4 == 2): (S, rows)
K5_RANDOM_CASES = {"k5_random_r8_s66": (66, 8), "k5_random_r64_s130": (130, 64)}


def huffword_case_text(name: str) -> bytes:
    S, rows = HUFFWORD_CASES[name]
    if "nonword" in name:
        return b"  ...  " + make_word_corpus(300_000, seed=0x3AE)
    if "single" in name:
        return b"word " * 20_000
    if "one_token" in name:
        return b"a"
    if "bigvocab" in name:
        return big_vocab_text()
    # the word corpus has ~2.14 bytes per token
    return make_word_corpus(int(rows * LANES * S * 1.5 * 2.14), seed=S * 100 + rows)


class HuffwordInputs:
    """Everything the HuffWord kernels take for one text, on one device.
    The plain versions make each kernel's input from the one before, so
    every kernel sees the inputs the path gives it."""

    def __init__(self, data: bytes, S: int, rows: int, dev: torch.device, vocabs=None):
        self.S, self.rows = S, rows
        self.G = rows * LANES
        _, _, wf, wv, nv, ids = vocabs if vocabs is not None else tok.build_vocabs(data)
        self.T, self.word_first, self.ids = ids.size, bool(wf), ids
        self.small = max(wv.n, nv.n) <= 0xFFFF
        cbs = [build_codebook(v.counts, ke.MAX_FUSED_LEN) for v in (wv, nv)]
        ents = [cb.left_justified_codes() | cb.lengths.astype(np.uint32) for cb in cbs]
        self.n0 = max(wv.n, 1)
        tbl = np.concatenate([ents[0] if wv.n else np.zeros(1, np.uint32),
                              ents[1] if nv.n else np.zeros(1, np.uint32)])
        group = self.G * S
        ids_pad = np.zeros(-(-max(self.T, 1) // group) * group,
                           np.uint16 if self.small else np.uint32)
        ids_pad[: self.T] = ids
        self.ids_d = torch.from_numpy(ids_pad.view(np.int16 if self.small else np.int32)).to(dev)
        self.ent_tbl = torch.from_numpy(tbl.view(np.int32)).to(dev)
        self.ent = self.gather(lut.gather_entries_ref)
        self.ctot, self.gw = ke.lane_totals_entries_ref(self.ent, S, rows)
        self.padded, grow = ke.group_layout(self.gw.cpu().numpy())
        self.grow = torch.from_numpy(grow.astype(np.int32)).to(dev)
        self.n_words = int(self.padded.sum())
        even, odd = (cbs[0], cbs[1]) if wf else (cbs[1], cbs[0])
        self.lens = ((even.min_len, odd.min_len), (even.max_len, odd.max_len))
        self.scan_levels = (even.max_len - even.min_len, odd.max_len - odd.min_len)
        self.fc, self.off = hw_model._dual_tables(even, odd, dev)
        self.starts, self.counts = group_tables(self.padded, self.T, self.G, S, dev)
        self.n_even = max(even.symbols.size, 1)
        sym = np.concatenate([even.symbols if even.symbols.size else np.zeros(1, np.uint32),
                              odd.symbols if odd.symbols.size else np.zeros(1, np.uint32)])
        self.sym_tbl = torch.from_numpy(sym.astype(np.uint32).view(np.int32)).to(dev)
        self.payload = self.encode(ke.encode_entries_ref)[0]
        self.ranks = self.decode(kd.decode_groups_dual_ref)

    def gather(self, fn):
        return fn(self.ids_d, self.ent_tbl, 0, self.n0, self.T, self.word_first)

    def totals(self, fn):
        return fn(self.ent, self.S, self.rows)

    def encode(self, fn):
        return fn(self.ent, self.ctot, self.gw, self.grow, self.S, self.rows, self.n_words)

    def decode(self, fn):
        return fn(self.payload, self.starts, self.counts, self.fc, self.off, self.S,
                  *self.lens, self.rows)

    def map(self, fn):
        return fn(self.ranks, self.sym_tbl, self.n_even, self.small)


def check_huffword_case(name: str, dev: torch.device) -> None:
    """The HuffWord kernels on the card against their plain versions for
    one case, bit-exact, plus the token round trip."""
    S, rows = HUFFWORD_CASES[name]
    inp = HuffwordInputs(huffword_case_text(name), S, rows, dev)
    require(max_abs_err(inp.gather(lut.gather_entries), inp.ent) == 0, f"{name}: K6 gather")
    require(max_abs_err(inp.totals(ke.lane_totals_entries), (inp.ctot, inp.gw)) == 0,
            f"{name}: entry totals")
    pay, cend = inp.encode(ke.encode_entries)
    require(max_abs_err((pay, cend), (inp.payload, torch.zeros_like(cend))) == 0, f"{name}: K4")
    require(max_abs_err(inp.decode(kd.decode_groups_dual), inp.ranks) == 0, f"{name}: K5")
    ids = inp.map(lut.map_ranks)
    require(max_abs_err(ids, inp.map(lut.map_ranks_ref)) == 0, f"{name}: K6 map")
    got = ids[: inp.T].cpu().numpy().view(np.uint16 if inp.small else np.uint32)
    require(np.array_equal(got.astype(np.int64), inp.ids), f"{name}: token round trip")


def check_k5_random(name: str, dev: torch.device) -> None:
    """K5 against its plain version on random payload words (the decode is
    a function of any words): the word corpus's dual codebooks, two groups,
    the second ragged."""
    S, rows = K5_RANDOM_CASES[name]
    G = rows * LANES
    rng = np.random.default_rng(S * 100 + rows)
    counts = np.maximum(1e7 / np.arange(1, 20001) ** 1.1, 1).astype(np.int64)
    even, odd = build_codebook(counts, 26), build_codebook(np.array([3, 1, 1, 1]) * 10**6, 26)
    fc, off = hw_model._dual_tables(even, odd, dev)
    lens = (even.min_len, odd.min_len), (even.max_len, odd.max_len)
    n_words = G * S // 3
    words = _i32_tensor(rng.integers(0, 1 << 32, n_words, dtype=np.uint64).astype(np.uint32), dev)
    starts = torch.tensor([0, n_words // 2], dtype=torch.int64, device=dev)
    group_counts = torch.tensor([G * S, G * S // 2 + 17], dtype=torch.int32, device=dev)

    def decode(fn):
        return fn(words, starts, group_counts, fc, off, S, *lens, rows)

    require(max_abs_err(decode(kd.decode_groups_dual), decode(kd.decode_groups_dual_ref)) == 0,
            f"{name}: K5")


# ---- bitstream (layout 0) kernel cases ------------------------------------------

# name -> S; byte cases of K7, the pack and decode_streams
BITSTREAM_CASES = {"ragged_s4096": 4096, "s1000": 1000, "deep32_s16384": 1 << 14,
                   "one_symbol": 1 << 18, "one_code_s4096": 4096,
                   "default_3streams": 1 << 18, "uniform8_s262144": 1 << 18,
                   "two_dispatch_s131072": 1 << 17, "host_two_dispatch_s131072": 1 << 17}
PACK_PHASE = 13  # the bit, not word-aligned, at which every case also packs
UNIFORM8_STREAMS = 256  # 64 MiB of uniform bytes: 256 streams of 2^18, all codes 8 bits


def bitstream_case_data(name: str):
    """(symbols u8 padded to whole streams with random bytes past n_valid,
    n_valid, S, codebook) of a byte bitstream kernel case."""
    S = BITSTREAM_CASES[name]
    if name.startswith("deep32"):
        arr, cb = deep_case(5 * S + 4321, limit=32)
    elif name == "one_symbol":
        arr = np.array([77], np.uint8)
        cb = build_codebook(histogram_bytes(arr), 32)
    elif name.startswith("one_code"):  # a one-symbol alphabet: one 1-bit code
        arr = np.full(3 * S + 5, 9, np.uint8)
        cb = build_codebook(histogram_bytes(arr), 32)
    elif name.startswith("uniform8"):  # every byte value equally likely: 8-bit codes
        arr = np.random.default_rng(0x0808).integers(0, 256, UNIFORM8_STREAMS * S, dtype=np.uint8)
        cb = build_codebook(histogram_bytes(arr), 32)
        require(cb.min_len == cb.max_len == 8, f"{name}: codes of {cb.min_len}-{cb.max_len} bits")
    else:
        n = {"ragged_s4096": 10 * S - 777, "s1000": 50 * S + 7, "default_3streams": 3 * S - 5,
             "two_dispatch_s131072": 2 * S - 777, "host_two_dispatch_s131072": 2 * S - 777}
        arr = make_corpus(n[name], seed=S + 3)
        cb = build_codebook(histogram_bytes(arr), 32)
    sym = np.random.default_rng(S).integers(0, 256, -(-arr.size // S) * S, dtype=np.uint8)
    sym[: arr.size] = arr
    return sym, arr.size, S, cb


class PackInputs:
    """The pack's inputs and its plain versions' outputs for codes and
    lengths on one device: each kernel sees the inputs the path gives it."""

    def __init__(self, lj: torch.Tensor, lens: torch.Tensor, S: int):
        self.lj, self.lens, self.S = lj, lens, S
        self.words, self.total, self.sb = be.pack_codes_ref(lj, lens, S)
        self.starts = torch.cumsum(self.sb, 0) - self.sb
        self.n_words = self.words.numel()
        self.tile_end = torch.cumsum(be.pack_scan_ref(lens), 0)

    def scan(self, fn):
        return fn(self.lens)

    def pack(self, fn, phase: int = 0):
        return fn(self.lj, self.lens, self.tile_end, phase, self.S,
                  (phase + self.total + 31) >> 5)

    def check(self, name: str) -> None:
        """pack_scan and pack_tiles bit-exact against their plain versions,
        from bit 0 and from bit PACK_PHASE, and the whole step (pack_codes)
        against pack_codes_ref."""
        require(max_abs_err(self.scan(be.pack_scan), self.scan(be.pack_scan_ref)) == 0,
                f"{name}: pack_scan")
        for phase in (0, PACK_PHASE):
            require(max_abs_err(self.pack(be.pack_tiles, phase),
                                self.pack(be.pack_tiles_ref, phase)) == 0,
                    f"{name}: pack_tiles from bit {phase}")
        words, total, sb = be.pack_codes(self.lj, self.lens, self.S, PACK_PHASE)
        want = be.pack_codes_ref(self.lj, self.lens, self.S, PACK_PHASE)
        require(total == want[1] and max_abs_err((words, sb), (want[0], want[2])) == 0,
                f"{name}: pack_codes from bit {PACK_PHASE}")


class BitstreamInputs(PackInputs):
    """Everything the byte bitstream kernels take for one input, on one
    device.  Each plain version makes the next kernel's input, so every
    kernel sees the inputs the path gives it."""

    def __init__(self, sym: np.ndarray, n_valid: int, S: int, cb, dev: torch.device):
        self.n_valid, self.cb = n_valid, cb
        self.arr = sym[:n_valid]
        self.sym = torch.from_numpy(sym).to(dev)
        self.lj_tbl = _i32_tensor(cb.left_justified_codes(), dev)
        self.len_tbl = _i32_tensor(cb.lengths.astype(np.uint32), dev)
        super().__init__(*self.lookup(be.lookup_lj_lens_ref), S)
        self.tables = decode_tables(cb, dev)

    def lookup(self, fn):
        return fn(self.sym, self.n_valid, self.lj_tbl, self.len_tbl)

    def decode(self, fn):
        return fn(self.words, self.starts, self.n_valid, self.S, *self.tables,
                  self.cb.min_len, self.cb.max_len)

    def dispatched(self, dispatch: int, host: bool):
        """(words, starts) of the same symbols packed by the kernels in
        dispatches of `dispatch` symbols, as the containers pack them: the
        device container's each on its own and word-aligned (its last
        stream's recorded bits carry the pad); the host container's each
        from the bits before it, the word two dispatches share ORed."""
        words, starts, at = [], [], 0
        for lo in range(0, self.sym.numel(), dispatch):
            lj, lens = (t[lo : lo + dispatch] for t in (self.lj, self.lens))
            w, total, sb = be.pack_codes(lj, lens, self.S, at if host else 0)
            base = at if host else 32 * sum(x.numel() for x in words)
            starts.append(torch.cumsum(sb, 0) - sb + base)
            if host and at & 31:
                w[:1].bitwise_or_(words[-1][-1:])
                words[-1] = words[-1][:-1]
            words.append(w)
            at += total
        return torch.cat(words), torch.cat(starts)


def check_bitstream_case(name: str, dev: torch.device) -> float | None:
    """K7, the pack (pack_scan, pack_tiles) and decode_streams on the card
    against their plain versions for one case, bit-exact, plus the decode
    against the input.  The two-dispatch cases pack two dispatches of one
    stream each with the kernels: word-aligned (the device container), or
    the second from the first's last bit, which is not a word boundary (the
    host container, whose words must be the one-pack plain words); and
    decode them.  Returns the uniform 8-bit case's decode time in ms (CUDA
    events), else None."""
    inp = BitstreamInputs(*bitstream_case_data(name), dev)
    require(max_abs_err(inp.lookup(be.lookup_lj_lens), (inp.lj, inp.lens)) == 0, f"{name}: K7")
    inp.check(name)
    if name.startswith("two_dispatch"):
        inp.words, inp.starts = inp.dispatched(inp.S, host=False)
        require(inp.starts.numel() == 2 and int(inp.starts[1]) % 32 == 0,
                f"{name}: not two word-aligned dispatches")
    if name.startswith("host_two_dispatch"):
        words, starts = inp.dispatched(inp.S, host=True)
        require(int(starts[1]) % 32 != 0, f"{name}: the second dispatch starts on a word")
        require(max_abs_err((words, starts), (inp.words, inp.starts)) == 0,
                f"{name}: two host dispatches differ from one pack")
    out = inp.decode(bd.decode_streams)
    require(max_abs_err(out, inp.decode(bd.decode_streams_ref)) == 0, f"{name}: decode_streams")
    require(np.array_equal(out.cpu().numpy(), inp.arr), f"{name}: round trip")
    if name.startswith("uniform8"):
        return cuda_ms(lambda: inp.decode(bd.decode_streams), reps=5)
    return None


# name -> tokens per stream; HuffWord cases of K6 (lj and length tables),
# the pack and decode_streams_dual
HUFFWORD_BITSTREAM_CASES = {"hw_s16384": 1 << 14, "hw_odd_s1001": 1001,
                            "hw_nonword_s777": 777, "hw_one_token": 1 << 14,
                            "hw_bigvocab_s4097": 4097, "hw_deep32_s999": 999,
                            "hw_uniform8_s16384": 1 << 14}
UNIFORM8_WORD_STREAMS = 64  # 2^20 tokens: 256 equiprobable words (8-bit codes), 1-3-bit separators


def huffword_bitstream_case(name: str):
    """(class-local token ids, word_first, [word, nonword] codebooks,
    n_word, n_nonword, S) of a HuffWord bitstream kernel case.  The deep32
    case draws tokens from made-up dictionaries whose word codes reach 32
    bits (no text has such a vocabulary at a test's size); the uniform8
    case from 256 equiprobable words and four separators of 1-3 bits, so
    the stream decode's guesses meet the true chain late."""
    S = HUFFWORD_BITSTREAM_CASES[name]
    if "uniform8" in name:  # every word code 8 bits, separators of 1-3 bits
        rng = np.random.default_rng(0x0808)
        cb_w = build_codebook(np.ones(256, np.int64), 32)
        cb_n = build_codebook(np.array([4, 2, 1, 1]), 32)
        require(cb_w.min_len == cb_w.max_len == 8 and (cb_n.min_len, cb_n.max_len) == (1, 3),
                f"{name}: codes of {cb_w.min_len}-{cb_w.max_len} and {cb_n.min_len}-"
                f"{cb_n.max_len} bits")
        ids = rng.integers(0, 256, UNIFORM8_WORD_STREAMS * S)
        ids[1::2] = rng.choice(4, ids[1::2].size, p=[0.5, 0.25, 0.125, 0.125])
        return ids, True, [cb_w, cb_n], 256, 4, S
    if "deep32" in name:
        rng = np.random.default_rng(0xD32)
        cb_w = build_codebook(np.left_shift(1, np.maximum(40 - np.arange(200), 0)), 32)
        cb_n = build_codebook(np.array([50, 30, 10, 5, 1]), 32)
        deepest = np.flatnonzero(cb_w.lengths == 32)
        require(cb_w.max_len == 32 and deepest.size, f"{name}: max_len {cb_w.max_len}")
        ids = rng.integers(0, 5, 30_001)
        ids[::2] = np.minimum(rng.geometric(0.5, ids[::2].size) - 1, 199)
        ids[rng.choice(ids.size // 2, 300, replace=False) * 2] = rng.choice(deepest, 300)
        return ids, True, [cb_w, cb_n], 200, 5, S
    if "nonword" in name:
        text = b"  ...  " + make_word_corpus(100_000, seed=0x3AF)
    elif "one_token" in name:
        text = b"a"
    elif "bigvocab" in name:
        text = big_vocab_text()
    else:  # ~2.5 streams of the word corpus (~2.14 bytes per token)
        text = make_word_corpus(int(2.5 * S * 2.14), seed=S)
    _, _, wf, wv, nv, ids = tok.build_vocabs(text)
    cbs = [build_codebook(v.counts if v.n else np.zeros(1, np.int64), 32) for v in (wv, nv)]
    return ids, bool(wf), cbs, wv.n, nv.n, S


class HuffwordBitstreamInputs(PackInputs):
    """Everything the HuffWord bitstream kernels take for one token
    sequence, on one device; each plain version makes the next kernel's
    input."""

    def __init__(self, ids: np.ndarray, word_first: bool, cbs, n_word: int, n_nonword: int,
                 S: int, dev: torch.device):
        self.T, self.S, self.ids, self.word_first = ids.size, S, ids, word_first
        self.small = max(n_word, n_nonword) <= 0xFFFF
        ids_pad = np.zeros(max(1, -(-self.T // S)) * S, np.uint16 if self.small else np.uint32)
        ids_pad[: self.T] = ids
        self.ids_d = torch.from_numpy(ids_pad.view(np.int16 if self.small else np.int32)).to(dev)
        self.n0 = max(n_word, 1)
        self.lj_tbl, self.len_tbl = hw_model.bitstream_tables(cbs, n_word, n_nonword, dev)
        super().__init__(self.gather(lut.gather_entries_ref, self.lj_tbl),
                         self.gather(lut.gather_entries_ref, self.len_tbl), S)
        # the decoders' codebooks: those of the lengths a container stores
        cb_w, cb_n = (codebook_from_lengths(cb.lengths if k else np.zeros(0, np.int32))
                      for cb, k in zip(cbs, (n_word, n_nonword)))
        self.even, self.odd = (cb_w, cb_n) if word_first else (cb_n, cb_w)
        self.fc, self.off = hw_model._dual_tables(self.even, self.odd, dev)
        self.len_range = ((self.even.min_len, self.odd.min_len),
                          (self.even.max_len, self.odd.max_len))
        self.scan_levels = (self.even.max_len - self.even.min_len,
                            self.odd.max_len - self.odd.min_len)

    def gather(self, fn, tbl: torch.Tensor):
        return fn(self.ids_d, tbl, 0, self.n0, self.T, self.word_first)

    def decode(self, fn):
        return fn(self.words, self.starts, self.T, self.S, self.fc, self.off, *self.len_range)

    def token_ids(self, ranks: torch.Tensor) -> np.ndarray:
        return hw_model._ranks_to_ids(ranks, self.even, self.odd, self.small, self.T,
                                      ranks.device)


def check_huffword_bitstream_case(name: str, dev: torch.device) -> str | None:
    """K6 with the lj and the length tables, the pack (pack_scan,
    pack_tiles) and decode_streams_dual on the card against their plain
    versions for one case, bit-exact, plus the token round trip.  Returns the uniform8 case's decode time (CUDA
    events) and its synchronisation rounds (the plain subsequence table's:
    the kernel runs the same rounds), else None."""
    inp = HuffwordBitstreamInputs(*huffword_bitstream_case(name), dev)
    for tbl, want, what in ((inp.lj_tbl, inp.lj, "lj"), (inp.len_tbl, inp.lens, "lengths")):
        require(max_abs_err(inp.gather(lut.gather_entries, tbl), want) == 0,
                f"{name}: K6 {what}")
    inp.check(name)
    ranks = inp.decode(bd.decode_streams_dual)
    require(max_abs_err(ranks, inp.decode(bd.decode_streams_dual_ref)) == 0,
            f"{name}: decode_streams_dual")
    require(np.array_equal(inp.token_ids(ranks), inp.ids), f"{name}: token round trip")
    if "uniform8" not in name:
        return None
    ms = cuda_ms(lambda: inp.decode(bd.decode_streams_dual), reps=5)
    tables = [bd.subsequence_table_dual_ref(inp.words, inp.starts, inp.T, inp.S, inp.fc,
                                            inp.off, *inp.len_range, bd.DUAL_SUBSEQ_BITS,
                                            rounds=rounds) for rounds in (None, 0)]
    (_, start, par, _, _, _, rounds), (_, guess, guess_par, *_) = tables
    restarted = int(((start != guess) | (par != guess_par)).sum())
    return (f"{ms:.3f} ms, {rounds} rounds, {restarted} of {start.numel()} subsequences "
            f"restarted (plain subsequence table, T {bd.DUAL_SUBSEQ_BITS})")


@contextlib.contextmanager
def patched(module, **values):
    """The module's constants set to `values` inside the block (phase 5's
    sweeps of the decode kernels' table and subsequence sizes)."""
    old = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def table_shares(cb, hist: np.ndarray) -> str:
    """The share of symbols, by the histogram, whose code the decode table
    resolves in one probe (length <= table_bits), per swept table size."""
    n = hist.sum()
    return ", ".join(f"{tb} bits {hist[(cb.lengths > 0) & (cb.lengths <= tb)].sum() / n:.4%}"
                     for tb in TABLE_BITS_SWEEP)


def clock(out: dict, key: str, fn):
    """fn() on the host clock, ending in a synchronize; its milliseconds go
    to out[key] and its result is returned."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    out[key] = (time.perf_counter() - t0) * 1e3
    return r


def host_steps(arr: np.ndarray, blob: bytes, conf: cfg.GlzConfig,
               dev: torch.device) -> dict[str, float]:
    """Milliseconds of the main path's host-side steps, each re-run alone
    at the main path's sizes (host clock; transfers end in a synchronize)."""
    n = arr.size
    group = conf.group_rows * LANES * conf.stream_symbols
    out = {}
    clock(out, "histogram+codebook", lambda: build_codebook(
        sampled_histogram(arr, conf.histogram_budget), ke.MAX_FUSED_LEN))
    host = clock(out, "pad copy", lambda: np.concatenate(
        [arr, np.zeros(-n % group, np.uint8)]))
    sym = clock(out, "H2D symbols", lambda: torch.from_numpy(host).to(dev))
    words = torch.empty(len(blob) // 4, dtype=torch.int32, device=dev)
    clock(out, "D2H payload", lambda: words.cpu())
    clock(out, "D2H symbols", lambda: sym.cpu())
    clock(out, "crc32", lambda: zlib.crc32(arr))
    clock(out, "host copy (tobytes)", lambda: arr.tobytes())
    return out


def huffword_host_steps(data: bytes, blob: bytes, group: int, dev: torch.device):
    """Milliseconds of the HuffWord path's host-side steps and transfers,
    each re-run alone at the main path's sizes (host clock; transfers end
    in a synchronize), and the tokenizer's output for phase 5."""
    out = {}
    vocabs = clock(out, "tokenize+vocab", lambda: tok.build_vocabs(data))
    _, _, wf, wv, nv, ids = vocabs
    clock(out, "codebooks",
          lambda: [build_codebook(v.counts, ke.MAX_FUSED_LEN) for v in (wv, nv)])
    ids16 = clock(out, "pad ids", lambda: np.concatenate(
        [ids.astype(np.uint16), np.zeros(-ids.size % group, np.uint16)]))
    ids_d = clock(out, "H2D ids", lambda: torch.from_numpy(ids16.view(np.int16)).to(dev))
    f = clock(out, "read container", lambda: container.read_container(blob))
    words = np.frombuffer(f.payload, dtype="<u4", count=len(f.payload) // 4)
    pay_d = clock(out, "H2D payload", lambda: _i32_tensor(words, dev))
    clock(out, "D2H payload", lambda: pay_d.cpu())
    clock(out, "D2H ids", lambda: ids_d[: ids.size].cpu())
    clock(out, "detokenize", lambda: tok.detokenize(ids, wf, wv, nv))
    clock(out, "crc32", lambda: zlib.crc32(data))
    return out, vocabs


def timed_once(fn):
    """(milliseconds, result) of one fn() call on the card (CUDA events)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), result


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` calls after one
    warm-up call (CUDA events)."""
    def run():
        for _ in range(reps):
            fn()

    fn()
    ms, _ = timed_once(run)
    return ms / reps


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_name(mangled: str) -> str:
    """A readable name for a compiled kernel: the function and its template
    arguments (lanes per thread, entry words, u16/u32 element types)."""
    m = re.search(r"(lane_totals_entries_kernel|lane_totals_kernel|encode_kernel|"
                  r"decode_dual_kernel|decode_kernel|lut_gather_kernel|lookup_lj_lens_kernel|"
                  r"pack_scan_kernel|pack_tiles_kernel|decode_streams_sync_kernel)"
                  r"(I.*E)?", mangled)
    if not m:
        return mangled
    args = m.group(2) or ""
    widths = {"t": "u16", "j": "u32"}
    parts = re.findall(r"Li(\d+)E", args)
    flags = {"Lb1E": "dual" if m.group(1) == "decode_streams_sync_kernel" else "entries",
             "Lb0E": "bytes"}
    parts += [v for k, v in flags.items() if k in args]
    if m.group(1) == "lut_gather_kernel":
        parts = [widths[c] for c in re.findall(r"[tj]", args[1:-1])]
    return m.group(1) + (f"<{','.join(parts)}>" if parts else "")


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel: registers and spill bytes (ptxas -v)."""
    out, name = [], None
    spill = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill stores {m.group(1)} B, spill loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return out


def huffword_kernel_times(text: bytes, f, vocabs, launches: dict, dev: torch.device,
                          card: str) -> list[dict]:
    """Phase 5 for the HuffWord path: each kernel at the main path's shapes
    against its plain version; K6 at both call sites (one JSON row, the two
    launches summed) with torch.take on the same final indices as its
    library yardstick."""
    inp = HuffwordInputs(text, f.stream_symbols, f.group_rows, dev, vocabs=vocabs)
    n_pad, T = inp.ids_d.numel(), inp.T
    n_groups, lanes = inp.padded.size, inp.padded.size * inp.G
    id_bytes = 2 if inp.small else 4
    sites = {  # name -> (kernel, plain, bytes, ops, library call or None)
        "lut_gather/gather_entries": (
            lambda: inp.gather(lut.gather_entries), lambda: inp.gather(lut.gather_entries_ref),
            id_bytes * n_pad + 4 * n_pad + 4 * inp.ent_tbl.numel(),
            OPS_PER_SYMBOL["lut_gather"] * n_pad, inp.ent_tbl),
        "lane_totals_entries": (
            lambda: inp.totals(ke.lane_totals_entries),
            lambda: inp.totals(ke.lane_totals_entries_ref),
            4 * n_pad + 4 * lanes + 4 * n_groups,
            OPS_PER_SYMBOL["lane_totals_entries"] * n_pad, None),
        "encode_entries": (
            lambda: inp.encode(ke.encode_entries), lambda: inp.encode(ke.encode_entries_ref),
            4 * n_pad + 4 * lanes + 12 * n_groups + 4 * inp.n_words,
            OPS_PER_SYMBOL["encode_entries"] * T, None),
        "decode_dual": (
            lambda: inp.decode(kd.decode_groups_dual),
            lambda: inp.decode(kd.decode_groups_dual_ref),
            4 * inp.n_words + 12 * n_groups + 4 * 4 * 34 + 4 * n_pad, DECODE_OPS_BASE * T,
            None),
        "lut_gather/map_ranks": (
            lambda: inp.map(lut.map_ranks), lambda: inp.map(lut.map_ranks_ref),
            4 * n_pad + id_bytes * n_pad + 4 * inp.sym_tbl.numel(),
            OPS_PER_SYMBOL["lut_gather"] * n_pad, inp.sym_tbl),
    }
    # the final indices of each K6 call site, for torch.take
    pos = torch.arange(n_pad, device=dev)
    take_idx = {
        "lut_gather/gather_entries": (
            (inp.ids_d.long() & 0xFFFFFFFF)
            + torch.where((pos % 2 == 0) == inp.word_first, 0, inp.n0)
        ).clamp(max=inp.ent_tbl.numel() - 1),
        "lut_gather/map_ranks": (
            (inp.ranks.long() & 0xFFFFFFFF) + torch.where(pos % 2 == 1, inp.n_even, 0)
        ).clamp(max=inp.sym_tbl.numel() - 1),
    }
    del pos
    out, k6 = [], None
    for site, (kernel, plain_fn, nbytes, nops, table) in sites.items():
        plain_ms, plain_out = timed_once(plain_fn)
        got = kernel()
        err = max_abs_err(got, plain_out)
        require(err == 0, f"huffword main shape: {site} differs from its plain version by {err}")
        if site == "encode_entries":
            require(not bool(got[1].any()), "huffword main shape: encode cursor did not end at 0")
        del got, plain_out
        ms = cuda_ms(kernel, reps=5)
        lib_ms = None
        if table is not None:
            idx = take_idx[site]
            lib_ms = cuda_ms(lambda: torch.take(table, idx), reps=5)
        b_ms, b_by = bound(nbytes, nops)
        print(f"time: {site} {ms:.3f} ms (plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms by "
              f"{b_by}; {nbytes} B, {nops} ops"
              + (f"; torch.take {lib_ms:.3f} ms" if lib_ms is not None else "")
              + f") on {card}", flush=True)
        kname = site.split("/")[0]
        row = {"name": kname, "route": "cuda", "source": "glz_tpu_torch/csrc/lockstep.cu",
               "replaces": REPLACES[kname], "launches": launches[kname], "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms, "_bytes": nbytes, "_ops": nops}
        if kname == "lut_gather" and k6 is not None:
            for key in ("ms", "plain_ms", "library_ms", "_bytes", "_ops"):
                k6[key] += row[key]
            k6["max_abs_err"] = max(k6["max_abs_err"], err)
            k6["bound_ms"], k6["bound_by"] = bound(k6["_bytes"], k6["_ops"])
            continue
        if kname == "lut_gather":
            k6 = row
        out.append(row)
    for row in out:
        del row["_bytes"], row["_ops"]
    return out


def bitstream_host_steps(arr: np.ndarray, blob: bytes, conf: cfg.GlzConfig,
                         dev: torch.device) -> dict[str, float]:
    """Milliseconds of the byte bitstream path's host-side steps, each re-run
    alone at the main path's sizes (host clock; transfers end in a
    synchronize); a dispatch's steps are summed over the dispatches."""
    out = {}
    clock(out, "histogram+codebook", lambda: build_codebook(
        sampled_histogram(arr, conf.histogram_budget), conf.length_limit))
    f = clock(out, "read container", lambda: container.read_container(blob))
    S = f.stream_symbols
    h2d = {}
    for lo in range(0, arr.size, (cb_model.MAX_DISPATCH_SYMBOLS // S) * S):
        chunk = arr[lo : lo + (cb_model.MAX_DISPATCH_SYMBOLS // S) * S]
        clock(h2d, "one", lambda: cb_model._symbols_on(chunk, _round_up(chunk.size, S), dev))
        out["pad + H2D symbols"] = out.get("pad + H2D symbols", 0.0) + h2d["one"]
    words_d = torch.empty(len(f.payload) // 4, dtype=torch.int32, device=dev)
    words = clock(out, "D2H payload", lambda: words_d.cpu().numpy().view(np.uint32))
    clock(out, "words_to_bytes", lambda: bitio.words_to_bytes(words, 32 * words.size - 3))
    clock(out, "bytes_to_words + H2D payload",
          lambda: _i32_tensor(bitio.bytes_to_words(f.payload), dev))
    sym = torch.empty(arr.size, dtype=torch.uint8, device=dev)
    clock(out, "D2H symbols", lambda: sym.cpu())
    clock(out, "crc32", lambda: zlib.crc32(arr))
    clock(out, "host copy (tobytes)", lambda: arr.tobytes())
    return out


def measure(kname: str, kernel, plain_fn, nbytes: int, nops: int, launches: dict,
            card: str, library=None, check=None, reps: int = 5) -> dict:
    """One bitstream kernel's row of the kernels line: its output against
    its plain version's on the same inputs (bit-exact) and `check`, then
    the times (CUDA events) of the kernel, the plain version and, where
    given, one PyTorch call computing the same function."""
    plain_ms, want = timed_once(plain_fn)
    got = kernel()
    err = max_abs_err(got, want)
    require(err == 0, f"main shape: {kname} differs from its plain version by {err}")
    if check is not None:
        check(got)
    del got, want
    ms = cuda_ms(kernel, reps)
    lib_ms = cuda_ms(library, reps) if library is not None else None
    b_ms, b_by = bound(nbytes, nops)
    print(f"time: {kname} {ms:.3f} ms (plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms by "
          f"{b_by}; {nbytes} B, {nops} ops"
          + (f"; library {lib_ms:.3f} ms" if lib_ms is not None else "")
          + f") on {card}", flush=True)
    return {"name": kname, "route": "cuda", "source": "glz_tpu_torch/csrc/bitstream.cu",
            "replaces": REPLACES[kname], "launches": launches[kname], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def old_pack_module():
    """tools/pack_phases.py, which holds the first port's pack step."""
    spec = importlib.util.spec_from_file_location("pack_phases", ROOT / "tools" / "pack_phases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pack_step_times(inp: PackInputs, what: str, card: str) -> None:
    """The whole pack step (pack_codes: the tile sums, their cumsum, the
    total on the host, the zeroed words, the pack and the stream bits' diff)
    on the card, against the first port's step (an int64 torch.cumsum, the
    subtraction, the per-stream sum, the total, the zeroed words and
    pack_lj_kernel, built from tools/pack_phases.py) on the same codes, in
    turns: old, new, new, old.  Both must give the plain version's words."""
    pack_phases = old_pack_module()
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_kernels.BUILD_DIR) as tmp:
        lib = pack_phases.build_old(pathlib.Path(tmp))
        old = lambda: pack_phases.old_pack_step(lib, inp.lj, inp.lens, inp.S)  # noqa: E731
        new = lambda: be.pack_codes(inp.lj, inp.lens, inp.S)  # noqa: E731
        for name, fn in (("old", old), ("new", new)):
            words, total, sb = fn()
            require(total == inp.total and max_abs_err((words, sb), (inp.words, inp.sb)) == 0,
                    f"{what}: the {name} pack step differs from the plain version")
        times = [cuda_ms(fn, reps=5) for fn in (old, new, new, old)]
    b_ms, b_by = bound(8 * inp.lens.numel() + 4 * inp.n_words,
                       OPS_PER_SYMBOL["pack_tiles"] * inp.lens.numel())
    print(f"time: pack step ({what}: {inp.total} bits) {min(times[1:3]):.3f} ms "
          f"(runs {times[1]:.3f}, {times[2]:.3f}); first port's cumsum + pack step "
          f"{min(times[0], times[3]):.3f} ms (runs {times[0]:.3f}, {times[3]:.3f}); the "
          f"function's bound {b_ms:.3f} ms by {b_by}; on {card}", flush=True)


def bitstream_kernel_times(arr: np.ndarray, blob: bytes, launches: dict,
                           dev: torch.device, card: str) -> list[dict]:
    """Phase 5 for the byte bitstream path: K7 and the pack on the main
    path's first dispatch (2^27 symbols) with its codebook, the stream
    decode on the whole container; each against its plain version, the
    decode also against the input.  K7's library yardstick is torch.take of
    one table holding both values (lj | length << 32) on the same symbols;
    pack_scan's is a sum over the lengths viewed as [tiles, PACK_TILE]."""
    f = container.read_container(blob)
    S, n = f.stream_symbols, f.n_symbols
    cb = codebook_from_lengths(container.decode_byte_codebook(f.codebook_blob))
    dispatch = (cb_model.MAX_DISPATCH_SYMBOLS // S) * S
    inp = BitstreamInputs(arr[:dispatch], dispatch, S, cb, dev)
    m = inp.sym.numel()
    both = (inp.lj_tbl.long() & 0xFFFFFFFF) | (inp.len_tbl.long() << 32)
    idx = inp.sym.long()
    rows = [measure("lookup_lj_lens", lambda: inp.lookup(be.lookup_lj_lens),
                    lambda: inp.lookup(be.lookup_lj_lens_ref), m + 8 * m + 2 * 1024,
                    OPS_PER_SYMBOL["lookup_lj_lens"] * m, launches, card,
                    library=lambda: torch.take(both, idx))]
    del both, idx
    tiles = inp.tile_end.numel()
    require(m % be.PACK_TILE == 0, f"main shape: {m} codes are not whole pack tiles")
    rows.append(measure("pack_scan", lambda: inp.scan(be.pack_scan),
                        lambda: inp.scan(be.pack_scan_ref), 4 * m + 8 * tiles,
                        OPS_PER_SYMBOL["pack_scan"] * m, launches, card,
                        library=lambda: inp.lens.view(-1, be.PACK_TILE).sum(1, dtype=torch.int64)))
    rows.append(measure("pack_tiles", lambda: inp.pack(be.pack_tiles),
                        lambda: inp.pack(be.pack_tiles_ref),
                        8 * m + 8 * tiles + 4 * inp.n_words + 8 * (m // S + 1),
                        OPS_PER_SYMBOL["pack_tiles"] * m, launches, card))
    pack_step_times(inp, f"byte bitstream dispatch of {m} symbols", card)
    del inp
    words = _i32_tensor(bitio.bytes_to_words(f.payload), dev)
    sb = f.stream_bits.astype(np.int64)
    starts = torch.from_numpy(np.cumsum(sb) - sb).to(dev)
    tables = decode_tables(cb, dev)

    def decode(fn):
        return fn(words, starts, n, S, *tables, cb.min_len, cb.max_len)

    def same_as_input(out):
        require(np.array_equal(out.cpu().numpy(), arr), "main shape: decode_streams != input")

    rows.append(measure("decode_streams", lambda: decode(bd.decode_streams),
                        lambda: decode(bd.decode_streams_ref),
                        4 * words.numel() + 8 * starts.numel() + n + 4 * (2 * 34 + 256),
                        DECODE_OPS_BASE * n, launches, card, check=same_as_input))
    want = torch.from_numpy(arr).to(dev)
    sweep = []
    for tb in TABLE_BITS_SWEEP:
        for T in SUBSEQ_BITS_SWEEP:
            with patched(bd, TABLE_BITS=tb, SUBSEQ_BITS=T):
                require(torch.equal(decode(bd.decode_streams), want),
                        f"main shape: decode_streams at table_bits {tb}, T {T} != input")
                ms = cuda_ms(lambda: decode(bd.decode_streams), reps=5)
            sweep.append(f"table_bits {tb} T {T}: {ms:.3f}")
    print(f"sweep: decode_streams at the main shape (ms): {'; '.join(sweep)} on {card}",
          flush=True)
    return rows


def huffword_bitstream_kernel_times(blob: bytes, vocabs, launches: dict,
                                    dev: torch.device, card: str) -> list[dict]:
    """Phase 5 for the HuffWord bitstream path, on the whole of phase 4d's
    tokens: K6 with the lj and the length tables and the pack (times
    printed; their rows are the other paths'), then the dual stream decode,
    each against its plain version; the pack's payload must be the
    container's and the decode must give back the tokens."""
    f = container.read_container(blob)
    _, _, wf, wv, nv, ids = vocabs
    cbs = [build_codebook(v.counts, cfg.DEFAULT.length_limit) for v in (wv, nv)]
    inp = HuffwordBitstreamInputs(ids, bool(wf), cbs, wv.n, nv.n, f.stream_symbols, dev)
    require(bitio.words_to_bytes(inp.words.cpu().numpy().view(np.uint32), inp.total)
            == f.payload, "huffword bitstream main shape: payload differs from the container's")
    T, n_pad = inp.T, inp.ids_d.numel()
    id_bytes = 2 if inp.small else 4
    for what, tbl, want in (("lj", inp.lj_tbl, inp.lj), ("lengths", inp.len_tbl, inp.lens)):
        err = max_abs_err(inp.gather(lut.gather_entries, tbl), want)
        require(err == 0, f"huffword bitstream main shape: K6 {what} differs by {err}")
        ms = cuda_ms(lambda: inp.gather(lut.gather_entries, tbl), reps=5)
        b_ms, b_by = bound(id_bytes * n_pad + 4 * n_pad + 4 * tbl.numel(),
                           OPS_PER_SYMBOL["lut_gather"] * n_pad)
        print(f"time: lut_gather/bitstream {what} {ms:.3f} ms (bound {b_ms:.3f} ms by {b_by}) "
              f"on {card}", flush=True)
    inp.check("huffword bitstream main shape")
    pack_step_times(inp, f"HuffWord bitstream, {T} tokens", card)

    def same_as_tokens(ranks):
        require(np.array_equal(inp.token_ids(ranks), ids),
                "huffword bitstream main shape: decode_streams_dual != tokens")

    rows = [measure("decode_streams_dual", lambda: inp.decode(bd.decode_streams_dual),
                    lambda: inp.decode(bd.decode_streams_dual_ref),
                    4 * inp.n_words + 8 * inp.starts.numel() + 4 * T + 4 * 4 * 34,
                    DECODE_OPS_BASE * T, launches, card, check=same_as_tokens)]
    want = inp.decode(bd.decode_streams_dual_ref)
    sweep = []
    for tb in DUAL_TABLE_BITS_SWEEP:
        for sub in DUAL_SUBSEQ_BITS_SWEEP:
            with patched(bd, DUAL_TABLE_BITS=tb, DUAL_SUBSEQ_BITS=sub):
                require(torch.equal(inp.decode(bd.decode_streams_dual), want),
                        f"main shape: decode_streams_dual at table_bits {tb}, T {sub} differs")
                ms = cuda_ms(lambda: inp.decode(bd.decode_streams_dual), reps=5)
            sweep.append(f"table_bits {tb} T {sub}: {ms:.3f}")
    print(f"sweep: decode_streams_dual at the main shape (ms): {'; '.join(sweep)} on {card}",
          flush=True)
    shares = [", ".join(f"{tb} bits {v.counts[cb.lengths <= tb].sum() / v.counts.sum():.4%}"
                        for tb in DUAL_TABLE_BITS_SWEEP) for v, cb in zip((wv, nv), cbs)]
    print(f"table: tokens the dual tables resolve in one probe: words (codes {cbs[0].min_len}-"
          f"{cbs[0].max_len} bits) {shares[0]}; separators (codes {cbs[1].min_len}-"
          f"{cbs[1].max_len} bits) {shares[1]}", flush=True)
    return rows


def round_trip(data, mode: int, conf: cfg.GlzConfig, backend: str = "host"):
    """(blob, output, compress s, decompress s, launches) of one timed
    round trip through the entry points, the launch counts zeroed just
    before and read just after; peak device memory is reset before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    blob = gt.compress(data, mode=mode, backend=backend, conf=conf)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = gt.decompress(blob)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    return blob, out, t_c, t_d, _kernels.launch_counts()


def main() -> int:
    # ---- 1. environment
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_kernels.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda}; {name} x{count}; "
          f"{smi}; {nvcc}", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    _kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s; "
          + "; ".join(ptxas_summary(_kernels.build_log())), flush=True)

    # ---- 3. kernels against their plain versions
    t0 = time.perf_counter()
    for case in CASES:
        check_case(case, dev)
    torch.cuda.synchronize()
    print(f"kernels: lane_totals, encode_groups, decode_groups bit-exact vs plain on "
          f"{len(CASES)}/{len(CASES)} cases ({', '.join(CASES)}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for case in HUFFWORD_CASES:
        check_huffword_case(case, dev)
    for case in K5_RANDOM_CASES:
        check_k5_random(case, dev)
    torch.cuda.synchronize()
    print(f"kernels: lut_gather (gather_entries, map_ranks), lane_totals_entries, "
          f"encode_entries, decode_dual bit-exact vs plain, "
          f"tokens round-trip, on {len(HUFFWORD_CASES)}/{len(HUFFWORD_CASES)} cases "
          f"({', '.join(HUFFWORD_CASES)}); decode_dual on random words at "
          f"{', '.join(K5_RANDOM_CASES)}; {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    uniform_ms = [check_bitstream_case(case, dev) for case in BITSTREAM_CASES]
    uniform_ms = next(ms for ms in uniform_ms if ms is not None)
    hw_uniform = [check_huffword_bitstream_case(case, dev) for case in HUFFWORD_BITSTREAM_CASES]
    hw_uniform = next(line for line in hw_uniform if line is not None)
    torch.cuda.synchronize()
    print(f"kernels: lookup_lj_lens, pack_scan, pack_tiles (from bit 0 and bit {PACK_PHASE}), "
          f"decode_streams bit-exact vs plain, round trip, "
          f"on {len(BITSTREAM_CASES)}/{len(BITSTREAM_CASES)} cases "
          f"({', '.join(BITSTREAM_CASES)}); lut_gather (lj, lengths), pack_scan, pack_tiles, "
          f"decode_streams_dual on {len(HUFFWORD_BITSTREAM_CASES)}/"
          f"{len(HUFFWORD_BITSTREAM_CASES)} cases ({', '.join(HUFFWORD_BITSTREAM_CASES)}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    card = f"{name} ({smi})"
    print(f"time: decode_streams on uniform8_s262144 ({UNIFORM8_STREAMS} streams of 2^18 "
          f"symbols, all codes 8 bits) {uniform_ms:.3f} ms on {card}", flush=True)
    print(f"time: decode_streams_dual on hw_uniform8_s16384 ({UNIFORM8_WORD_STREAMS} streams "
          f"of 16,384 tokens, word codes 8 bits, separators 1-3) {hw_uniform} on {card}",
          flush=True)

    # ---- 4. main path: 512 MiB under THROUGHPUT with checksum
    arr = make_corpus(MAIN_BYTES)
    n = arr.size
    conf = dataclasses.replace(cfg.THROUGHPUT, checksum=True)
    gt.decompress(gt.compress(arr[: 1 << 20], conf=conf))  # CUDA context, warm-up
    blob, out, t_c, t_d, launches = round_trip(arr, cfg.MODE_BYTE, conf)
    require(out == arr.tobytes(), "main path: round trip mismatch")
    require(all(launches[k] > 0 for k in BYTE_KERNELS),
            f"main path missed a kernel: {launches}")
    print(f"main: {n >> 20} MiB THROUGHPUT+checksum on {card}: compress "
          f"{t_c * 1e3:.1f} ms ({n / t_c / 1e9:.3f} GB/s), decompress {t_d * 1e3:.1f} ms "
          f"({n / t_d / 1e9:.3f} GB/s), ratio {len(blob) / n:.4f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, launches {launches}",
          flush=True)
    del out
    steps = host_steps(arr, blob, conf, dev)
    print("host: " + ", ".join(f"{k} {v:.1f} ms" for k, v in steps.items())
          + f" (each re-run alone at {n >> 20} MiB; container {len(blob)} B)", flush=True)

    # ---- 4b. HuffWord main path: 100 MiB of word text, S 512, rows 32
    t0 = time.perf_counter()
    text = make_word_corpus(HUFFWORD_BYTES)
    t_gen = time.perf_counter() - t0
    hconf = huffword_conf()
    mode = cfg.MODE_HUFFWORD
    gt.decompress(gt.compress(text[: 1 << 20], mode=mode, conf=hconf))  # warm-up
    hblob, hout, t_c, t_d, hlaunches = round_trip(text, mode, hconf)
    require(hout == text, "huffword main path: round trip mismatch")
    require(all(hlaunches[k] > 0 for k in HUFFWORD_KERNELS),
            f"huffword main path missed a kernel: {hlaunches}")
    del hout
    hf = container.read_container(hblob)
    hn = len(text)
    print(f"main: HuffWord {hn >> 20} MiB S {hf.stream_symbols} rows {hf.group_rows} "
          f"+checksum on {card}: {hf.n_symbols} tokens in {hf.n_streams} groups; "
          f"compress {t_c * 1e3:.1f} ms ({hn / t_c / 1e9:.3f} GB/s), decompress "
          f"{t_d * 1e3:.1f} ms ({hn / t_d / 1e9:.3f} GB/s), ratio {len(hblob) / hn:.4f}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, "
          f"launches {hlaunches}; corpus made in {t_gen * 1e3:.0f} ms", flush=True)
    hsteps, vocabs = huffword_host_steps(
        text, hblob, hf.group_rows * LANES * hf.stream_symbols, dev)
    print("host: HuffWord " + ", ".join(f"{k} {v:.1f} ms" for k, v in hsteps.items())
          + f" (each re-run alone at {hn >> 20} MiB; container {len(hblob)} B)", flush=True)

    # ---- 4c. byte bitstream path: the same 512 MiB under DEFAULT with checksum,
    # through glz_tpu's default front door (backend "host"), then the
    # device backend's container
    bconf = dataclasses.replace(cfg.DEFAULT, checksum=True)
    gt.decompress(gt.compress(arr[: 1 << 20], conf=bconf))  # warm-up
    bblobs = {}
    for backend in ("host", "device"):
        bblob, out, t_c, t_d, blaunches = round_trip(arr, cfg.MODE_BYTE, bconf, backend)
        require(out == arr.tobytes(), f"bitstream path ({backend}): round trip mismatch")
        require(all(blaunches[k] > 0 for k in BITSTREAM_KERNELS),
                f"bitstream path ({backend}) missed a kernel: {blaunches}")
        del out
        bf = container.read_container(bblob)
        dispatch = (cb_model.MAX_DISPATCH_SYMBOLS // bf.stream_symbols) * bf.stream_symbols
        print(f"main: bitstream {n >> 20} MiB DEFAULT+checksum, backend {backend!r}, on {card}: "
              f"{bf.n_streams} streams of {bf.stream_symbols} symbols in {-(-n // dispatch)} "
              f"dispatches; compress {t_c * 1e3:.1f} ms ({n / t_c / 1e9:.3f} GB/s), decompress "
              f"{t_d * 1e3:.1f} ms ({n / t_d / 1e9:.3f} GB/s), ratio {len(bblob) / n:.4f}, peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, launches "
              f"{blaunches}", flush=True)
        bblobs[backend] = (bblob, blaunches)
    bblob, blaunches = bblobs["host"]
    bf = container.read_container(bblob)
    bsteps = bitstream_host_steps(arr, bblob, bconf, dev)
    print("host: bitstream " + ", ".join(f"{k} {v:.1f} ms" for k, v in bsteps.items())
          + f" (each re-run alone at {n >> 20} MiB; container {len(bblob)} B)", flush=True)
    del bblobs

    # ---- 4d. HuffWord bitstream path: phase 4b's text under DEFAULT with checksum
    gt.decompress(gt.compress(text[: 1 << 20], mode=mode, conf=bconf))  # warm-up
    hbblob, hout, t_c, t_d, hblaunches = round_trip(text, mode, bconf)
    require(hout == text, "huffword bitstream path: round trip mismatch")
    require(all(hblaunches[k] > 0 for k in HUFFWORD_BITSTREAM_KERNELS),
            f"huffword bitstream path missed a kernel: {hblaunches}")
    del hout
    hbf = container.read_container(hbblob)
    print(f"main: HuffWord bitstream {hn >> 20} MiB DEFAULT+checksum on {card}: "
          f"{hbf.n_symbols} tokens in {hbf.n_streams} streams of {hbf.stream_symbols}; "
          f"compress {t_c * 1e3:.1f} ms ({hn / t_c / 1e9:.3f} GB/s), decompress "
          f"{t_d * 1e3:.1f} ms ({hn / t_d / 1e9:.3f} GB/s), ratio {len(hbblob) / hn:.4f}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, "
          f"launches {hblaunches}", flush=True)

    # ---- 5. kernel times at the main path's shapes
    cb = build_codebook(sampled_histogram(arr, conf.histogram_budget), ke.MAX_FUSED_LEN)
    inp = KernelInputs(arr, n, conf.stream_symbols, conf.group_rows, cb, dev)
    n_pad, n_groups, words = inp.sym.numel(), inp.padded.size, inp.n_words
    lane_bytes = 4 * n_groups * inp.G
    traffic = {
        "lane_totals": n_pad + 1024 + lane_bytes + 4 * n_groups,
        "encode_groups": n_pad + 1024 + lane_bytes + 12 * n_groups + 4 * words,
        "decode_groups": 4 * words + 12 * n_groups + 4 * (2 * 34 + 256) + n_pad,
    }
    ops = {
        "lane_totals": OPS_PER_SYMBOL["lane_totals"] * n,
        "encode_groups": OPS_PER_SYMBOL["encode_groups"] * n,
        "decode_groups": DECODE_OPS_BASE * n,
    }
    payload = {}  # the plain encode's payload feeds both decodes
    runs = {
        "lane_totals": (lambda: inp.k1(ke.lane_totals), lambda: inp.k1(ke.lane_totals_ref)),
        "encode_groups": (lambda: inp.k2(ke.encode_groups), lambda: inp.k2(ke.encode_groups_ref)),
        "decode_groups": (lambda: inp.k3(kd.decode_groups, payload["ref"]),
                          lambda: inp.k3(kd.decode_groups_ref, payload["ref"])),
    }
    rows = []
    for k, (kernel, plain_fn) in runs.items():
        plain_ms, want = timed_once(plain_fn)
        got = kernel()
        err = max_abs_err(got, want)
        require(err == 0, f"main shape: {k} differs from its plain version by {err}")
        if k == "encode_groups":
            require(not bool(got[1].any()), "main shape: encode cursor did not end at 0")
            payload["ref"] = want[0]
        del got, want
        ms = cuda_ms(kernel, reps=5)
        b_ms, b_by = bound(traffic[k], ops[k])
        rows.append({"name": k, "route": "cuda", "source": "glz_tpu_torch/csrc/lockstep.cu",
                     "replaces": REPLACES[k], "launches": launches[k], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        print(f"time: {k} {ms:.3f} ms (plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms by "
              f"{b_by}; {traffic[k]} B, {ops[k]} ops) on {card}", flush=True)
    want = inp.sym.view(-1)
    sweep = []
    for tb in TABLE_BITS_SWEEP:
        with patched(kd, TABLE_BITS=tb):
            require(torch.equal(inp.k3(kd.decode_groups, payload["ref"]), want),
                    f"main shape: decode_groups at table_bits {tb} != input")
            sweep.append(f"table_bits {tb}: "
                         f"{cuda_ms(lambda: inp.k3(kd.decode_groups, payload['ref']), 5):.3f}")
    print(f"sweep: decode_groups at the main shape (ms): {'; '.join(sweep)} on {card}",
          flush=True)
    lut_ms = cuda_ms(lambda: decode_table.decode_lut(*inp.tables, cb.min_len, cb.max_len,
                                                     kd.TABLE_BITS), reps=5)
    print(f"time: decode_lut (decode_luts' table built with tensor ops on the card, which "
          f"the kernels build in each block instead) {lut_ms:.3f} ms on {card}", flush=True)
    hist = histogram_bytes(arr)
    bcb = codebook_from_lengths(container.decode_byte_codebook(bf.codebook_blob))
    print(f"table: symbols of the main corpus resolved in one probe: lockstep codebook "
          f"(codes {cb.min_len}-{cb.max_len} bits) {table_shares(cb, hist)}; bitstream "
          f"codebook (codes {bcb.min_len}-{bcb.max_len} bits) {table_shares(bcb, hist)}",
          flush=True)
    del inp, payload, want
    rows += huffword_kernel_times(text, hf, vocabs, hlaunches, dev, card)
    rows += bitstream_kernel_times(arr, bblob, blaunches, dev, card)
    rows += huffword_bitstream_kernel_times(hbblob, vocabs, hblaunches, dev, card)
    regs = [line for line in ptxas_summary(_kernels.build_log())
            if line.startswith(("pack_scan_kernel", "pack_tiles_kernel", "decode_dual_kernel"))]
    print(f"registers (ptxas -v) of the kernels redesigned last: {'; '.join(regs)}", flush=True)

    # ---- 6. pinned digests
    text = (ROOT / "tests" / "fixtures" / "realtext.txt").read_bytes()[: 1 << 20]
    for key, pconf in pinned_configs().items():
        blob = gt.compress(text, conf=pconf)
        digest = hashlib.sha256(blob).hexdigest()
        require(digest == PINNED[key], f"pinned digest {key}: {digest}")
        require(gt.decompress(blob) == text, f"pinned digest {key}: round trip")
    for key, pconf in huffword_pinned_configs().items():
        blob = gt.compress(text, mode=cfg.MODE_HUFFWORD, conf=pconf)
        digest = hashlib.sha256(blob).hexdigest()
        require(digest == HUFFWORD_PINNED[key], f"pinned digest {key}: {digest}")
        require(gt.decompress(blob) == text, f"pinned digest {key}: round trip")
    for key, (pconf, pmode, backend) in bitstream_pinned_configs().items():
        blob = gt.compress(text, mode=pmode, backend=backend, conf=pconf)
        digest = hashlib.sha256(blob).hexdigest()
        require(digest == BITSTREAM_PINNED[key], f"pinned digest {key}: {digest}")
        require(gt.decompress(blob) == text, f"pinned digest {key}: round trip")
    print(f"digests: {', '.join([*PINNED, *HUFFWORD_PINNED, *BITSTREAM_PINNED])} match "
          f"the reference", flush=True)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
