"""The reference's three decoder strategies in glz_tpu_torch against glz_tpu's.

glz_tpu decodes a bitstream container with the strategy `variant` names:
core/host_codec.py's decode_stream_table, decode_stream_bitwalk and
decode_stream_fast (byte mode), and models/huffword.py's
_decode_tokens_host (HuffWord).  The port runs each as a kernel on the card
(csrc/bitstream.cu) beside its plain PyTorch version, which runs here.
Every comparison is exact: the same symbols, or the same exception type.
glz_tpu runs as its own tests run it (JAX on the CPU); the port runs its
plain versions (device='cpu').
"""

import ctypes
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import glz_tpu
from glz_tpu import config as tpu_cfg
from glz_tpu.core import bitio as tpu_bitio
from glz_tpu.core import container as tpu_container
from glz_tpu.core import host_codec
from glz_tpu.core.codebook import build_codebook as tpu_build_codebook
from glz_tpu.core.codebook import canonical_codebook as tpu_canonical_codebook
from glz_tpu.models import huffword as tpu_hw

import chip_smoke
import glz_tpu_torch
from glz_tpu_torch import cli
from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import container
from glz_tpu_torch.core.codebook import codebook_from_lengths
from glz_tpu_torch.models import huffword as port_hw
from glz_tpu_torch.models.canonical_byte import decode_tables
from glz_tpu_torch.models.transfer import i32_tensor
from glz_tpu_torch.ops import _kernels
from glz_tpu_torch.ops import decode as bd
from glz_tpu_torch.ops import decode_table as dt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
STRATEGIES = ("table", "fast", "bitwalk")
# The "at_depth" and "past_depth" codebooks' longest codes sit on either side
# of the levels the byte strategy kernels hold in registers, "limit16" and
# "limit17" on either side of 16 bits.
LIMITS = {"capped": 9, "deep32": 32, "at_depth": chip_smoke.REG_LEVELS,
          "past_depth": chip_smoke.REG_LEVELS + 1, "limit16": 16, "limit17": 17}
BYTE_CASES = ["skewed", "uniform", "two_symbols", "one_symbol", *LIMITS]


# ---- byte mode: each plain strategy against glz_tpu's -------------------------

def byte_case(name: str, n: int = 3000):
    """(symbols, glz_tpu codebook) of a byte case, made from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "skewed":  # the AND of three uniform draws
        sym = rng.integers(0, 256, n) & rng.integers(0, 256, n) & rng.integers(0, 256, n)
    elif name == "uniform":
        sym = rng.integers(0, 256, n)
    elif name == "two_symbols":
        sym = rng.choice([3, 200], n, p=[0.8, 0.2])
    elif name == "one_symbol":
        sym = np.full(n, 42)
    else:  # made-up halving frequencies, symbols drawn evenly, cut to codes of
        # LIMITS[name] bits by a length_limit ("capped" 9, "deep32" 32)
        freqs = np.zeros(256, np.int64)
        freqs[:40] = np.left_shift(1, 40 - np.arange(40))
        limit = LIMITS[name]
        cb = tpu_build_codebook(freqs, limit)
        assert cb.max_len == limit and np.count_nonzero(cb.lengths == limit) > 1
        return rng.integers(0, 40, n), cb
    return sym, tpu_build_codebook(np.bincount(sym, minlength=256), 32)


def port_byte_decode(words: np.ndarray, sbits: np.ndarray, n: int, S: int, lengths,
                     variant: str) -> np.ndarray:
    cb = codebook_from_lengths(lengths)
    starts = torch.from_numpy(np.cumsum(sbits.astype(np.int64)) - sbits.astype(np.int64))
    out = bd.decode_streams(i32_tensor(words, CPU), starts, n, S, *decode_tables(cb, CPU),
                            cb.min_len, cb.max_len, variant=variant, n_codes=cb.symbols.size)
    return out.numpy()


@pytest.mark.parametrize("variant", STRATEGIES)
@pytest.mark.parametrize("S", [1, 7, 4096])
@pytest.mark.parametrize("name", BYTE_CASES)
def test_byte_strategy_matches_glz_tpu(name, S, variant):
    """host_codec.decode_streams(variant=v) and the port's plain decode of
    the same v give the same symbols on host_codec.encode_streams' streams."""
    sym, cb = byte_case(name, 600 if S == 1 else 3000)
    words, _, sbits = host_codec.encode_streams(sym, cb, S)
    want = host_codec.decode_streams(words, sbits, sym.size, S, cb, variant=variant)
    np.testing.assert_array_equal(want, sym)
    got = port_byte_decode(words, sbits, sym.size, S, cb.lengths, variant)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", STRATEGIES)
def test_past_the_payload(variant):
    """A stream that runs past its payload (only a corrupt container's can):
    glz_tpu's bit-walk reads 1 bits there, its other decoders 0 bits; the
    port's strategies read the same.  Two 1-bit codes, 90 symbols on 64
    bits of payload."""
    cb = tpu_canonical_codebook(np.eye(256, dtype=np.int32)[5] + np.eye(256, dtype=np.int32)[9])
    words = np.array([0x0F0F0F0F, 0x12345678], np.uint32)
    want = host_codec.decode_streams(words, np.array([64], np.uint64), 90, 90, cb,
                                     variant=variant)
    assert set(want[64:]) == {9 if variant == "bitwalk" else 5}
    got = port_byte_decode(words, np.array([64], np.uint64), 90, 90, cb.lengths, variant)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["skewed", "two_symbols", *LIMITS])
def test_steps_agree_on_every_window(name):
    """bitwalk_step and fast_step give the canonical scan's length and rank
    on every window of a complete code (sampled: every 2^-16 of the range,
    each slot's ends and a random point)."""
    cb = codebook_from_lengths(byte_case(name)[1].lengths)
    fc, offs, _ = decode_tables(cb, CPU)
    slot = torch.arange(1 << 16) << 16
    rnd = torch.from_numpy(np.random.default_rng(1).integers(0, 1 << 16, slot.numel()))
    v = torch.cat([slot, slot | 0xFFFF, slot | rnd])
    want = dt.canonical_scan(v, fc, offs, cb.min_len, cb.max_len)
    for step in (dt.bitwalk_step, dt.fast_step):
        ln, rank = step(v, fc, offs, cb.min_len, cb.max_len, cb.symbols.size)
        assert torch.equal(ln, want[0]) and torch.equal(rank, want[1])


# ---- the byte strategy kernels' register levels, compiled for the CPU ----------

# csrc/decode_table.cuh's byte strategy decode (glz::ByteLevels, built by
# glz::build_byte_canon as each block builds it) and the loops it replaces
# (decode_untabled), compiled with g++ as single-thread host code.
LEVELS_HARNESS = r"""
#define __device__
#define __host__
#define __forceinline__ inline
#include <cstdint>
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  s &= 31u;
  return s ? hi << s | lo >> (32u - s) : hi;
}
struct Dim { unsigned x; };
static Dim threadIdx{0}, blockDim{1};
inline void __syncthreads() {}
#include "decode_table.cuh"

template <int kStrategy>
static int run(const uint32_t* fc, const uint32_t* offs, uint32_t n_codes, int min_len,
               int max_len, const uint32_t* w, long long n, uint32_t* got, uint32_t* loop) {
  static glz::ByteCanon<kStrategy> t;
  uint32_t symtab[256];
  for (int i = 0; i < 256; ++i) symtab[i] = i;
  glz::build_byte_canon(t, fc, offs, symtab, n_codes, min_len, max_len);
  const glz::ByteLevels<kStrategy> d(t);
  for (long long i = 0; i < n; ++i) {
    const glz::Code c = d.decode(w[i]);
    const glz::Code e = glz::decode_untabled<kStrategy>(t.c, n_codes, w[i]);
    got[3 * i] = c.len, got[3 * i + 1] = c.out, got[3 * i + 2] = c.bad;
    loop[3 * i] = e.len, loop[3 * i + 1] = e.out, loop[3 * i + 2] = e.bad;
  }
  return t.counted;
}

extern "C" int levels_decode(int strategy, const uint32_t* fc, const uint32_t* offs,
                             uint32_t n_codes, int min_len, int max_len, const uint32_t* w,
                             long long n, uint32_t* got, uint32_t* loop) {
  return strategy == glz::kBitwalk
             ? run<glz::kBitwalk>(fc, offs, n_codes, min_len, max_len, w, n, got, loop)
             : run<glz::kFast>(fc, offs, n_codes, min_len, max_len, w, n, got, loop);
}

// The dual strategies' decode (glz::DualLevels, built by glz::build_dual_canon):
// each window under the set of each parity, as a run's parity pairs take it.
template <int kStrategy>
static int run_dual(const uint32_t* fc, const uint32_t* offs, uint32_t n0, uint32_t n1,
                    int min0, int max0, int min1, int max1, const uint32_t* w, long long n,
                    uint32_t* got, uint32_t* loop) {
  static glz::DualCanon<kStrategy> t;
  glz::build_dual_canon(t, fc, offs, min0, max0, min1, max1, n0, n1);
  const glz::DualLevels<kStrategy> d(t);
  for (int p = 0; p < 2; ++p) {
    for (long long i = 0; i < n; ++i) {
      const glz::Code c = p == d.deep_par ? d.deep.decode(w[i]) : d.shallow.decode(w[i]);
      const glz::Code e = glz::decode_untabled<kStrategy>(t.c[p], t.n_codes[p], w[i]);
      const long long j = 3 * (p * n + i);
      got[j] = c.len, got[j + 1] = c.out, got[j + 2] = c.bad;
      loop[j] = e.len, loop[j + 1] = e.out, loop[j + 2] = e.bad;
    }
  }
  return t.counted[0] | t.counted[1] << 1 | t.deep << 2;
}

extern "C" int dual_levels_decode(int strategy, const uint32_t* fc, const uint32_t* offs,
                                  uint32_t n0, uint32_t n1, int min0, int max0, int min1,
                                  int max1, const uint32_t* w, long long n, uint32_t* got,
                                  uint32_t* loop) {
  return strategy == glz::kBitwalk
             ? run_dual<glz::kBitwalk>(fc, offs, n0, n1, min0, max0, min1, max1, w, n, got, loop)
             : run_dual<glz::kFast>(fc, offs, n0, n1, min0, max0, min1, max1, w, n, got, loop);
}
"""
KERNEL_STRATEGIES = {"bitwalk": (1, dt.bitwalk_step), "fast": (2, dt.fast_step)}


@pytest.fixture(scope="module")
def levels_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("levels")
    (d / "harness.cc").write_text(LEVELS_HARNESS)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(_kernels.CSRC), "-o",
                    str(d / "levels.so"), str(d / "harness.cc")], check=True)
    lib = ctypes.CDLL(str(d / "levels.so"))
    P = ctypes.c_void_p
    lib.levels_decode.argtypes = [ctypes.c_int, P, P, ctypes.c_uint32, ctypes.c_int,
                                  ctypes.c_int, P, ctypes.c_longlong, P, P]
    lib.dual_levels_decode.argtypes = [ctypes.c_int, P, P, ctypes.c_uint32, ctypes.c_uint32,
                                       *[ctypes.c_int] * 4, P, ctypes.c_longlong, P, P]
    return lib


def levels_decode(lib, strategy: int, fc, offs, n_codes: int, min_len: int, max_len: int, w):
    """(counted, the register decode's and the loop's (len, out, bad) rows)."""
    fc, offs, w = (np.ascontiguousarray(a, np.uint32) for a in (fc, offs, w))
    got, loop = np.zeros((w.size, 3), np.uint32), np.zeros((w.size, 3), np.uint32)
    counted = lib.levels_decode(strategy, fc.ctypes.data, offs.ctypes.data, n_codes, min_len,
                                max_len, w.ctypes.data, w.size, got.ctypes.data,
                                loop.ctypes.data)
    return counted, got, loop


def edge_windows(fc: np.ndarray, seed: int) -> np.ndarray:
    """Every level's limit and its neighbours, both ends of every 2^-16 of
    the range, and random windows."""
    lim = fc.astype(np.int64)
    slot = np.arange(1 << 16, dtype=np.int64) << 16
    rnd = np.random.default_rng(seed).integers(0, 1 << 32, 1 << 14)
    return (np.concatenate([lim - 1, lim, lim + 1, slot, slot | 0xFFFF, rnd, [0, -1]])
            & 0xFFFFFFFF).astype(np.uint32)


@pytest.mark.parametrize("variant", list(KERNEL_STRATEGIES))
@pytest.mark.parametrize("name", BYTE_CASES)
def test_register_levels_match_the_loop(levels_lib, name, variant):
    """The byte strategy kernels' decode of one code from levels held in
    registers gives what the strategy's loop over every level gives, and
    what its plain step gives, on every window of the codebook's edges:
    for codebooks whose longest code is short of, at and past the
    registers' depth, and past 16 bits."""
    cb = codebook_from_lengths(byte_case(name)[1].lengths)
    fc = cb.first_code_left_justified()
    offs = cb.decode_offsets()
    w = edge_windows(fc, len(name))
    code, step = KERNEL_STRATEGIES[variant]
    counted, got, loop = levels_decode(levels_lib, code, fc, offs, cb.symbols.size, cb.min_len,
                                       cb.max_len, w)
    assert counted == 1  # every encoder's table takes the count
    np.testing.assert_array_equal(got, loop)
    ln, rank = step(torch.from_numpy(w.astype(np.int64)), torch.from_numpy(fc.view(np.int32)),
                    torch.from_numpy(offs.view(np.int32)), cb.min_len, cb.max_len,
                    cb.symbols.size)
    np.testing.assert_array_equal(got[:, 0], ln.numpy())
    np.testing.assert_array_equal(np.where(got[:, 2] == 1, -1, got[:, 1].astype(np.int64)),
                                  rank.numpy())


@pytest.mark.parametrize("variant", list(KERNEL_STRATEGIES))
@pytest.mark.parametrize("order", ["random", "non_increasing"])
def test_register_levels_on_any_table(levels_lib, order, variant):
    """On tables no encoder writes (random limits, in any order or non-
    increasing with bits below their levels), the decode still gives the
    loop's length, rank and flag: such a table runs the loop itself."""
    rng = np.random.default_rng(7 if order == "random" else 8)
    for _ in range(40):
        lo = int(rng.integers(1, 33))
        hi = int(rng.integers(lo, 33))
        fc = rng.integers(0, 1 << 32, 34, dtype=np.uint64).astype(np.uint32)
        if order == "non_increasing":
            fc = np.sort(fc)[::-1]
        offs = rng.integers(0, 1 << 32, 34, dtype=np.uint64).astype(np.uint32)
        _, got, loop = levels_decode(levels_lib, KERNEL_STRATEGIES[variant][0], fc, offs,
                                     int(rng.integers(0, 257)), lo, hi, edge_windows(fc, lo))
        np.testing.assert_array_equal(got, loop)


DUAL_TEXTS = {
    "word_first": b"the cat-sat on its mat. " * 40 + b"a dog, a log; a frog!",
    "nonword_first": b"  ...  " + b"the cat-sat on its mat. " * 40,
    "no_separators": b"word",           # the nonword dictionary is empty
    "no_words": b"  ...,;  !",          # the word dictionary is empty
}


def dual_levels_decode(lib, strategy: int, fc, offs, n_codes, min_lens, max_lens, w):
    """(counted flags | deep parity << 2, the register decode's and the
    loop's (len, out, bad) rows, parity 0's windows then parity 1's)."""
    fc, offs, w = (np.ascontiguousarray(a, np.uint32) for a in (fc, offs, w))
    got, loop = np.zeros((2 * w.size, 3), np.uint32), np.zeros((2 * w.size, 3), np.uint32)
    flags = lib.dual_levels_decode(strategy, fc.ctypes.data, offs.ctypes.data, *n_codes,
                                   min_lens[0], max_lens[0], min_lens[1], max_lens[1],
                                   w.ctypes.data, w.size, got.ctypes.data, loop.ctypes.data)
    return flags, got, loop


def zipf_word_codebook():
    """The HuffWord benchmark's word law (Zipf(1.1) over 20,000 words),
    counted on 2^20 draws: codes of 3-20 bits."""
    r = np.arange(1, 20_001)
    p = r ** -1.1
    ids = np.random.default_rng(20).choice(r.size, 1 << 20, p=p / p.sum())
    return codebook_from_lengths(
        tpu_build_codebook(np.bincount(ids, minlength=r.size), 32).lengths)


def dual_codebooks(name: str):
    """(even, odd) codebooks of a dual register-levels case."""
    if name in DUAL_TEXTS:
        blob = glz_tpu_torch.compress(DUAL_TEXTS[name], mode=cfg.MODE_HUFFWORD, device="cpu")
        word_first, cb_w, cb_n, _, _ = port_hw.huffword_state_from_blob(
            container.read_container(blob).codebook_blob)
        return (cb_w, cb_n) if word_first else (cb_n, cb_w)
    if name == "zipf20":
        cb = zipf_word_codebook()
        assert (cb.min_len, cb.max_len) == (3, 20)
        sep = codebook_from_lengths(tpu_build_codebook(np.array([50, 30, 10, 5, 1]), 32).lengths)
        return cb, sep
    _, word_first, cbs, _, _, _ = chip_smoke.huffword_bitstream_case(name)
    cb_w, cb_n = (codebook_from_lengths(cb.lengths) for cb in cbs)
    return (cb_w, cb_n) if word_first else (cb_n, cb_w)


DUAL_LEVEL_CASES = [*DUAL_TEXTS, "zipf20", *chip_smoke.HUFFWORD_SEAM_LIMITS, "hw_deep32_s999"]


@pytest.mark.parametrize("variant", list(KERNEL_STRATEGIES))
@pytest.mark.parametrize("name", DUAL_LEVEL_CASES)
def test_dual_register_levels_match_the_loop(levels_lib, name, variant):
    """The dual strategy kernels' decode of one code from either set's
    register levels (the deep set's or the shallow set's, as a run's parity
    pairs take them) gives what the strategy's loop gives under the codebook
    of that parity, on every window of both codebooks' edges: the
    codebooks of DUAL_TEXTS (an empty dictionary among them), a Zipf word
    codebook of 3-20 bits, the seam cases' (longest codes at and one bit
    past each set's depth) and a 32-bit one."""
    even, odd = dual_codebooks(name)
    fc, offs = (np.stack([f(cb) for cb in (even, odd)]) for f in
                (lambda cb: cb.first_code_left_justified(), lambda cb: cb.decode_offsets()))
    w = np.concatenate([edge_windows(fc[0], len(name)), edge_windows(fc[1], len(name) + 1)])
    flags, got, loop = dual_levels_decode(levels_lib, KERNEL_STRATEGIES[variant][0], fc, offs,
                                          (even.symbols.size, odd.symbols.size),
                                          (even.min_len, odd.min_len),
                                          (even.max_len, odd.max_len), w)
    np.testing.assert_array_equal(got, loop)
    sets = (even, odd)
    assert flags >> 2 == int(odd.max_len > even.max_len)  # the deep set: the longer codes
    for p, cb in enumerate(sets):
        rows = got[p * w.size:(p + 1) * w.size]
        if cb.max_len == 0:  # an empty dictionary: never counted; every code 1 bit, flagged
            assert not flags >> p & 1
            assert (rows[:, 0] == 1).all() and (rows[:, 2] == 1).all()
        else:  # every encoder's table takes the count
            assert flags >> p & 1
            assert rows[:, 0].min() >= 1
    if name in chip_smoke.HUFFWORD_SEAM_LIMITS:
        deep, shallow = sorted((even.max_len, odd.max_len), reverse=True)
        assert (deep, shallow) == chip_smoke.HUFFWORD_SEAM_LIMITS[name]


@pytest.mark.parametrize("variant", list(KERNEL_STRATEGIES))
@pytest.mark.parametrize("order", ["random", "non_increasing"])
def test_dual_register_levels_on_any_table(levels_lib, order, variant):
    """On pairs of tables no encoder writes (random limits, in any order or
    non-increasing with bits below their levels; an empty (0, 0) set among
    them), each set's decode still gives the loop's length, rank and flag."""
    rng = np.random.default_rng(17 if order == "random" else 18)
    for trial in range(30):
        lo, hi = [], []
        for _ in range(2):
            a = int(rng.integers(1, 33))
            b = int(rng.integers(a, 33))
            lo.append(a)
            hi.append(b)
        if trial % 5 == 0:  # an empty dictionary's codebook
            lo[trial % 2], hi[trial % 2] = 0, 0
        fc = rng.integers(0, 1 << 32, (2, 34), dtype=np.uint64).astype(np.uint32)
        if order == "non_increasing":
            fc = np.sort(fc, axis=1)[:, ::-1]
        offs = rng.integers(0, 1 << 32, (2, 34), dtype=np.uint64).astype(np.uint32)
        n_codes = tuple(int(x) for x in rng.integers(0, 1 << 32, 2, dtype=np.uint64))
        w = np.concatenate([edge_windows(fc[0], trial), edge_windows(fc[1], trial + 1)])
        _, got, loop = dual_levels_decode(levels_lib, KERNEL_STRATEGIES[variant][0], fc, offs,
                                          n_codes, lo, hi, w)
        np.testing.assert_array_equal(got, loop)
        assert got[:, 0].min() >= 1


@pytest.mark.parametrize("case", list(chip_smoke.SEAM_LIMITS))
def test_seam_cases_on_the_cpu(case):
    """chip_smoke.py's phase-3c cases at the register levels' seams (longest
    codes on either side of the depth and of 16 bits) hold their codebook's
    limit, and round-trip through each strategy's plain decode as the card's
    check runs them (check_strategy_case on CPU tensors)."""
    sym, n_valid, S, cb = chip_smoke.bitstream_case_data(case)
    assert cb.max_len == chip_smoke.SEAM_LIMITS[case] and n_valid > 4 * S
    chip_smoke.check_strategy_case(case, CPU)


@pytest.mark.parametrize("case", list(chip_smoke.HUFFWORD_SEAM_LIMITS))
def test_huffword_seam_cases_on_the_cpu(case):
    """chip_smoke.py's HuffWord cases at the dual register levels' seams
    (the word set's longest code at and one bit past kDeepLevels, the
    separators' at and past kShallowLevels, words on either parity) hold
    those limits, and round-trip through each strategy's plain decode as
    the card's check runs them."""
    ids, word_first, cbs, _, _, S = chip_smoke.huffword_bitstream_case(case)
    assert (cbs[0].max_len, cbs[1].max_len) == chip_smoke.HUFFWORD_SEAM_LIMITS[case]
    assert ids.size > 2 * S
    chip_smoke.check_strategy_case(case, CPU)


# ---- HuffWord: the dual plain strategies against _decode_tokens_host ----------

@pytest.mark.parametrize("variant", STRATEGIES)
@pytest.mark.parametrize("name", list(DUAL_TEXTS))
def test_dual_strategy_matches_glz_tpu(name, variant):
    """A glz_tpu-written HuffWord bitstream container's tokens through
    _decode_tokens_host(variant=v) and through the port's dual plain decode
    of the same v (ranks mapped through each dictionary's symbols)."""
    blob = glz_tpu.compress(DUAL_TEXTS[name], mode=cfg.MODE_HUFFWORD,
                            conf=tpu_cfg.GlzConfig(stream_symbols=7))
    f = tpu_container.read_container(blob)
    mv = memoryview(f.codebook_blob)
    word_first = bool(mv[0])
    wl, _, _, off = tpu_hw._decode_dict_blob(mv, 1)
    nl, _, _, _ = tpu_hw._decode_dict_blob(mv, off)
    assert word_first == (name not in ("nonword_first", "no_words"))
    assert (wl.size == 0) == (name == "no_words") and (nl.size == 0) == (name == "no_separators")
    cbs = [tpu_canonical_codebook(lens if lens.size else np.zeros(1, np.int32)) for lens in (wl, nl)]
    dicts = cbs if word_first else cbs[::-1]
    words = tpu_bitio.bytes_to_words(f.payload)
    T = f.n_symbols
    want = tpu_hw._decode_tokens_host(words, f.stream_bits, T, f.stream_symbols, dicts,
                                      variant=variant)

    port_dicts = [codebook_from_lengths(lens) for lens in (wl, nl)]
    even, odd = port_dicts if word_first else port_dicts[::-1]
    fc, offs = port_hw._dual_tables(even, odd, CPU)
    sb = f.stream_bits.astype(np.int64)
    ranks = bd.decode_streams_dual(i32_tensor(words, CPU), torch.from_numpy(np.cumsum(sb) - sb),
                                   T, f.stream_symbols, fc, offs, (even.min_len, odd.min_len),
                                   (even.max_len, odd.max_len), variant=variant,
                                   n_codes=(even.symbols.size, odd.symbols.size)).numpy()
    ranks = ranks.view(np.uint32).astype(np.int64)
    syms = [np.append(d.symbols, 0) for d in (even, odd)]  # an empty dictionary: no rank
    got = np.where(np.arange(T) % 2 == 0, syms[0][np.minimum(ranks, syms[0].size - 1)],
                   syms[1][np.minimum(ranks, syms[1].size - 1)])
    np.testing.assert_array_equal(got, want)


# ---- the front door: glz_tpu's routing --------------------------------------------

FRONT_TEXT = b"the cat-sat on its mat. " * 500


@pytest.fixture(scope="module")
def containers():
    """glz_tpu's containers of FRONT_TEXT: (blob, form of its stream decode:
    "bytes", "dual" or None where the layout or mode has none)."""
    lock = tpu_cfg.GlzConfig(layout=tpu_cfg.LAYOUT_LOCKSTEP, stream_symbols=64)
    return {
        "byte_host": (glz_tpu.compress(FRONT_TEXT), "bytes"),
        "byte_device": (glz_tpu.compress(FRONT_TEXT, backend="device"), "bytes"),
        "byte_lockstep": (glz_tpu.compress(FRONT_TEXT, conf=lock), None),
        "huffword": (glz_tpu.compress(FRONT_TEXT, mode=cfg.MODE_HUFFWORD), "dual"),
        "huffword_lockstep": (glz_tpu.compress(FRONT_TEXT, mode=cfg.MODE_HUFFWORD, conf=lock),
                              None),
        "normal_tree": (glz_tpu.compress(FRONT_TEXT, mode=cfg.MODE_NORMAL_TREE), None),
    }


def routed(form, backend: str, variant: str):
    """The stream decode glz_tpu runs for the call, as (form, strategy), or
    None: none runs (or it raises first)."""
    if form == "bytes":
        if backend == "device" or variant == "device":
            return "bytes", "table"
        return ("bytes", variant) if variant in STRATEGIES else None
    if form == "dual":
        return "dual", variant if variant in ("fast", "bitwalk") else "table"
    return None


def outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 (the type is the outcome)
        return type(e)


@pytest.mark.parametrize("variant", [*STRATEGIES, "device", "bogus"])
@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("kind", ["byte_host", "byte_device", "byte_lockstep", "huffword",
                                  "huffword_lockstep", "normal_tree"])
def test_decompress_routes_as_glz_tpu(containers, monkeypatch, kind, backend, variant):
    """glz_tpu_torch.decompress(blob, backend=b, variant=v, device='cpu')
    gives what glz_tpu.decompress(blob, backend=b, variant=v) gives (the
    bytes, or the same exception type), through the strategy glz_tpu
    routes the call to: the plain decode that ran, recorded, is the routed
    one."""
    blob, form = containers[kind]
    ran = []
    for name, tag, at in (("decode_streams_ref", "bytes", 9),
                          ("decode_streams_dual_ref", "dual", 8)):
        plain = getattr(bd, name)
        monkeypatch.setattr(bd, name, lambda *a, _p=plain, _t=tag, _at=at, **k:
                            ran.append((_t, a[_at] if len(a) > _at else k.get("variant")))
                            or _p(*a, **k))
    want = outcome(lambda: glz_tpu.decompress(blob, backend=backend, variant=variant))
    got = outcome(lambda: glz_tpu_torch.decompress(blob, backend=backend, variant=variant,
                                                   device="cpu"))
    assert got == want
    if want == FRONT_TEXT:
        assert ran == ([] if routed(form, backend, variant) is None
                       else [routed(form, backend, variant)])
    else:  # glz_tpu's host decode of a byte bitstream container refuses the variant
        assert form == "bytes" and (backend, variant) == ("host", "bogus")
        assert got is ValueError


@pytest.mark.parametrize("variant", STRATEGIES)
def test_one_symbol_container(variant):
    """A one-symbol container (one 1-bit code; the host container pads its
    last byte with 1 bits, which match no codeword) decodes in both
    packages: a guess that meets a code matching nothing is no error."""
    data = b"a" * 3001
    for backend in ("host", "device"):
        blob = glz_tpu.compress(data, backend=backend)
        assert glz_tpu.decompress(blob, variant=variant) == data
        assert glz_tpu_torch.decompress(blob, variant=variant, device="cpu") == data


# ---- a code that matches no codeword ------------------------------------------

@pytest.mark.parametrize("variant", ["fast", "bitwalk"])
def test_no_codeword_raises(variant):
    """One symbol (the 1-bit code 0) and a stream of 1 bits: glz_tpu's
    strategy indexes past its symbols (numpy's IndexError); the port's
    plain version and its wrapper raise ValueError("corrupt stream: no
    codeword matched"), the byte and the dual form."""
    cb = tpu_canonical_codebook(np.eye(256, dtype=np.int32)[97])
    words = np.full(4, 0xFFFFFFFF, np.uint32)
    with pytest.raises(IndexError):
        host_codec.decode_streams(words, np.array([128], np.uint64), 100, 128, cb,
                                  variant=variant)
    with pytest.raises(ValueError, match="no codeword matched"):
        port_byte_decode(words, np.array([128], np.uint64), 100, 128, cb.lengths, variant)
    port_cb = codebook_from_lengths(cb.lengths)
    fc, offs = port_hw._dual_tables(port_cb, port_cb, CPU)
    with pytest.raises(ValueError, match="no codeword matched"):
        bd.decode_streams_dual(i32_tensor(words, CPU), torch.zeros(1, dtype=torch.int64), 100,
                               128, fc, offs, (1, 1), (1, 1), variant=variant, n_codes=(1, 1))


@pytest.mark.parametrize("variant", ["fast", "bitwalk"])
def test_corrupt_container_raises(variant):
    """A one-symbol container whose payload is all 1 bits: both packages
    raise (glz_tpu IndexError, the port ValueError) where the table decodes."""
    blob = bytearray(glz_tpu.compress(b"a" * 1000))
    f = container.read_container(bytes(blob))
    start = len(blob) - len(f.payload)
    assert f.checksum is None and blob[start:] == f.payload
    blob[start:] = b"\xff" * len(f.payload)
    with pytest.raises(IndexError):
        glz_tpu.decompress(bytes(blob), variant=variant)
    with pytest.raises(ValueError, match="no codeword matched"):
        glz_tpu_torch.decompress(bytes(blob), variant=variant, device="cpu")


def test_wrappers_take_only_known_strategies():
    cb = codebook_from_lengths(byte_case("skewed")[1].lengths)
    args = (torch.zeros(4, dtype=torch.int32), torch.zeros(1, dtype=torch.int64), 8, 8,
            *decode_tables(cb, CPU), cb.min_len, cb.max_len)
    with pytest.raises(ValueError, match="unknown decoder variant"):
        bd.decode_streams(*args, variant="device")
    with pytest.raises(ValueError, match="n_codes"):
        bd.decode_streams(*args, variant="fast")


# ---- the command line -------------------------------------------------------

@pytest.mark.parametrize("model", ["canonical_byte", "huffword", "normal_tree"])
def test_cli_decoder_bitwalk(tmp_path, monkeypatch, model):
    """compress, then decompress --decoder bitwalk under GLZ_PLATFORM=cpu:
    the input back, and glz_tpu's decompress of the same container agrees."""
    monkeypatch.setenv("GLZ_PLATFORM", "cpu")
    src = tmp_path / "f.txt"
    src.write_bytes(FRONT_TEXT[:5000])
    assert cli.main(["compress", str(src), "--model", model]) == 0
    glz = tmp_path / "f.txt.glz"
    assert cli.main(["decompress", str(glz), "--decoder", "bitwalk"]) == 0
    assert (tmp_path / "f.txt.glz.de").read_bytes() == src.read_bytes()
    assert glz_tpu.decompress(glz.read_bytes(), variant="bitwalk") == src.read_bytes()


def test_cli_names_the_strategies(capsys):
    """decompress --help names every strategy and says what each does."""
    with pytest.raises(SystemExit):
        cli.main(["decompress", "--help"])
    help_text = " ".join(capsys.readouterr().out.split())
    for words in ("table", "fast", "bitwalk", "device", "one bit at a time", "32-bit window"):
        assert words in help_text


def test_cli_module_decoder_fast(tmp_path):
    """python -m glz_tpu_torch.cli decompress --decoder fast round-trips a
    file on the CPU."""
    root = str(pathlib.Path(__file__).resolve().parents[1])
    src = tmp_path / "g.txt"
    src.write_bytes(FRONT_TEXT[:3000])
    (tmp_path / "g.glz").write_bytes(glz_tpu_torch.compress(src.read_bytes(), device="cpu"))
    done = subprocess.run([sys.executable, "-m", "glz_tpu_torch.cli", "decompress", "g.glz",
                           "--decoder", "fast"], capture_output=True, text=True,
                          cwd=str(tmp_path),
                          env={**os.environ, "GLZ_PLATFORM": "cpu", "PYTHONPATH": root})
    assert done.returncode == 0, done.stderr
    assert (tmp_path / "g.glz.de").read_bytes() == src.read_bytes()
