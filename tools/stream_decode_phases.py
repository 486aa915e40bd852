#!/usr/bin/env python3
"""Time the phases of the stream decodes (byte and dual) apart on one CUDA
card.

    python3 tools/stream_decode_phases.py      # from the repository root
    python3 tools/stream_decode_phases.py --strategies [--parent DIR]

csrc/bitstream.cu's decode_streams_sync_kernel (both forms) decodes each
stream's
subsequences three times: a guess from each subsequence's first bit, the
synchronisation rounds (each restarts the subsequences whose start differs
from their predecessor's exit), and the write.  This script builds
bitstream.cu in variants that each leave phases out (by editing a copy of
the source, so the kernel's code stays that of the repository) and times
each at the byte main path's shape (512 MiB of the benchmark corpus under
DEFAULT: 2,048 streams of 2^18 symbols) with CUDA events:

  full        the kernel as it is (checked against the input)
  no_write    the write pass left out
  guess_only  the synchronisation rounds and the write pass left out
  no_piece_store  the write pass's whole 16-byte stores folded into one
              register (stored once a run)

so the write costs full - no_write, its 16-byte stores full -
no_piece_store, and the rounds no_write - guess_only.  Another build
counts the synchronisation rounds, the restarted subsequences and those
that landed on their guess's meeting point.  The sweep runs at each table
size and subsequence length of chip_smoke.py's sweep, and at MEET_AT over
the meeting distances of MEET_SWEEP.  Then the same for the dual
(HuffWord) form at the HuffWord bitstream path's shape (100 MiB of word
text, 2,991 streams of 16,384 tokens), checked against its plain version:
the phases at the kernel's table size across the swept subsequence lengths
and at its subsequence length across the swept table sizes, and the
meeting distances at DUAL_MEET_AT.  Both forms share the template, so one
set of builds serves both.

--strategies times the bit-walk and fast kernels instead (the same
template, kStrategy kBitwalk and kFast), byte and dual (--form), each at
its main path's shape (the dual one at the HuffWord bitstream shape above):
full, no_write and guess_only of each, and a counting build (levels):
per code decoded (guesses, rounds and the write), the levels its lane
walks (the bit-walk's len, the fast scan's len - min_len + 1), the levels
its warp runs on that code step (the largest of the lanes that step
together), the lanes that step together, and for each depth k of
LEVEL_DEPTHS the share of codes longer than k and of warp steps with such
a code.  The dual form's counting build counts each codebook's codes apart
(the word set and the separators', told apart by their longest code):
the levels a lane walks, the lanes of one set that step together and the
most levels among them, the levels the whole warp runs a step (its lanes
on either set), and for each depth of DUAL_DEPTHS the share of codes
longer than it and of steps with such a code.  It prints each build's
registers and spills (ptxas -v).  Then the candidates, each timed whole
and checked against the input (the tokens' ranks): for the byte form
CANDIDATES, the source with other levels held in registers
(decode_table.cuh's kRegLevels), the strategy kernels at fewer blocks an
SM (more registers a thread), and the designs that lost (the count as a
compare, the accumulation as a shift and a merge, the first design that
had both, the limits packed two to a register); for the dual form
DUAL_CANDIDATES, the deep and the shallow set's register levels
(kDeepLevels, kShallowLevels), the blocks an SM (kDualStrategyBlocks), one
depth for both sets, the runs inlined (the first design), and the
bit-walk's code taken whole each level.
--parent DIR also builds the csrc/ directory DIR (another commit's; its
phases and counting build, no candidates) and times it the same way in
the same process, parent and source in turns.
The counting builds' edits are anchored on lines every csrc/ since the
register levels has (CODE_OUT, CHECKED), so they build for --parent too.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import glz_tpu_torch as gt  # noqa: E402
from glz_tpu_torch import config as cfg  # noqa: E402
from glz_tpu_torch.core import bitio, container  # noqa: E402
from glz_tpu_torch.core.codebook import codebook_from_lengths  # noqa: E402
from glz_tpu_torch.models.canonical_byte import decode_tables  # noqa: E402
from glz_tpu_torch.models.transfer import i32_tensor  # noqa: E402
from glz_tpu_torch.core.codebook import build_codebook  # noqa: E402
from glz_tpu_torch.ops import _kernels  # noqa: E402
from glz_tpu_torch.ops import decode as bd  # noqa: E402
from glz_tpu_torch.utils import tokenizer as tok  # noqa: E402

MEET_SWEEP = (32, 64, 128, 256)
MEET_AT = (11, 1024)  # (table_bits, T) of the meeting-distance sweep
DUAL_MEET_AT = (bd.DUAL_TABLE_BITS, bd.DUAL_SUBSEQ_BITS)  # the same for the dual decode

WRITE = "          if (c > 0)\n            write_run("
SYNC = "      // ---- 2. synchronise\n      for (;;) {"
ROUND_END = "        if (!__syncthreads_or(changed)) break;"
MET = "              if (state(pos, par) == meet) {"
QUEUE = "  uint32_t acc = 0u, q0 = 0u, q1 = 0u, q2 = 0u;  // the word being filled; the piece's words"
PIECE = "          *reinterpret_cast<uint4*>(out + g - 15) = make_uint4(q0, q1, q2, acc);"
TAIL = "  if (g & 15) {  // the last piece: its whole words are the queue's last ones"
QUEUE_DUAL = "  uint32_t q0 = 0u, q1 = 0u, q2 = 0u;  // the piece's ranks so far"
PIECE_DUAL = "        *reinterpret_cast<uint4*>(out + g - 3) = make_uint4(q0, q1, q2, rank);"
TAIL_DUAL = "  const int w = static_cast<int>(g & 3);  // the last piece's ranks: the queue's last w"
MEET_BITS = "constexpr int kMeetBits = 128;"
# the byte strategy decode's output step (the same in every version since
# the strategies' port): where the counting build counts each code
CODE_OUT = "  c.out = t.symtab[c.out & 255u];\n  return c;\n"
LEVEL_DEPTHS = tuple(range(8, 17))
BYTE_STRATEGIES = {"bitwalk": 1, "fast": 2}  # decode_table.cuh: kBitwalk, kFast
# the canonical check every dual strategy code ends in (decode_table.cuh; the
# same in every version since the strategies' port): where the dual counting
# build counts each code
CHECKED = ("__device__ __forceinline__ Code checked(const Canon& c, uint32_t n_codes, uint32_t v,\n"
           "                                        int len) {\n")
DUAL_DEPTHS = tuple(range(8, 21))
# Edits of decode_table.cuh's register levels, each a design that lost
# (PERF.md).  COUNT_LINE and ACC_LINE are the source's.
COUNT_LINE = ("      len += ((kStrategy == kBitwalk ? acc : w >> 1) - lim[l - 1]) >> 31;"
              "  // [x_l < lim[l]]")
ACC_LINE = ("      if (kStrategy == kBitwalk) acc = __funnelshift_l(w << (l - 1), acc, 1);"
            "  // acc << 1 | bit")
FAST_LIMIT = "  return kStrategy == kBitwalk ? fc[l] >> ((32 - l) & 31) : fc[l] >> 1;"
# the count as a compare and an add (what the compiler makes a compare, an
# add and a predicated move, two of them on the count's chain)
COMPARE_COUNT = ((COUNT_LINE, "      len += (kStrategy == kBitwalk ? acc : w >> 1) < lim[l - 1]"
                              " ? 1 : 0;"),)
# acc << 1 | bit written out, which the compiler makes a shift off acc's
# chain and a shift and a merge on it
SHIFT_OR_ACC = ((ACC_LINE, "      if (kStrategy == kBitwalk) acc = acc << 1 | ((w >> (32 - l))"
                           " & 1u);"),)
# the first design: both of the above, the fast scan comparing v with fc[l]
FIRST_DESIGN = (
    (FAST_LIMIT, "  return kStrategy == kBitwalk ? fc[l] >> ((32 - l) & 31) : fc[l];"),
    (COUNT_LINE, "      len += (kStrategy == kBitwalk ? acc : w) < lim[l - 1] ? 1 : 0;"),
    *SHIFT_OR_ACC)
# the bit-walk's accumulated code taken whole at each level (w >> (32 - l),
# the value acc << 1 | bit reaches), not a bit a level: what the
# accumulation costs
SHIFT_ACC = ((ACC_LINE, "      if (kStrategy == kBitwalk) acc = w >> (32 - l);"),)
# the limits packed two to a register (16 bits; levels up to 16, an even
# count): the fast scan compares v >> 16 with fc[l] >> 16
PACKED = (
    (FAST_LIMIT, "  return kStrategy == kBitwalk ? fc[l] >> ((32 - l) & 31) : fc[l] >> 16;"),
    ("  uint32_t lim[kRegLevels];\n  uint32_t n_codes;",
     "  uint32_t lim[kRegLevels / 2];\n  uint32_t n_codes;"),
    ("    for (int l = 0; l < kRegLevels; ++l) lim[l] = b.lim[l];",
     "    for (int l = 0; l < kRegLevels / 2; ++l) lim[l] = b.lim[2 * l] | b.lim[2 * l + 1] << 16;"),
    (COUNT_LINE, "      len += ((kStrategy == kBitwalk ? acc : w >> 16) -\n"
                 "              ((l & 1) ? lim[(l - 1) / 2] & 0xFFFFu : lim[(l - 1) / 2] >> 16))"
                 " >> 31;"))
# bitstream.cu's byte launch: the strategy kernels at b blocks an SM
# (their registers 65536 / (256 b), where the table stays at 4)
BYTE_LAUNCH = "  decode_streams_sync_kernel<false, kSyncThreads, kSyncSubs, 4, kStrategy>"


def blocks(b: int) -> tuple[tuple[str, str], ...]:
    return ((BYTE_LAUNCH, "  decode_streams_sync_kernel<false, kSyncThreads, kSyncSubs, "
                          f"kStrategy == glz::kTable ? 4 : {b}, kStrategy>"),)


# Edits of the dual strategies' source, each a candidate of --strategies:
# decode_span's (guesses' and rounds') and write_run's parity-pair runs
# inlined at every call site (8 and 2 copies) where the source calls one
# function each; the bit-walk's accumulated code taken whole at each level
# (w >> (32 - l), not a bit a level: what the accumulation costs)
SPAN = "__device__ __noinline__ int64_t decode_span(const glz::DualCanon<kStrategy>& t,"
WRITE_DUAL = ("__device__ __noinline__ void write_run(const glz::DualCanon<kStrategy>& t, "
              "const uint8_t*,")
INLINE_SPAN = ((SPAN, SPAN.replace("__noinline__", "__forceinline__")),)
INLINE_RUNS = INLINE_SPAN + ((WRITE_DUAL, WRITE_DUAL.replace("__noinline__",
                                                            "__forceinline__")),)
PREFIX_ACC = (("      if (kStrategy == kBitwalk) acc = __funnelshift_l(w << l, acc, 1);",
               "      if (kStrategy == kBitwalk) acc = w >> (31 - l);"),)
# The dual candidates of --strategies: (constants set, edits made).  The
# constants: the deep set's register levels (kDeepLevels: other depths), the
# shallow set's (kShallowLevels), and blocks an SM of the dual strategy
# kernels (kDualStrategyBlocks); "both": (a), one depth for both sets; the
# first design, every run inlined (at 20 levels, 4 and 6 blocks); the
# bit-walk's code taken whole at each level.
DUAL_CANDIDATES = {
    **{f"deep{d}": ({"kDeepLevels": d}, ()) for d in (12, 14, 16, 20)},
    **{f"blocks{b}_dual": ({"kDualStrategyBlocks": b}, ()) for b in (6, 8)},
    **{f"shallow{k}": ({"kShallowLevels": k}, ()) for k in (2, 4)},
    "both18_blocks6": ({"kShallowLevels": 18, "kDualStrategyBlocks": 6}, ()),
    "inline_runs": ({"kDeepLevels": 20, "kShallowLevels": 4, "kDualStrategyBlocks": 6},
                    INLINE_RUNS),
    "inline_span": ({}, INLINE_SPAN),
    "prefix_acc": ({}, PREFIX_ACC),
}


# The candidates of --strategies, each the source with decode_table.cuh's
# kRegLevels set (where given) and these edits made.
CANDIDATES = {
    **{f"regs{k}": (k, ()) for k in (8, 10, 14, 16)},
    **{f"blocks{b}": (None, blocks(b)) for b in (2, 3)},
    **{f"regs{k}_blocks3": (k, blocks(3)) for k in (10, 14)},
    "compare_count": (None, COMPARE_COUNT),
    "shift_or_acc": (None, SHIFT_OR_ACC),
    "first_design": (None, FIRST_DESIGN),
    "first_design_blocks3": (None, FIRST_DESIGN + blocks(3)),
    "shift_acc": (None, SHIFT_ACC),
    **{f"packed{k}": (k, PACKED) for k in (12, 16)},
    **{f"packed{k}_blocks3": (k, PACKED + blocks(3)) for k in (12, 16)},
}
LEVEL_COUNTER = """
// counts[0..3]: codes, their lanes' levels, warp steps, the warps' levels;
// [4 + i]: warp steps with a code longer than LEVEL_DEPTHS[i]; [4 + n + i]:
// such codes
__device__ unsigned long long probe_levels_counts[4 + 2 * %(n)d];
__device__ __forceinline__ void probe_levels(uint32_t len, int min_len, bool bitwalk) {
  const unsigned mask = __activemask();
  const unsigned lv = bitwalk ? len : len - static_cast<unsigned>(min_len) + 1u;
  const unsigned top = __reduce_max_sync(mask, lv);
  const unsigned deepest = __reduce_max_sync(mask, len);
  const unsigned sum = __reduce_add_sync(mask, lv);
  unsigned past[%(n)d];
#pragma unroll
  for (int i = 0; i < %(n)d; ++i) past[i] = __popc(__ballot_sync(mask, len > %(k0)d + i));
  if ((threadIdx.x & 31) == static_cast<unsigned>(__ffs(mask) - 1)) {
    atomicAdd(&probe_levels_counts[0], static_cast<unsigned long long>(__popc(mask)));
    atomicAdd(&probe_levels_counts[1], static_cast<unsigned long long>(sum));
    atomicAdd(&probe_levels_counts[2], 1ull);
    atomicAdd(&probe_levels_counts[3], static_cast<unsigned long long>(top));
    for (int i = 0; i < %(n)d; ++i) {
      if (deepest > %(k0)d + i) atomicAdd(&probe_levels_counts[4 + i], 1ull);
      atomicAdd(&probe_levels_counts[4 + %(n)d + i], static_cast<unsigned long long>(past[i]));
    }
  }
}
extern "C" void probe_levels_take(unsigned long long* out) {
  unsigned long long zero[4 + 2 * %(n)d] = {};
  cudaMemcpyFromSymbol(out, probe_levels_counts, sizeof(zero));
  cudaMemcpyToSymbol(probe_levels_counts, zero, sizeof(zero));
}
""" % {"n": len(LEVEL_DEPTHS), "k0": LEVEL_DEPTHS[0]}
DUAL_LEVEL_COUNTER = """
// the dual counting build: per codebook (binned by its longest code), [0]
// codes, [1] their bit-walk levels (len), [2] their fast-scan levels (len -
// min_len + 1), [3] steps of the set's lanes that step together, [4] their
// longest len a step, [5 + i] codes longer than DUAL_DEPTHS[i], [5 + n + i]
// steps with such a code; then the warp's steps, its longest len a step and
// its most fast-scan levels a step
constexpr int kProbeBins = 34;
constexpr int kProbePer = 5 + 2 * %(n)d;
__device__ unsigned long long probe_dual_counts[kProbeBins * kProbePer + 3];
__device__ __forceinline__ void probe_dual(const Canon& c, int len) {
  const unsigned mask = __activemask();
  const unsigned bw = static_cast<unsigned>(len);
  const unsigned fs = static_cast<unsigned>(len - c.min_len + 1);
  const unsigned group = __match_any_sync(mask, c.max_len);
  const unsigned top = __reduce_max_sync(group, bw);
  const unsigned sum_bw = __reduce_add_sync(group, bw);
  const unsigned sum_fs = __reduce_add_sync(group, fs);
  const unsigned wtop = __reduce_max_sync(mask, bw);
  const unsigned wtop_fs = __reduce_max_sync(mask, fs);
  unsigned past[%(n)d];
#pragma unroll
  for (int i = 0; i < %(n)d; ++i) past[i] = __popc(__ballot_sync(group, bw > %(k0)d + i));
  const int lane = static_cast<int>(threadIdx.x & 31);
  if (lane == __ffs(group) - 1) {
    unsigned long long* b = probe_dual_counts + c.max_len * kProbePer;
    atomicAdd(&b[0], static_cast<unsigned long long>(__popc(group)));
    atomicAdd(&b[1], static_cast<unsigned long long>(sum_bw));
    atomicAdd(&b[2], static_cast<unsigned long long>(sum_fs));
    atomicAdd(&b[3], 1ull);
    atomicAdd(&b[4], static_cast<unsigned long long>(top));
    for (int i = 0; i < %(n)d; ++i) {
      if (top > %(k0)d + i) atomicAdd(&b[5 + i], 1ull);
      atomicAdd(&b[5 + %(n)d + i], static_cast<unsigned long long>(past[i]));
    }
  }
  if (lane == __ffs(mask) - 1) {
    unsigned long long* w = probe_dual_counts + kProbeBins * kProbePer;
    atomicAdd(&w[0], 1ull);
    atomicAdd(&w[1], static_cast<unsigned long long>(wtop));
    atomicAdd(&w[2], static_cast<unsigned long long>(wtop_fs));
  }
}
extern "C" void probe_dual_levels_take(unsigned long long* out) {
  static unsigned long long zero[kProbeBins * kProbePer + 3] = {};
  cudaMemcpyFromSymbol(out, probe_dual_counts, sizeof(zero));
  cudaMemcpyToSymbol(probe_dual_counts, zero, sizeof(zero));
}
""" % {"n": len(DUAL_DEPTHS), "k0": DUAL_DEPTHS[0]}
COUNTER = """
extern "C" unsigned long long probe_take(int which) {
  unsigned long long r[3], zero[3] = {0, 0, 0};
  cudaMemcpyFromSymbol(r, probe_counts, sizeof(r));
  cudaMemcpyToSymbol(probe_counts, zero, sizeof(zero));
  return r[which];
}
"""


def variants(src: str) -> dict[str, str]:
    for marker in (WRITE, SYNC, ROUND_END, MET, MEET_BITS, QUEUE, PIECE, TAIL, QUEUE_DUAL,
                   PIECE_DUAL, TAIL_DUAL):
        if src.count(marker) != 1:
            raise RuntimeError(f"bitstream.cu no longer has the probe's marker:\n{marker}")
    no_write = src.replace(WRITE, "          if (c < 0 && c > 0)\n            write_run(")
    # counts: rounds that changed a start, restarted subsequences, and those
    # whose new chain landed on the guess's meeting point
    counted = src.replace(ROUND_END, ROUND_END + "\n        if (threadIdx.x == 0) "
                          "atomicAdd(&probe_counts[0], 1ull);")
    counted = counted.replace(MET, "              atomicAdd(&probe_counts[1], 1ull);\n" + MET
                              + "\n                atomicAdd(&probe_counts[2], 1ull);")
    counted = counted.replace('#include "decode_table.cuh"\n', '#include "decode_table.cuh"\n'
                              "__device__ unsigned long long probe_counts[3];\n", 1) + COUNTER
    # the write pass with its whole 16-byte stores folded into one register
    # and stored once a run (the pieces at the runs' ends still stored)
    no_piece = (src.replace(QUEUE, QUEUE + "\n  uint32_t sink = 0u;")
                .replace(PIECE, "          sink ^= q0 ^ q1 ^ q2 ^ acc;")
                .replace(TAIL, "  if (sink == 0x9E3779B9u) out[g0] = 0;\n" + TAIL)
                .replace(QUEUE_DUAL, QUEUE_DUAL + "\n  uint32_t sink = 0u;")
                .replace(PIECE_DUAL, "        sink ^= q0 ^ q1 ^ q2 ^ rank;")
                .replace(TAIL_DUAL, "  if (sink == 0x9E3779B9u) out[g0] = 0u;\n" + TAIL_DUAL))
    out = {"full": src, "no_write": no_write, "no_piece_store": no_piece,
           "guess_only": no_write.replace(SYNC, "      // ---- 2. synchronise\n      for (;0;) {"),
           "counted": counted}
    for bits in MEET_SWEEP:
        out[f"meet{bits}"] = src.replace(MEET_BITS, f"constexpr int kMeetBits = {bits};")
        out[f"meet{bits}_counted"] = counted.replace(MEET_BITS, f"constexpr int kMeetBits = {bits};")
    return out


def strategy_variants(src: str, header: str, forms=("bytes", "dual")
                      ) -> dict[str, tuple[str, str]]:
    """(bitstream.cu, decode_table.cuh) of each --strategies build: the
    phases, the counting build (byte and dual) and, for each form of
    `forms` whose register levels the source holds (kRegLevels,
    kDeepLevels), its candidates (CANDIDATES, DUAL_CANDIDATES)."""
    phase = {name: text for name, text in variants(src).items()
             if name in ("full", "no_write", "guess_only")}
    if src.count(CODE_OUT) != 1:
        raise RuntimeError(f"bitstream.cu no longer has the probe's marker:\n{CODE_OUT}")
    if header.count(CHECKED) != 1:
        raise RuntimeError(f"decode_table.cuh no longer has the probe's marker:\n{CHECKED}")
    levels = src.replace(CODE_OUT, "  probe_levels(c.len, t.c.min_len, kStrategy == glz::kBitwalk);\n"
                         + CODE_OUT)
    levels = levels.replace('#include "decode_table.cuh"\n',
                            '#include "decode_table.cuh"\n' + LEVEL_COUNTER, 1)
    out = {name: (text, header) for name, text in phase.items()}
    out["levels"] = (levels, header.replace(CHECKED, DUAL_LEVEL_COUNTER + CHECKED
                                            + "  probe_dual(c, len);\n"))
    if "dual" in forms and "constexpr int kShallowLevels = " in header:
        for name, (consts, edits) in DUAL_CANDIDATES.items():
            text, hdr = src, header
            for const, value in consts.items():
                pattern, new = rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};"
                text, n = re.subn(pattern, new, text)
                hdr, m = re.subn(pattern, new, hdr)
                if n + m != 1:
                    raise RuntimeError(f"candidate {name}: the sources have no one {const}")
            for old, new in edits:
                if hdr.count(old) + text.count(old) != 1:
                    raise RuntimeError(f"candidate {name}: the sources have no one\n{old}")
                hdr, text = hdr.replace(old, new), text.replace(old, new)
            out[name] = (text, hdr)
    if "bytes" not in forms or "constexpr int kRegLevels = " not in header:
        return out  # a source from before the register levels: no byte candidates
    for name, (levels_held, edits) in CANDIDATES.items():
        text, hdr = src, header
        if levels_held is not None:
            hdr, n = re.subn(r"constexpr int kRegLevels = \d+;",
                             f"constexpr int kRegLevels = {levels_held};", hdr)
            if n != 1:
                raise RuntimeError(f"candidate {name}: decode_table.cuh has no one kRegLevels")
        for old, new in edits:
            if hdr.count(old) + text.count(old) != 1:
                raise RuntimeError(f"candidate {name}: the sources have no one\n{old}")
            hdr, text = hdr.replace(old, new), text.replace(old, new)
        out[name] = (text, hdr)
    return out


def start_builds(tmp: pathlib.Path, sources: dict[str, tuple[str, str]]
                 ) -> dict[str, subprocess.Popen]:
    """Start one nvcc for each variant (name -> (bitstream.cu,
    decode_table.cuh)), each in its own directory under tmp, all together."""
    procs = {}
    for name, (text, header) in sources.items():
        d = tmp / name
        d.mkdir()
        (d / "bitstream.cu").write_text(text)
        (d / "decode_table.cuh").write_text(header)
        procs[name] = subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "bitstream.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return procs


def finish_builds(tmp: pathlib.Path, procs: dict[str, subprocess.Popen]
                  ) -> dict[str, ctypes.CDLL]:
    """Wait for start_builds' nvcc and load each library, its ptxas -v
    report as lib.ptxas."""
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        lib = ctypes.CDLL(str(tmp / name / "lib.so"))
        for entry in ("glz_decode_streams", "glz_decode_streams_dual",
                      "glz_decode_streams_strategy", "glz_decode_streams_dual_strategy"):
            fn = getattr(lib, entry)
            fn.argtypes = _kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        lib.ptxas = out + err
        if name.endswith("counted"):
            lib.probe_take.restype = ctypes.c_ulonglong
        if name.endswith("levels"):
            lib.probe_levels_take.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
            lib.probe_dual_levels_take.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        libs[name] = lib
    return libs


def build(tmp: pathlib.Path, sources: dict[str, tuple[str, str]] | None = None
          ) -> dict[str, ctypes.CDLL]:
    """Build each variant (by default variants() of the repository's
    bitstream.cu) and load it."""
    if sources is None:
        header = (_kernels.CSRC / "decode_table.cuh").read_text()
        sources = {name: (text, header) for name, text in
                   variants((_kernels.CSRC / "bitstream.cu").read_text()).items()}
    return finish_builds(tmp, start_builds(tmp, sources))


def counts(lib, run) -> tuple[int, int, int]:
    """(rounds, restarted subsequences, met) of one run of a counted build."""
    for which in range(3):
        lib.probe_take(which)
    run(lib)
    torch.cuda.synchronize()
    got = [lib.probe_take(0)]
    run(lib)  # probe_take zeroes all counts, so each is read from a run of its own
    torch.cuda.synchronize()
    got.append(lib.probe_take(1))
    run(lib)
    torch.cuda.synchronize()
    got.append(lib.probe_take(2))
    return tuple(got)


def phases(libs, run, n_streams: int, what: str) -> None:
    """Print the phase line of one decode configuration: the variants'
    times and the counted build's rounds and meetings."""
    ms = {name: chip_smoke.cuda_ms(lambda: run(libs[name]), reps=5)
          for name in ("full", "no_write", "guess_only", "no_piece_store")}
    rounds, redone, met = counts(libs["counted"], run)
    print(f"{what}: full {ms['full']:.3f} ms = guess {ms['guess_only']:.3f} + rounds "
          f"{ms['no_write'] - ms['guess_only']:.3f} + write {ms['full'] - ms['no_write']:.3f} "
          f"(its 16-byte stores {ms['full'] - ms['no_piece_store']:.3f}); "
          f"{rounds / n_streams:.2f} rounds a stream, {redone} subsequences restarted, {met} "
          f"of them met their guess", flush=True)


def dual_main(libs, dev: torch.device, stream) -> None:
    """The dual (HuffWord) decode's phases at the HuffWord bitstream path's
    shape: phase 4d's 100 MiB of word text under DEFAULT (streams of 16,384
    tokens), at each swept word-table size and subsequence length, and the
    meeting distances at DUAL_MEET_AT."""
    inp, want = dual_inputs(dev)
    out = torch.empty_like(want)
    (min0, min1), (max0, max1) = inp.len_range
    for tb in chip_smoke.DUAL_TABLE_BITS_SWEEP:
        for T in chip_smoke.DUAL_SUBSEQ_BITS_SWEEP:
            def run(lib):
                rc = lib.glz_decode_streams_dual(
                    _kernels.ptr(inp.words), inp.words.numel(), _kernels.ptr(inp.starts),
                    inp.starts.numel(), inp.T, inp.S, tb, _kernels.ptr(inp.fc),
                    _kernels.ptr(inp.off), min0, max0, min1, max1, T, _kernels.ptr(out),
                    stream)
                if rc:
                    raise RuntimeError(f"glz_decode_streams_dual: CUDA error {rc}")

            out.zero_()
            run(libs["full"])
            if not torch.equal(out, want):
                raise RuntimeError(f"dual table_bits {tb} T {T}: differs from the plain version")
            if (tb, T) == DUAL_MEET_AT or T == DUAL_MEET_AT[1] or tb == DUAL_MEET_AT[0]:
                phases(libs, run, inp.starts.numel(), f"dual decode table_bits {tb} T {T}")
            if (tb, T) != DUAL_MEET_AT:
                continue
            for bits in MEET_SWEEP:
                t_ms = chip_smoke.cuda_ms(lambda: run(libs[f"meet{bits}"]), reps=5)
                _, redone, met = counts(libs[f"meet{bits}_counted"], run)
                print(f"dual decode table_bits {tb} T {T} meeting point {bits} bits: "
                      f"{t_ms:.3f} ms; {met} of {redone} restarted subsequences met their "
                      f"guess", flush=True)
    word, sep = (inp.even, inp.odd) if inp.word_first else (inp.odd, inp.even)
    print(f"dual decode phases at the HuffWord bitstream shape ({inp.starts.numel()} streams "
          f"of {inp.S} tokens, {inp.T} tokens; word codes {word.min_len}-{word.max_len} "
          f"bits, separators {sep.min_len}-{sep.max_len})", flush=True)


def byte_main_inputs(dev: torch.device):
    """(input, container, codebook, words, starts, (fc, offsets, symtab)) of
    the byte main path: 512 MiB of the benchmark corpus under DEFAULT."""
    arr = chip_smoke.make_corpus(chip_smoke.MAIN_BYTES)
    f = container.read_container(gt.compress(arr, conf=cfg.DEFAULT))
    cb = codebook_from_lengths(container.decode_byte_codebook(f.codebook_blob))
    words = i32_tensor(bitio.bytes_to_words(f.payload), dev)
    sb = f.stream_bits.astype(np.int64)
    starts = torch.from_numpy(np.cumsum(sb) - sb).to(dev)
    return arr, f, cb, words, starts, decode_tables(cb, dev)


def strategy_runner(strategy: int, f, cb, words, starts, tables, out, err, stream):
    """run(lib): one launch of lib's byte strategy kernel on the inputs."""
    fc, offs, symtab = tables

    def run(lib):
        rc = lib.glz_decode_streams_strategy(
            strategy, _kernels.ptr(words), words.numel(), _kernels.ptr(starts),
            starts.numel(), f.n_symbols, f.stream_symbols, _kernels.ptr(fc),
            _kernels.ptr(offs), _kernels.ptr(symtab), cb.min_len, cb.max_len,
            cb.symbols.size, bd.SUBSEQ_BITS, _kernels.ptr(err), _kernels.ptr(out), stream)
        if rc:
            raise RuntimeError(f"glz_decode_streams_strategy: CUDA error {rc}")
    return run


def level_counts(lib, run) -> dict[str, float]:
    """The counting build's figures over one run (see the docstring)."""
    n = 4 + 2 * len(LEVEL_DEPTHS)
    got = (ctypes.c_ulonglong * n)()
    lib.probe_levels_take(got)
    run(lib)
    torch.cuda.synchronize()
    lib.probe_levels_take(got)
    codes, lane, steps, warp = got[:4]
    out = {"codes": codes, "lane_levels": lane / codes, "warp_levels": warp / steps,
           "lanes_a_step": codes / steps}
    for i, k in enumerate(LEVEL_DEPTHS):
        out[f"steps_past_{k}"] = got[4 + i] / steps
        out[f"codes_past_{k}"] = got[4 + len(LEVEL_DEPTHS) + i] / codes
    return out


def dual_inputs(dev: torch.device):
    """(inputs, the tokens' ranks) of the HuffWord bitstream path: phase
    4d's 100 MiB of word text under DEFAULT (streams of 16,384 tokens),
    the ranks from the plain table decode."""
    _, _, wf, wv, nv, ids = tok.build_vocabs(chip_smoke.make_word_corpus(chip_smoke.HUFFWORD_BYTES))
    cbs = [build_codebook(v.counts, cfg.DEFAULT.length_limit) for v in (wv, nv)]
    inp = chip_smoke.HuffwordBitstreamInputs(ids, bool(wf), cbs, wv.n, nv.n,
                                             min(cfg.DEFAULT.stream_symbols, 1 << 14), dev)
    return inp, inp.decode(bd.decode_streams_dual_ref)


def dual_strategy_runner(strategy: int, inp, out, err, stream):
    """run(lib): one launch of lib's dual strategy kernel on the inputs."""
    (min0, min1), (max0, max1) = inp.len_range

    def run(lib):
        rc = lib.glz_decode_streams_dual_strategy(
            strategy, _kernels.ptr(inp.words), inp.words.numel(), _kernels.ptr(inp.starts),
            inp.starts.numel(), inp.T, inp.S, _kernels.ptr(inp.fc), _kernels.ptr(inp.off),
            min0, max0, min1, max1, inp.even.symbols.size, inp.odd.symbols.size,
            bd.DUAL_SUBSEQ_BITS, _kernels.ptr(err), _kernels.ptr(out), stream)
        if rc:
            raise RuntimeError(f"glz_decode_streams_dual_strategy: CUDA error {rc}")
    return run


def dual_level_counts(lib, run, sets: dict[str, tuple[int, int]]) -> dict[str, dict]:
    """The dual counting build's figures over one run (see the docstring):
    for each set of `sets` (name -> (min_len, max_len); sets with the same
    longest code are counted together), and for the warp ("warp")."""
    per = 5 + 2 * len(DUAL_DEPTHS)
    got = (ctypes.c_ulonglong * (34 * per + 3))()
    lib.probe_dual_levels_take(got)
    run(lib)
    torch.cuda.synchronize()
    lib.probe_dual_levels_take(got)
    out = {}
    for name, (min_len, max_len) in sets.items():
        codes, bw, fs, steps, top, *past = got[max_len * per:(max_len + 1) * per]
        if not codes:
            continue
        c = {"codes": codes, "bitwalk_lane": bw / codes, "fast_lane": fs / codes,
             "lanes_a_step": codes / steps, "bitwalk_step": top / steps,
             "fast_step": top / steps - min_len + 1}
        for i, k in enumerate(DUAL_DEPTHS):
            c[f"steps_past_{k}"] = past[i] / steps
            c[f"codes_past_{k}"] = past[len(DUAL_DEPTHS) + i] / codes
        out[name] = c
    steps, top, top_fs = got[34 * per:34 * per + 3]
    out["warp"] = {"steps": steps, "bitwalk_step": top / steps, "fast_step": top_fs / steps}
    return out


def dual_levels_line(v: str, label: str, c: dict) -> str:
    """One line of the dual counting build's figures for strategy v."""
    sets = "; ".join(
        f"{name} codes {s['codes']}: a lane {s[f'{v}_lane']:.2f} levels a code, "
        f"{s['lanes_a_step']:.2f} lanes of the set a step {s[f'{v}_step']:.2f}; longer than "
        + ", ".join(f"{k}: {100 * s[f'codes_past_{k}']:.3f}% (steps {100 * s[f'steps_past_{k}']:.2f}%)"
                    for k in DUAL_DEPTHS)
        for name, s in c.items() if name != "warp")
    return (f"dual {v} {label} levels: {sets}; the warp (its lanes on either set) "
            f"{c['warp'][f'{v}_step']:.2f} levels a code step over {c['warp']['steps']} steps")


def strategies_main(parent: pathlib.Path | None, dev: torch.device, smi: str,
                    forms: tuple[str, ...]) -> None:
    """--strategies: the bit-walk and fast kernels' phases, levels,
    registers and candidates, for each form of `forms` (see the
    docstring)."""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    sources = {"source": _kernels.CSRC}
    if parent is not None:
        sources = {"parent": parent, **sources}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        builds = {label: strategy_variants((d / "bitstream.cu").read_text(),
                                           (d / "decode_table.cuh").read_text(),
                                           forms if label == "source" else ())
                  for label, d in sources.items()}
        libs_all = build(pathlib.Path(tmp), {f"{label}.{name}": v for label, b in builds.items()
                                             for name, v in b.items()})
        libs = {label: {name: libs_all[f"{label}.{name}"] for name in b}
                for label, b in builds.items()}
        print(f"strategies: {len(libs_all)} builds in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for label, lb in libs.items():
            for name, lib in lb.items():
                regs = [line for line in chip_smoke.ptxas_summary(lib.ptxas)
                        if line.startswith("decode_streams_sync_kernel")
                        and any(f",{form}," in line for form in forms)
                        and not line.split(":")[0].endswith("table>")]
                print(f"registers {label} {name}: {'; '.join(regs)}", flush=True)
        if "bytes" in forms:
            byte_strategies(libs, dev, stream)
        if "dual" in forms:
            dual_strategies(libs, dev, stream)
    print(f"on {torch.cuda.get_device_name(0)} ({smi})", flush=True)


def time_strategy(v: str, libs: dict, run, check, candidates: dict, what: str,
                  levels) -> None:
    """The phase builds and the candidates of libs (label -> name ->
    library) checked (check(name) after a run), then timed in turns
    (parent, source, source, parent), each label's phases and its
    candidates printed, and its counting build's line (levels(label, lib)
    -> str)."""
    libs = {label: {name: lib for name, lib in lb.items()
                    if name in ("full", "no_write", "guess_only", "levels") or name in candidates}
            for label, lb in libs.items()}
    for label, lb in libs.items():
        for name, lib in lb.items():
            if name == "levels":
                continue
            run(lib)
            torch.cuda.synchronize()
            if not check(name):
                raise RuntimeError(f"{what} {v} {label} {name}: the decode differs from the input")
    order = list(libs)
    times: dict[tuple[str, str], list[dict]] = {}
    for turn in (order, order[::-1]):
        for label in turn:
            for name, lib in libs[label].items():
                if name != "levels":
                    times.setdefault((label, name), []).append(
                        chip_smoke.cuda_spread(lambda lib=lib: run(lib)))
    for label in order:
        ms = {name: statistics.median(t["ms"] for t in times[(label, name)])
              for (lb, name) in times if lb == label}
        spread = {name: (min(t["min_ms"] for t in times[(label, name)]),
                         max(t["max_ms"] for t in times[(label, name)]))
                  for (lb, name) in times if lb == label}
        medians = ", ".join(f"{t['ms']:.3f}" for t in times[(label, "full")])
        print(f"{what}{v} {label}: full {ms['full']:.3f} ms (medians of 9: {medians}; "
              f"{spread['full'][0]:.3f}-{spread['full'][1]:.3f}) = guess "
              f"{ms['guess_only']:.3f} + rounds {ms['no_write'] - ms['guess_only']:.3f} + "
              f"write {ms['full'] - ms['no_write']:.3f}", flush=True)
        cands = [n for n in ms if n in candidates]
        if cands:
            print(f"{what}{v} {label} candidates: " + "; ".join(
                f"{n} {ms[n]:.3f} ms ({spread[n][0]:.3f}-{spread[n][1]:.3f})"
                for n in cands), flush=True)
        print(levels(label, libs[label]["levels"]), flush=True)


def byte_strategies(libs: dict, dev: torch.device, stream) -> None:
    """The byte bit-walk and fast kernels at the byte main path's shape."""
    arr, f, cb, words, starts, tables = byte_main_inputs(dev)
    want = torch.from_numpy(arr).to(dev)
    out = torch.empty_like(want)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    for v, code in BYTE_STRATEGIES.items():
        run = strategy_runner(code, f, cb, words, starts, tables, out, err, stream)

        def check(name):
            return not int(err.item()) and (name in ("no_write", "guess_only")
                                            or torch.equal(out, want))

        def levels(label, lib, v=v, run=run):
            c = level_counts(lib, run)
            return (f"{v} {label} levels: {c['codes']} codes decoded; a lane "
                    f"{c['lane_levels']:.2f} levels a code, its warp {c['warp_levels']:.2f} "
                    f"a code step, {c['lanes_a_step']:.2f} lanes a step; codes longer than "
                    + ", ".join(f"{k}: {100 * c[f'codes_past_{k}']:.3f}% (warp steps "
                                f"{100 * c[f'steps_past_{k}']:.2f}%)" for k in LEVEL_DEPTHS))

        out.zero_()
        time_strategy(v, libs, run, check, CANDIDATES, "", levels)
    print(f"strategy phases at 512 MiB DEFAULT ({f.n_streams} streams of {f.stream_symbols}, "
          f"codes {cb.min_len}-{cb.max_len} bits, T {bd.SUBSEQ_BITS})", flush=True)


def dual_strategies(libs: dict, dev: torch.device, stream) -> None:
    """The dual bit-walk and fast kernels at the HuffWord bitstream path's
    shape, each build's output against the plain version's ranks."""
    inp, want = dual_inputs(dev)
    out = torch.empty_like(want)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    word, sep = (inp.even, inp.odd) if inp.word_first else (inp.odd, inp.even)
    sets = {"word": (word.min_len, word.max_len), "separator": (sep.min_len, sep.max_len)}
    for v, code in BYTE_STRATEGIES.items():
        run = dual_strategy_runner(code, inp, out, err, stream)

        def check(name):
            ok = not int(err.item()) and (name in ("no_write", "guess_only")
                                          or torch.equal(out, want))
            out.zero_()
            return ok

        def levels(label, lib, v=v, run=run):
            return dual_levels_line(v, label, dual_level_counts(lib, run, sets))

        out.zero_()
        time_strategy(v, libs, run, check, DUAL_CANDIDATES, "dual ", levels)
    print(f"dual strategy phases at the HuffWord bitstream shape ({inp.starts.numel()} streams "
          f"of {inp.S} tokens, {inp.T} tokens; word codes {word.min_len}-{word.max_len} bits, "
          f"separators {sep.min_len}-{sep.max_len}, T {bd.DUAL_SUBSEQ_BITS})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strategies", action="store_true",
                    help="the bit-walk and fast kernels instead of the table decodes")
    ap.add_argument("--form", choices=("bytes", "dual", "both"), default="both",
                    help="with --strategies: the byte kernels, the dual ones, or both")
    ap.add_argument("--parent", type=pathlib.Path,
                    help="with --strategies: another csrc/ directory, timed beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_decode_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    if args.strategies:
        strategies_main(args.parent, dev, smi,
                        ("bytes", "dual") if args.form == "both" else (args.form,))
        return 0
    arr, f, cb, words, starts, (fc, offs, symtab) = byte_main_inputs(dev)
    want = torch.from_numpy(arr).to(dev)
    out = torch.empty_like(want)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))
        for tb in chip_smoke.TABLE_BITS_SWEEP:
            for T in chip_smoke.SUBSEQ_BITS_SWEEP:
                def run(lib):
                    rc = lib.glz_decode_streams(
                        _kernels.ptr(words), words.numel(), _kernels.ptr(starts),
                        starts.numel(), f.n_symbols, f.stream_symbols, tb, _kernels.ptr(fc),
                        _kernels.ptr(offs), _kernels.ptr(symtab),
                        cb.min_len, cb.max_len, T, _kernels.ptr(out), stream)
                    if rc:
                        raise RuntimeError(f"glz_decode_streams: CUDA error {rc}")

                out.zero_()
                run(libs["full"])
                if not torch.equal(out, want):
                    raise RuntimeError(f"table_bits {tb} T {T}: the decode differs from the input")
                phases(libs, run, f.n_streams, f"stream decode table_bits {tb} T {T}")
                if (tb, T) != MEET_AT:
                    continue
                for bits in MEET_SWEEP:
                    t_ms = chip_smoke.cuda_ms(lambda: run(libs[f"meet{bits}"]), reps=5)
                    _, redone, met = counts(libs[f"meet{bits}_counted"], run)
                    print(f"stream decode table_bits {tb} T {T} meeting point {bits} bits: "
                          f"{t_ms:.3f} ms; {met} of {redone} restarted subsequences met "
                          f"their guess", flush=True)
        print(f"stream decode phases at 512 MiB DEFAULT ({f.n_streams} streams of "
              f"{f.stream_symbols}, codes {cb.min_len}-{cb.max_len} bits)", flush=True)
        del words, starts, want, out
        dual_main(libs, dev, stream)
    print(f"on {torch.cuda.get_device_name(0)} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
