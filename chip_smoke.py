#!/usr/bin/env python3
"""Drive glz_tpu_torch's paths on one CUDA card and check its kernels.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Four paths: the byte-mode lockstep codec (THROUGHPUT), the HuffWord
lockstep codec, and the bitstream (layout 0) codec in byte and HuffWord
mode (DEFAULT), the byte one through glz_tpu's default front door
(backend "host") and the device backend; then the multi-file batch and the
.glzb archive, and the command line (python -m glz_tpu_torch.cli) on every
path, which run every kernel again; then the device mesh (world size 1)
and the multi-process paths with two processes sharing the card, a device
trace of each main path's compress and decompress, the bitstream paths'
decompress through each of the reference's decoder strategies, and last
the benches (bench_torch.py, bench_huffword_torch.py).  Phases
(each prints one line or more; any failure exits non-zero before the
last):
  1. environment: torch, the card, nvidia-smi, nvcc, g++;
  2. build: compile csrc/lockstep.cu and csrc/bitstream.cu (which share
     csrc/decode_table.cuh) and csrc/histogram.cu for sm_90a (one nvcc
     each, in parallel), with
     ptxas register/spill figures per kernel, and the host library
     (native/glz_native.cpp: histogram, tokenizer, detokenize, .crs2
     decode) with g++;
  3. kernels against their plain PyTorch versions on the card, bit-exact
     (integer data, tolerance 0):
     - byte path: K1 lane_totals, K2 encode_groups and K3 decode_groups on
       rows 8/16/32/64 at S 64/512, rows 8 at S 8192 and rows 16 at S 32
       (the mesh dry run's geometry), each with a ragged
       n_valid, a depth-26 codebook, and identical lanes (dense refill
       steps);
     - HuffWord path: K6 lut_gather at both call sites (gather_entries,
       map_ranks), the entry-word lane totals, K4 encode_entries and K5
       decode_dual (each at the geometry its entry launches at the case's
       rows) on
       rows 8/16/32 at S 64/512, rows 64 at S 64 and 256 and rows 8 at S
       1024 (ragged token counts), nonword-first text, single-symbol
       dictionaries, one token (an empty dictionary) and a >64K-word
       vocabulary (u32 ids); each case also round-trips its tokens; K5
       alone on random words at S 66 (rows 8) and 130 (rows 64); K4 alone
       at rows 8/16/32/64 (each geometry its entry launches), ragged or
       single-symbol; K1 alone at every S from 32 to 8192 with a ragged
       n_valid and garbage past it, and with a depth-26 codebook;
     - the histogram kernel on lengths 0, 1, 15, 17 and 2^20 + 3 (one from
       an unaligned start), one byte value only and uniform bytes, against
       its plain version, torch.bincount and np.bincount;
  3c. bitstream kernels: K7 lookup_lj_lens, the pack (pack_scan, pack_tiles,
     from bit 0 and from bit 13, and the whole step) and decode_streams on
     byte cases (ragged n_valid with garbage past it, S 1000 (not a power
     of two), codes of 27-32 bits, one symbol, a one-code codebook, three
     DEFAULT-sized streams, 64 MiB of uniform bytes (all codes 8 bits; its
     decode time is printed), two dispatches of one stream each, word-
     aligned (the device container) or the second packed from the first's
     last bit (the host container), and longest codes of REG_LEVELS,
     REG_LEVELS + 1, 16 and 17 bits: on either side of the levels the byte
     strategy kernels hold in registers and of 16 bits), and K6 on the lj
     and length tables,
     the pack and decode_streams_dual on HuffWord cases (S 16384, odd S,
     nonword-first text, one token (an empty dictionary), a >64K-word
     vocabulary, codes of 27-32 bits, 256 equiprobable 8-bit words with
     1-3-bit separators (its decode time and rounds are printed), and word
     and separator codes whose longest are DUAL_LEVELS and one bit past
     them: on either side of the levels the dual strategy kernels hold in
     registers, words even and odd); each case also round-trips;
  4. byte main path: compress + decompress of a 512 MiB corpus under
     THROUGHPUT with checksum, launch counts read just after;
  4b. HuffWord main path: compress + decompress of 100 MiB of English-like
     text (20,000 Zipf words) at S 512, rows 32, with checksum, launch
     counts read just after, and the host steps re-run alone (tokenize +
     vocabularies and detokenize in the host library beside their numpy
     references, outputs equal);
  4c. byte bitstream path: the same 512 MiB under DEFAULT with checksum
     (2,048 streams of 2^18 symbols in four dispatches of 2^27) through
     backend "host" (glz_tpu's default container) and then "device",
     launch counts read just after each, and the host steps re-run alone
     (the exact histogram in the host library beside np.bincount, equal);
  4d. HuffWord bitstream path: phase 4b's text under DEFAULT with checksum
     (streams of 16,384 tokens), launch counts read just after;
  4e. batch path: twelve members at the Silesia corpus's published sizes
     (211,938,580 bytes, made from seeds): compress_batch/decompress_batch
     under THROUGHPUT and DEFAULT, pipelined (two files in flight on two
     threads) and serial in turns, the containers equal either way; the
     shared-codebook batch under THROUGHPUT and under DEFAULT with backend
     "device"; compress_archive/decompress_archive in byte mode under both
     presets and in HuffWord lockstep mode (S 512, rows 32) on three text
     members; each with its times, launch counts, peak device memory, and
     the archive's size against the per-file containers;
  4f. the command line: glz_tpu_torch.cli.main in this process on files of
     phase 4's corpus, phase 4b's text and phase 4e's members: compress +
     decompress with the defaults, --preset throughput, --model huffword
     and --model huffword --backend device (S 512, rows 32), archive +
     unarchive of the twelve members, each file's SHA-256 against the
     API's container for the same call, the outputs against the inputs,
     the launch counts against the path's kernels, then info --stats on
     each container; on tests/fixtures/realtext.txt[:1 MiB], utet modes
     1-6, the .crs3 format and containers and archives that must have
     phase 6's pinned digests; and one python -m glz_tpu_torch.cli
     subprocess round trip;
  5. kernel times at each main path's shapes (CUDA events: the median,
     min and max of 9 launches, each in its own event pair behind a spin
     kernel, beside the mean of 5 back to back), each kernel
     held against its plain version on the same inputs (the stream decodes
     also against the input); the whole pack step against the first
     port's (torch.cumsum and pack_lj_kernel, tools/pack_phases.py) on the
     same codes; the decodes
     again at each swept decode table size (and the stream decodes'
     subsequence length), each against the input or the plain version, and
     the share of the main corpora's symbols (tokens) the tables resolve in
     one probe; the histogram kernel on the 512 MiB corpus against its
     plain version, torch.bincount (its library time), the host library
     and np.bincount; the registers and spills of K1, K4 (each geometry
     launched), K2, K5 and the histogram;
  6. pinned digests: the containers of tests/fixtures/realtext.txt[:1 MiB]
     under ten configurations, its normal-tree container, and archives of
     its four quarters in byte DEFAULT, byte THROUGHPUT and HuffWord
     lockstep (S 64) must have the SHA-256 that the JAX reference writes
     (pinned by tests/test_torch_canonical_byte.py,
     tests/test_torch_huffword.py, tests/test_torch_bitstream.py,
     tests/test_torch_front_door.py and tests/test_torch_batch.py);
  7. the device mesh and the multi-process paths (glz_tpu_torch.parallel;
     their histogram kernel is checked in phases 3 and 5):
     7b. in this process, a process group of one (NCCL): sharded_histogram
     of the 512 MiB corpus (its launch is the histogram's count),
     lockstep_codec_step at THROUGHPUT's geometry with and without
     max_bits_per_symbol (group table and words against
     compress_bytes_lockstep's with the same codebook, round trip exact),
     the too-tight bound raising, codec_step at S 2^18 in dispatches of
     2^27; then the dry run (python -m glz_tpu_torch.parallel.dryrun) a
     spawned rank a card;
     7c. two spawned processes sharing the card (gloo for the gathers),
     each reading its shard from a file: compress_bytes_multihost of the
     corpus under THROUGHPUT (64 groups a shard) and DEFAULT (S 2^18
     shards), compress_huffword_multihost of phase 4b's text (S 512, rows
     capped to 16, split_huffword_shards), decompress_bytes_multihost and
     decompress_huffword_multihost writing their slices at their offsets;
     each process's times (compress, gathers, process 0's stitch), launch
     counts and peak device memory; every container decodes in this
     process, every assembled output equals its input, the stitched
     crc32s are zlib's, and the lockstep container equals
     compress_bytes_lockstep's with an exact histogram (the HuffWord one
     compress's at rows 16); the single-process calls on the same inputs
     are timed beside them.
  8. device traces: each main path's compress and decompress apart (byte
     lockstep under THROUGHPUT, HuffWord lockstep at S 512, rows 32, byte
     bitstream under DEFAULT through backend "host", HuffWord bitstream
     under DEFAULT; phase 4's corpus and phase 4b's text, with checksum),
     each inside glz_tpu_torch.utils.timer's Profiler phase, inside
     device_trace(build/traces/<path>_<direction>) (torch.profiler, CPU
     and CUDA), inside a record_function span; each container equal to the
     untraced one of phases 4-4d and each round trip exact; per trace one
     line: the span's window, kernel-busy and device-busy time (the union of
     kernel events; of kernel, copy and memset events), both idle shares,
     the five device operations with the most time and the three longest
     gaps with no device event and the CPU-side event under each; each port
     kernel's events equal to its launches in the call; then the
     Profiler's report of the eight calls.
  9. the decoder strategies (decompress's variant): the bit-walk and fast
     kernels of both stream decodes against their plain versions on phase
     3c's cases (and the input or tokens) and past a payload's end, each
     raising on a code that matches no codeword; phase 4c's byte container
     (backend "host") and phase 4d's HuffWord container through
     decompress(variant=v) for v in
     table, bitwalk and fast, each output equal to its input and the launch
     counts, read just after each call, naming the routed kernel and no
     other stream decode; each new kernel on the whole container against
     its plain version and the input (tokens), timed as in phase 5, beside
     the table kernel's time in the same call; the stream decodes'
     registers and spills, each form and strategy; and the byte bit-walk's
     and fast scan's counting build (tools/stream_decode_phases.py's,
     compiled beside the library in phase 2) on the whole container: the
     levels a lane walks a code, the levels its warp runs a code step, and
     the codes that go past the register levels; and the dual ones' (the
     same build) on phase 4d's container, the word and separator codes
     apart.
  10. the benches: python3 bench_torch.py at its defaults (512 MiB of the
     benchmark corpus at S 512, rows 64, 5 repeats: the codebook, K1 + K2,
     K3 and the two edge round trips; 100 MiB of HuffWord text at S 512,
     rows 32, end to end and kernels only; the four-quarter batch) and
     GLZ_HW_PROFILE=1 python3 bench_huffword_torch.py (100 MiB), each a
     subprocess on the card that must exit 0 within BENCH_TIMEOUT with a
     last line of positive numbers (bench_torch.py's keys exactly
     bench.py's), and each part's launch counts exactly its encodes and
     decodes times the kernels each launches; their stderr (the card, the
     Profiler report, the counts) and JSON lines are printed.
Then the kernels JSON line, the nvidia-smi line and the result line.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import importlib.util
import io
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings
import zlib

import numpy as np
import torch

import glz_tpu_torch as gt
from glz_tpu_torch import cli
from glz_tpu_torch import config as cfg
from glz_tpu_torch.compat import glzip_format
from glz_tpu_torch.core import bitio, container
from glz_tpu_torch.core.codebook import (build_codebook, codebook_from_lengths,
                                         histogram_bytes, sampled_histogram)
from glz_tpu_torch.core import lockstep
from glz_tpu_torch.core.lockstep import LANES
from glz_tpu_torch.models import huffword as hw_model
from glz_tpu_torch.models import canonical_byte as cb_model
from glz_tpu_torch.models import transfer
from glz_tpu_torch.models.canonical_byte import decode_tables, entry_table, group_tables
from glz_tpu_torch.models.transfer import i32_tensor, round_up
from glz_tpu_torch.ops import _kernels
from glz_tpu_torch.ops import decode as bd
from glz_tpu_torch.ops import decode_table
from glz_tpu_torch.ops import encode as be
from glz_tpu_torch.ops import lockstep_decode as kd
from glz_tpu_torch.ops import lockstep_encode as ke
from glz_tpu_torch.ops import histogram as hist_ops
from glz_tpu_torch.ops import lut
from glz_tpu_torch.parallel import dryrun, ranks
from glz_tpu_torch.parallel import mesh as pmesh
from glz_tpu_torch.parallel import multihost
from glz_tpu_torch.utils import native
from glz_tpu_torch.utils import tokenizer as tok
from glz_tpu_torch.utils.timer import Profiler, device_trace

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
# Phase 5 times each kernel as this many launches, each in its own event
# pair behind a spin kernel of this many clock cycles (~1 ms at the H100's
# clocks, longer than any wrapper's host work).
SINGLE_LAUNCHES = 9
SPIN_CYCLES = 2_000_000

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
# SHA-256 of glz_tpu's compress_archive of quarters(realtext.txt[:1 MiB]),
# and of its normal-tree container of the whole 1 MiB.
ARCHIVE_PINNED = {
    "archive_byte_default": "dd28b497790472d01099b9f11e1594b9cadefefd917ebd2b81ddd9ce96485ffb",
    "archive_byte_throughput": "692f6cefa731c8a0156610ba1d04e175b36741c4805cd4c4185d304f5f35965c",
    "archive_hw_s64": "ccf5d4df7be035bd3b40025211b86a2c04b3bf595bb8b2fd0118378488961866",
    "normal_tree": "d24c317dde15dc1828e932b07bc25716bcecbadddde931aad436b9ea5a059ae5",
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
    "histogram": "glz_tpu/ops/histogram.py:36",
    "decode_streams_bitwalk": "glz_tpu/core/host_codec.py:82",
    "decode_streams_fast": "glz_tpu/core/host_codec.py:105",
    "decode_streams_dual_fast": "glz_tpu/models/huffword.py:546",
    "decode_streams_dual_bitwalk": "glz_tpu/models/huffword.py:552",
}
# Phase 4e's members: the Silesia corpus's twelve files at their published
# sizes in bytes, made from seeds (the real files are not in the
# repository): the text ones by make_word_corpus, the others i.i.d. bytes
# of a per-member Dirichlet(0.1) law, so their statistics differ widely.
SILESIA = {"dickens": 10_192_446, "mozilla": 51_220_480, "mr": 9_970_564,
           "nci": 33_553_445, "ooffice": 6_152_192, "osdb": 10_085_684,
           "reymont": 6_627_202, "samba": 21_606_400, "sao": 7_251_944,
           "webster": 41_458_703, "xml": 5_345_280, "x-ray": 8_474_240}
SILESIA_TEXT = ("dickens", "nci", "reymont", "webster", "xml")
HUFFWORD_ARCHIVE_MEMBERS = ("dickens", "reymont", "xml")  # 22,164,928 bytes
BYTE_KERNELS = ("lane_totals", "encode_groups", "decode_groups")
HUFFWORD_KERNELS = ("lut_gather", "lane_totals_entries", "encode_entries", "decode_dual")
BITSTREAM_KERNELS = ("lookup_lj_lens", "pack_scan", "pack_tiles", "decode_streams")
HUFFWORD_BITSTREAM_KERNELS = ("lut_gather", "pack_scan", "pack_tiles", "decode_streams_dual")
# The stream decodes' wrapper (launch counter) for each decoder strategy
# (decode_table.cuh's kTable, kBitwalk, kFast: the kernels' last template
# argument), byte form and dual form.
STRATEGIES = ("table", "bitwalk", "fast")
STREAM_DECODES = {(False, "table"): "decode_streams", (True, "table"): "decode_streams_dual",
                  **{(dual, v): f"decode_streams{'_dual' if dual else ''}_{v}"
                     for dual in (False, True) for v in ("bitwalk", "fast")}}


# Phase 10: bench_torch.py's JSON keys (bench.py's), and the kernels each
# encode and each decode of a bench part launches: {part: {wrapper:
# (launches an encode, launches a decode)}}.
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "huffword_GBps", "huffword_tokenize_s",
              "huffword_e2e_GBps", "huffword_kernel_GBps", "huffword_kernel_enc_GBps",
              "huffword_kernel_dec_GBps", "batch4_serial_GBps", "batch4_pipelined_GBps",
              "batch4_dec_serial_GBps", "batch4_dec_pipelined_GBps")
_BYTE_CALLS = {"lane_totals": (1, 0), "encode_groups": (1, 0), "decode_groups": (0, 1)}
_HUFFWORD_CALLS = {"lut_gather": (1, 1), "lane_totals_entries": (1, 0),
                   "encode_entries": (1, 0), "decode_dual": (0, 1)}
BENCH_PARTS = {"bench_torch.py": {"byte": _BYTE_CALLS, "huffword": _HUFFWORD_CALLS,
                                  "huffword_kernels": _HUFFWORD_CALLS, "batch": _BYTE_CALLS},
               "bench_huffword_torch.py": {"huffword": _HUFFWORD_CALLS,
                                           "huffword_subphases": _HUFFWORD_CALLS}}
BENCH_TIMEOUT = 900  # seconds a bench subprocess may take
_LAUNCH_LINE = re.compile(r"^launches\[(\w+)\] after (\d+) encodes and (\d+) decodes: (\{.*\})$",
                          re.M)


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


def archive_pinned_configs() -> dict[str, tuple[int, cfg.GlzConfig]]:
    """(mode, configuration) of the archive digests and the normal-tree one."""
    return {"archive_byte_default": (cfg.MODE_BYTE, cfg.DEFAULT),
            "archive_byte_throughput": (cfg.MODE_BYTE, cfg.THROUGHPUT),
            "archive_hw_s64": (cfg.MODE_HUFFWORD,
                               cfg.GlzConfig(stream_symbols=64, layout=cfg.LAYOUT_LOCKSTEP)),
            "normal_tree": (cfg.MODE_NORMAL_TREE, cfg.DEFAULT)}


def quarters(data: bytes) -> list[bytes]:
    """Four equal slices of `data` (the archive digests' members)."""
    q = len(data) // 4
    return [data[i * q : (i + 1) * q] for i in range(4)]


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


def silesia_members() -> dict[str, bytes]:
    """Phase 4e's twelve members (SILESIA), each made from its own seed."""
    out = {}
    for k, (name, size) in enumerate(SILESIA.items()):
        if name in SILESIA_TEXT:
            out[name] = make_word_corpus(size, seed=0x5E5 + k)
        else:
            rng = np.random.default_rng(0x5E5 + k)
            p = rng.dirichlet(np.full(256, 0.1))
            out[name] = rng.choice(256, size=size, p=p).astype(np.uint8).tobytes()
    return out


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
# the smallest S the kernels take, at the mesh dry run's rows
CASES["text_r16_s32"] = (32, 16)


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


# K1 alone at every S it takes (name -> (S, rows)): 1.5 groups less 7
# bytes, so a lane and a 16-byte chunk end mid-way, garbage bytes past
# n_valid; one with a depth-26 codebook
K1_CASES = {"k1_s64_r64": (64, 64), "k1_s128_r8": (128, 8), "k1_s256_r32": (256, 32),
            "k1_s512_r16": (512, 16), "k1_s1024_r64": (1024, 64), "k1_s2048_r8": (2048, 8),
            "k1_s4096_r16": (4096, 16), "k1_s8192_r32": (8192, 32),
            "k1_deep26_s512_r64": (512, 64), "k1_s32_r16": (32, 16)}


def check_k1_case(name: str, dev: torch.device) -> None:
    """K1 on the card against lane_totals_ref, bit-exact."""
    S, rows = K1_CASES[name]
    group = rows * LANES * S
    n = group + group // 2 - 7
    if "deep26" in name:
        arr, cb = deep_case(n)
    else:
        arr = make_corpus(n, seed=S + rows)
        cb = build_codebook(histogram_bytes(arr), ke.MAX_FUSED_LEN)
    host = np.full(2 * group, 0xAB, np.uint8)
    host[:n] = arr
    sym = torch.from_numpy(host).to(dev)
    tbl = entry_table(cb, dev)
    err = max_abs_err(ke.lane_totals(sym, tbl, n, S, rows),
                      ke.lane_totals_ref(sym, tbl, n, S, rows))
    require(err == 0, f"{name}: K1 differs from its plain version by {err}")


# The histogram kernel's cases: name -> (length, offset of the first byte
# from a 16-byte boundary, law): ragged lengths, an unaligned start, one
# byte value only (every increment on one bin), uniform bytes.
HIST_CASES = {"hist_n0": (0, 0, "corpus"), "hist_n1": (1, 0, "corpus"),
              "hist_n15": (15, 0, "corpus"), "hist_n17": (17, 0, "corpus"),
              "hist_n1048579": ((1 << 20) + 3, 0, "corpus"),
              "hist_n1048579_off5": ((1 << 20) + 3, 5, "corpus"),
              "hist_one_byte": ((1 << 20) + 3, 0, "one"),
              "hist_uniform_off3": ((1 << 22) + 5, 3, "uniform")}


def check_histogram_case(name: str, dev: torch.device) -> None:
    """The histogram kernel on the card against histogram_ref,
    torch.bincount and np.bincount, exactly."""
    n, off, law = HIST_CASES[name]
    if law == "corpus":
        arr = make_corpus(n + off, seed=n)
    elif law == "one":
        arr = np.full(n + off, 0xA7, np.uint8)
    else:
        arr = np.random.default_rng(n).integers(0, 256, n + off, dtype=np.uint8)
    sym = torch.from_numpy(arr).to(dev)[off:]
    require(sym.data_ptr() % 16 == off, f"{name}: offset {sym.data_ptr() % 16}")
    got = hist_ops.histogram(sym)
    err = max_abs_err(got, hist_ops.histogram_ref(sym))
    require(err == 0, f"{name}: histogram differs from its plain version by {err}")
    require(torch.equal(got, torch.bincount(sym, minlength=256)), f"{name}: torch.bincount")
    require(np.array_equal(got.cpu().numpy(), np.bincount(arr[off:], minlength=256)),
            f"{name}: np.bincount")


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


# K4 alone at each rows, so at each geometry its entry launches (name ->
# (S, rows)): word text with a ragged token count, or one word and one
# separator (both dictionaries single-symbol)
K4_CASES = {"k4_r8_s512": (512, 8), "k4_r16_s256": (256, 16), "k4_r32_s512": (512, 32),
            "k4_r64_s128": (128, 64), "k4_single_r32_s512": (512, 32),
            "k4_single_r64_s64": (64, 64)}


def check_k4_case(name: str, dev: torch.device) -> None:
    """K4 on the card against encode_entries_ref, bit-exact, its cursors
    ending at 0."""
    S, rows = K4_CASES[name]
    tokens = int(rows * LANES * S * 1.3) + 17
    if "single" in name:
        text = b"word " * (tokens // 2)
    else:  # the word corpus has ~2.14 bytes per token
        text = make_word_corpus(int(tokens * 2.14), seed=S * 10 + rows)
    inp = HuffwordInputs(text, S, rows, dev)
    pay, cend = inp.encode(ke.encode_entries)
    err = max_abs_err((pay, cend), (inp.payload, torch.zeros_like(cend)))
    require(err == 0, f"{name}: K4 differs from its plain version by {err}")


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
    words = i32_tensor(rng.integers(0, 1 << 32, n_words, dtype=np.uint64).astype(np.uint32), dev)
    starts = torch.tensor([0, n_words // 2], dtype=torch.int64, device=dev)
    group_counts = torch.tensor([G * S, G * S // 2 + 17], dtype=torch.int32, device=dev)

    def decode(fn):
        return fn(words, starts, group_counts, fc, off, S, *lens, rows)

    require(max_abs_err(decode(kd.decode_groups_dual), decode(kd.decode_groups_dual_ref)) == 0,
            f"{name}: K5")


# ---- bitstream (layout 0) kernel cases ------------------------------------------

# The levels the byte strategy kernels hold in registers (decode_table.cuh).
REG_LEVELS = int(re.search(r"constexpr int kRegLevels = (\d+);",
                           (_kernels.CSRC / "decode_table.cuh").read_text()).group(1))
# the longest code of each seam case: on either side of the register levels
# and of 16 bits
SEAM_LIMITS = {"at_depth_s16384": REG_LEVELS, "past_depth_s16384": REG_LEVELS + 1,
               "limit16_s16384": 16, "limit17_s16384": 17}
# name -> S; byte cases of K7, the pack and decode_streams
BITSTREAM_CASES = {"ragged_s4096": 4096, "s1000": 1000, "deep32_s16384": 1 << 14,
                   "one_symbol": 1 << 18, "one_code_s4096": 4096,
                   "default_3streams": 1 << 18, "uniform8_s262144": 1 << 18,
                   "two_dispatch_s131072": 1 << 17, "host_two_dispatch_s131072": 1 << 17,
                   **{name: 1 << 14 for name in SEAM_LIMITS}}
PACK_PHASE = 13  # the bit, not word-aligned, at which every case also packs
UNIFORM8_STREAMS = 256  # 64 MiB of uniform bytes: 256 streams of 2^18, all codes 8 bits


def bitstream_case_data(name: str):
    """(symbols u8 padded to whole streams with random bytes past n_valid,
    n_valid, S, codebook) of a byte bitstream kernel case."""
    S = BITSTREAM_CASES[name]
    if name.startswith("deep32"):
        arr, cb = deep_case(5 * S + 4321, limit=32)
    elif name in SEAM_LIMITS:
        arr, cb = deep_case(5 * S + 4321, seed=SEAM_LIMITS[name], limit=SEAM_LIMITS[name])
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
        self.lj_tbl = i32_tensor(cb.left_justified_codes(), dev)
        self.len_tbl = i32_tensor(cb.lengths.astype(np.uint32), dev)
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


# The levels the dual strategy kernels hold in registers (decode_table.cuh):
# the deep set's (the longer codes) and the shallow set's.
DUAL_LEVELS = tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                                  (_kernels.CSRC / "decode_table.cuh").read_text()).group(1))
                    for name in ("kDeepLevels", "kShallowLevels"))
# the (word, separator) longest codes of each HuffWord seam case: at and one
# bit past each set's register levels (words even in the first, odd in the
# second)
HUFFWORD_SEAM_LIMITS = {"hw_at_depth_s4097": DUAL_LEVELS,
                        "hw_past_depth_s8191": (DUAL_LEVELS[0] + 1, DUAL_LEVELS[1] + 1)}
# name -> tokens per stream; HuffWord cases of K6 (lj and length tables),
# the pack and decode_streams_dual
HUFFWORD_BITSTREAM_CASES = {"hw_s16384": 1 << 14, "hw_odd_s1001": 1001,
                            "hw_nonword_s777": 777, "hw_one_token": 1 << 14,
                            "hw_bigvocab_s4097": 4097, "hw_deep32_s999": 999,
                            "hw_uniform8_s16384": 1 << 14, "hw_at_depth_s4097": 4097,
                            "hw_past_depth_s8191": 8191}
UNIFORM8_WORD_STREAMS = 64  # 2^20 tokens: 256 equiprobable words (8-bit codes), 1-3-bit separators


def huffword_bitstream_case(name: str):
    """(class-local token ids, word_first, [word, nonword] codebooks,
    n_word, n_nonword, S) of a HuffWord bitstream kernel case.  The deep32
    case draws tokens from made-up dictionaries whose word codes reach 32
    bits (no text has such a vocabulary at a test's size); the uniform8
    case from 256 equiprobable words and four separators of 1-3 bits, so
    the stream decode's guesses meet the true chain late; the seam cases
    from made-up dictionaries whose longest codes are HUFFWORD_SEAM_LIMITS'
    (the words drawn half from a geometric law, half evenly, so most of the
    latter are of the longest length)."""
    S = HUFFWORD_BITSTREAM_CASES[name]
    if name in HUFFWORD_SEAM_LIMITS:
        deep, shallow = HUFFWORD_SEAM_LIMITS[name]
        rng = np.random.default_rng(deep)
        cb_w = build_codebook(np.left_shift(1, np.maximum(40 - np.arange(200), 0)), deep)
        cb_n = build_codebook(np.left_shift(1, np.maximum(shallow - 1 - np.arange(shallow + 1),
                                                          0)), 32)
        require((cb_w.max_len, cb_n.max_len) == (deep, shallow),
                f"{name}: longest codes {cb_w.max_len} and {cb_n.max_len}")
        word_first = "at_depth" in name
        ids = rng.integers(0, shallow + 1, 30_001)
        words = ids[0 if word_first else 1::2]
        words[:] = np.where(rng.random(words.size) < 0.5,
                            np.minimum(rng.geometric(0.3, words.size) - 1, 199),
                            rng.integers(0, 200, words.size))
        return ids, word_first, [cb_w, cb_n], 200, shallow + 1, S
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
    ref = clock(out, "tokenize+vocab (numpy ref)", lambda: tok.build_vocabs_ref(data))
    require(same_vocabs(vocabs, ref), "tokenize+vocab: the host library differs from numpy")
    del ref
    _, _, wf, wv, nv, ids = vocabs
    clock(out, "codebooks",
          lambda: [build_codebook(v.counts, ke.MAX_FUSED_LEN) for v in (wv, nv)])
    ids16 = clock(out, "pad ids", lambda: np.concatenate(
        [ids.astype(np.uint16), np.zeros(-ids.size % group, np.uint16)]))
    ids_d = clock(out, "H2D ids", lambda: torch.from_numpy(ids16.view(np.int16)).to(dev))
    f = clock(out, "read container", lambda: container.read_container(blob))
    words = np.frombuffer(f.payload, dtype="<u4", count=len(f.payload) // 4)
    pay_d = clock(out, "H2D payload", lambda: i32_tensor(words, dev))
    clock(out, "D2H payload", lambda: pay_d.cpu())
    clock(out, "D2H ids", lambda: ids_d[: ids.size].cpu())
    back = clock(out, "detokenize", lambda: tok.detokenize(ids, wf, wv, nv))
    require(back == data, "detokenize: the host library's output differs from the input")
    del back
    back = clock(out, "detokenize (numpy ref)", lambda: tok.detokenize_ref(ids, wf, wv, nv))
    require(back == data, "detokenize_ref: output differs from the input")
    del back
    clock(out, "crc32", lambda: zlib.crc32(data))
    return out, vocabs


def same_vocabs(a, b) -> bool:
    """Two build_vocabs results are equal: token bounds, word_first, both
    vocabularies (text, offsets, counts) and the ids."""
    return (all(np.array_equal(np.asarray(x, np.int64), np.asarray(y, np.int64))
                for x, y in ((a[0], b[0]), (a[1], b[1]), (a[5], b[5])))
            and a[2] == b[2]
            and all(v.blob == w.blob and np.array_equal(v.offsets, w.offsets)
                    and np.array_equal(v.counts, w.counts) for v, w in ((a[3], b[3]), (a[4], b[4]))))


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


def cuda_spread(fn, reps: int = 5, singles: int = SINGLE_LAUNCHES) -> dict[str, float]:
    """fn() on the card (CUDA events) after one warm-up call: "mean_ms", the
    mean of `reps` calls back to back inside one event pair (cuda_ms), then
    `singles` calls each inside its own event pair, each started behind a
    spin kernel of ~1 ms so that the event pair times the device's work and
    not the host's launch: their median ("ms"), "min_ms" and "max_ms"."""
    mean = cuda_ms(fn, reps)
    times = []
    for _ in range(singles):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return {"ms": statistics.median(times), "min_ms": min(times), "max_ms": max(times),
            "mean_ms": mean}


def spread_text(t: dict[str, float]) -> str:
    return (f"{t['ms']:.3f} ms (median of {SINGLE_LAUNCHES}, {t['min_ms']:.3f}-"
            f"{t['max_ms']:.3f}; mean of 5 back to back {t['mean_ms']:.3f})")


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_name(mangled: str) -> str:
    """A readable name for a compiled kernel: the function and its template
    arguments (lanes per thread, blocks per group, bytes or dual, u16/u32
    element types)."""
    m = re.search(r"(lane_totals_entries_kernel|lane_totals_kernel|encode_entries_kernel|"
                  r"encode_kernel|decode_dual_kernel|decode_kernel|lut_gather_kernel|"
                  r"lookup_lj_lens_kernel|pack_scan_kernel|pack_tiles_kernel|"
                  r"decode_streams_sync_kernel|histogram_kernel)(I.*E)?", mangled)
    if not m:
        return mangled
    args = m.group(2) or ""
    widths = {"t": "u16", "j": "u32"}
    parts = re.findall(r"Li(\d+)E", args)
    flags = {"Lb1E": "dual", "Lb0E": "bytes"}
    parts += [v for k, v in flags.items() if k in args]
    if m.group(1) == "lut_gather_kernel":
        parts = [widths[c] for c in re.findall(r"[tj]", args[1:-1])]
    if m.group(1) == "decode_streams_sync_kernel" and len(parts) == 5:
        parts = parts[:3] + parts[4:] + [STRATEGIES[int(parts[3])]]  # ..., form, strategy
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
        times = cuda_spread(kernel)
        lib_ms = None
        if table is not None:
            idx = take_idx[site]
            lib_ms = cuda_spread(lambda: torch.take(table, idx))["ms"]
        b_ms, b_by = bound(nbytes, nops)
        print(f"time: {site} {spread_text(times)} (plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms by "
              f"{b_by}; {nbytes} B, {nops} ops"
              + (f"; torch.take {lib_ms:.3f} ms" if lib_ms is not None else "")
              + f") on {card}", flush=True)
        kname = site.split("/")[0]
        row = {"name": kname, "route": "cuda", "source": "glz_tpu_torch/csrc/lockstep.cu",
               "replaces": REPLACES[kname], "launches": launches[kname], "max_abs_err": err,
               **times, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms, "_bytes": nbytes, "_ops": nops}
        if kname == "lut_gather" and k6 is not None:
            for key in (*times, "plain_ms", "library_ms", "_bytes", "_ops"):
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
    hist = clock(out, "exact histogram", lambda: histogram_bytes(arr))
    ref = clock(out, "exact histogram (np.bincount ref)", lambda: np.bincount(arr, minlength=256))
    require(np.array_equal(hist, ref), "exact histogram: the host library differs from np.bincount")
    f = clock(out, "read container", lambda: container.read_container(blob))
    S = f.stream_symbols
    h2d = {}
    for lo in range(0, arr.size, (cb_model.MAX_DISPATCH_SYMBOLS // S) * S):
        chunk = arr[lo : lo + (cb_model.MAX_DISPATCH_SYMBOLS // S) * S]
        clock(h2d, "one", lambda: transfer.symbols_on(chunk, round_up(chunk.size, S), dev))
        out["pad + H2D symbols"] = out.get("pad + H2D symbols", 0.0) + h2d["one"]
    words_d = torch.empty(len(f.payload) // 4, dtype=torch.int32, device=dev)
    words = clock(out, "D2H payload", lambda: words_d.cpu().numpy().view(np.uint32))
    clock(out, "words_to_bytes", lambda: bitio.words_to_bytes(words, 32 * words.size - 3))
    clock(out, "bytes_to_words + H2D payload",
          lambda: i32_tensor(bitio.bytes_to_words(f.payload), dev))
    sym = torch.empty(arr.size, dtype=torch.uint8, device=dev)
    clock(out, "D2H symbols", lambda: sym.cpu())
    clock(out, "crc32", lambda: zlib.crc32(arr))
    clock(out, "host copy (tobytes)", lambda: arr.tobytes())
    return out


def measure(kname: str, kernel, plain_fn, nbytes: int, nops: int, launches: dict,
            card: str, library=None, check=None,
            source: str = "glz_tpu_torch/csrc/bitstream.cu") -> dict:
    """One bitstream kernel's row of the kernels line: its output against
    its plain version's on the same inputs (bit-exact) and `check`, then
    the times (CUDA events) of the kernel (cuda_spread), the plain version
    and, where given, one PyTorch call computing the same function (the
    median of cuda_spread)."""
    plain_ms, want = timed_once(plain_fn)
    got = kernel()
    err = max_abs_err(got, want)
    require(err == 0, f"main shape: {kname} differs from its plain version by {err}")
    if check is not None:
        check(got)
    del got, want
    times = cuda_spread(kernel)
    lib_ms = cuda_spread(library)["ms"] if library is not None else None
    b_ms, b_by = bound(nbytes, nops)
    print(f"time: {kname} {spread_text(times)} (plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms by "
          f"{b_by}; {nbytes} B, {nops} ops"
          + (f"; library {lib_ms:.3f} ms" if lib_ms is not None else "")
          + f") on {card}", flush=True)
    return {"name": kname, "route": "cuda", "source": source,
            "replaces": REPLACES[kname], "launches": launches[kname], "max_abs_err": err,
            **times, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
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
    words = i32_tensor(bitio.bytes_to_words(f.payload), dev)
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


def batch_run(label: str, files: list[bytes], compress, decompress, card: str,
              kernels: tuple[str, ...]):
    """One timed compress and decompress of a batch or an archive through the
    entry points, each ending in a synchronize, the launch counts zeroed
    just before and read just after, and peak device memory reset before.
    Fails unless the files come back and every kernel in `kernels` ran.
    Returns (compress's output, its size in bytes)."""
    n = sum(map(len, files))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = compress(files)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = decompress(out)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    launches = {k: v for k, v in _kernels.launch_counts().items() if v}
    require(back == files, f"{label}: round trip mismatch")
    require(all(k in launches for k in kernels), f"{label} missed a kernel: {launches}")
    size = len(out) if isinstance(out, bytes) else sum(map(len, out))
    print(f"batch: {label}, {len(files)} files, {n} B, on {card}: compress {t_c * 1e3:.1f} ms "
          f"({n / t_c / 1e9:.3f} GB/s), decompress {t_d * 1e3:.1f} ms ({n / t_d / 1e9:.3f} "
          f"GB/s), output {size} B (ratio {size / n:.4f}), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, launches {launches}",
          flush=True)
    return out, size


def batch_phase(card: str, members: dict[str, bytes]) -> None:
    """Phase 4e: the multi-file batch, the shared-codebook batch and the
    .glzb archive on the SILESIA members."""
    files = list(members.values())
    per_file = {}
    for preset, kernels in (("THROUGHPUT", BYTE_KERNELS), ("DEFAULT", BITSTREAM_KERNELS)):
        pconf = getattr(cfg, preset)
        blobs = []
        for pipeline in (True, False, False, True):  # in turns
            out, size = batch_run(
                f"compress_batch/decompress_batch {preset} pipeline={pipeline}", files,
                lambda fs: gt.compress_batch(fs, conf=pconf, pipeline=pipeline),
                lambda bs: gt.decompress_batch(bs, pipeline=pipeline), card, kernels)
            blobs.append(out)
        require(all(b == blobs[0] for b in blobs),
                f"compress_batch {preset}: the pipelined containers differ from the serial")
        per_file[preset] = size
        del blobs, out
    batch_run("compress_batch THROUGHPUT shared_codebook", files,
              lambda fs: gt.compress_batch(fs, conf=cfg.THROUGHPUT, shared_codebook=True),
              gt.decompress_batch, card, BYTE_KERNELS)
    batch_run("compress_batch DEFAULT shared_codebook backend='device'", files,
              lambda fs: gt.compress_batch(fs, backend="device", shared_codebook=True),
              gt.decompress_batch, card, BITSTREAM_KERNELS)
    for preset, kernels in (("THROUGHPUT", BYTE_KERNELS), ("DEFAULT", BITSTREAM_KERNELS)):
        pconf = getattr(cfg, preset)
        _, size = batch_run(f"compress_archive/decompress_archive {preset}", files,
                            lambda fs: gt.compress_archive(fs, conf=pconf),
                            gt.decompress_archive, card, kernels)
        print(f"archive: {preset} {size} B against {per_file[preset]} B of per-file "
              f"containers ({size - per_file[preset]:+d} B)", flush=True)
    hw_files = [members[k] for k in HUFFWORD_ARCHIVE_MEMBERS]
    del files
    hconf = huffword_conf()
    _, size = batch_run(
        f"compress_archive/decompress_archive HuffWord S {hconf.stream_symbols} rows "
        f"{hconf.group_rows} ({', '.join(HUFFWORD_ARCHIVE_MEMBERS)})", hw_files,
        lambda fs: gt.compress_archive(fs, mode=cfg.MODE_HUFFWORD, conf=hconf),
        gt.decompress_archive, card, HUFFWORD_KERNELS)
    per = sum(map(len, gt.compress_batch(hw_files, mode=cfg.MODE_HUFFWORD, conf=hconf)))
    print(f"archive: HuffWord {size} B against {per} B of per-file containers "
          f"({size - per:+d} B)", flush=True)


# ---- 4f. the command line ----------------------------------------------------

def cli_runs() -> dict[str, tuple[list[str], tuple[int, str, cfg.GlzConfig], tuple[str, ...]]]:
    """Phase 4f's compress runs at each main path's width: name -> (the
    command line's options, (mode, backend, conf) of the same API call, the
    kernels of the path)."""
    return {
        "defaults": ([], (cfg.MODE_BYTE, "host", cfg.DEFAULT), BITSTREAM_KERNELS),
        "throughput": (["--preset", "throughput"], (cfg.MODE_BYTE, "host", cfg.THROUGHPUT),
                       BYTE_KERNELS),
        "huffword": (["--model", "huffword"], (cfg.MODE_HUFFWORD, "host", cfg.DEFAULT),
                     HUFFWORD_BITSTREAM_KERNELS),
        "huffword_device": (["--model", "huffword", "--backend", "device", "--stream-symbols",
                             "512", "--group-rows", "32"],
                            (cfg.MODE_HUFFWORD, "device",
                             dataclasses.replace(cfg.DEFAULT, stream_symbols=512, group_rows=32)),
                            HUFFWORD_KERNELS),
    }


def cli_pinned() -> dict[tuple[str, ...], str]:
    """Compress options -> the pinned digest (phase 6) of the .glz the
    command line writes for tests/fixtures/realtext.txt[:1 MiB]."""
    hw_device = ("--model", "huffword", "--backend", "device", "--stream-symbols", "512",
                 "--group-rows", "32", "--checksum")
    return {("--checksum",): BITSTREAM_PINNED["byte_default_host"],
            ("--backend", "device", "--checksum"): BITSTREAM_PINNED["byte_default"],
            ("--preset", "ratio", "--backend", "device", "--checksum"):
                BITSTREAM_PINNED["byte_ratio"],
            ("--preset", "throughput", "--checksum"): PINNED["throughput"],
            ("--model", "huffword", "--checksum"): BITSTREAM_PINNED["hw_default"],
            hw_device: HUFFWORD_PINNED["hw_s512_r32"],
            ("--model", "normal_tree"): ARCHIVE_PINNED["normal_tree"]}


def cli_archive_pinned() -> dict[tuple[str, ...], str]:
    """Archive options -> the pinned digest of the archive of
    quarters(realtext.txt[:1 MiB])."""
    return {(): ARCHIVE_PINNED["archive_byte_default"],
            ("--preset", "throughput"): ARCHIVE_PINNED["archive_byte_throughput"],
            ("--model", "huffword", "--layout", "lockstep", "--stream-symbols", "64"):
                ARCHIVE_PINNED["archive_hw_s64"]}


def sha(data: bytes | pathlib.Path) -> str:
    return hashlib.sha256(data.read_bytes() if isinstance(data, pathlib.Path) else data
                          ).hexdigest()


def run_cli(*argv) -> tuple[float, str]:
    """cli.main(argv) in this process (so that its launches are counted),
    ending in a synchronize: (wall seconds, what it printed).  Fails unless
    it exits with 0."""
    argv = [str(a) for a in argv]
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(rc == 0, f"cli {' '.join(argv)}: exit code {rc}")
    return dt, out.getvalue().strip()


def cli_round_trip(d: pathlib.Path, name: str, src: pathlib.Path, opts: list[str], api,
                   kernels: tuple[str, ...], card: str) -> None:
    """compress and decompress `src` with the command line, launch counts
    zeroed just before and read just after, peak device memory reset
    before; then info --stats.  The .glz must equal api() (the API's
    container for the same call), the .de the input, and every kernel of
    `kernels` must have run."""
    out = d / f"{name}.glz"
    n = src.stat().st_size
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t_c, said_c = run_cli("compress", src, out, *opts)
    t_d, said_d = run_cli("decompress", out)
    launches = {k: v for k, v in _kernels.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    require(all(k in launches for k in kernels), f"cli {name} missed a kernel: {launches}")
    require(sha(d / f"{name}.glz.de") == sha(src), f"cli {name}: the .de differs from the input")
    require(sha(out) == sha(api()), f"cli {name}: the .glz differs from the API's container")
    _, info = run_cli("info", out, "--stats")
    said_c, said_d = (said.replace(f"{d}/", "") for said in (said_c, said_d))
    print(f"cli: {name} ({' '.join(opts) or 'defaults'}), {n} B, on {card}: compress "
          f"{t_c * 1e3:.1f} ms wall ({n / t_c / 1e9:.3f} GB/s), decompress {t_d * 1e3:.1f} ms "
          f"wall ({n / t_d / 1e9:.3f} GB/s), peak device memory {peak / 2**20:.0f} MiB, "
          f"launches {launches}; .glz = API's, .de = input; it printed: {said_c} | {said_d}; "
          f"info --stats: {info.splitlines()[0]} ({len(info.splitlines())} lines)", flush=True)
    out.unlink()
    (d / f"{name}.glz.de").unlink()


def cli_archive_round_trip(d: pathlib.Path, label: str, files: dict[str, bytes],
                           opts: tuple[str, ...], want: str | None, card: str,
                           kernels: tuple[str, ...] = ()) -> None:
    """archive and unarchive `files` with the command line; the .glzb must
    have the digest `want` (or, for None, the API's compress_archive's for
    the same call), the outputs must equal the files and every kernel of
    `kernels` must have run; then info."""
    srcs = []
    for k, (name, data) in enumerate(files.items()):
        srcs.append(d / f"{label}.{k}.{name}")
        srcs[-1].write_bytes(data)
    arc = d / f"{label}.glzb"
    outs = [p.with_suffix(".out") for p in srcs]
    n = sum(map(len, files.values()))
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t_c, said_c = run_cli("archive", arc, *srcs, *opts)
    t_d, said_d = run_cli("unarchive", arc, *outs)
    launches = {k: v for k, v in _kernels.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    require(all(k in launches for k in kernels), f"cli {label} missed a kernel: {launches}")
    require(all(o.read_bytes() == data for o, data in zip(outs, files.values())),
            f"cli {label}: unarchive differs from the inputs")
    if want is None:  # the API's archive for the same call (no options: the defaults)
        require(not opts, f"cli {label}: no API call is set for options {opts}")
        want = sha(gt.compress_archive(list(files.values())))
    require(sha(arc) == want, f"cli {label}: the .glzb has digest {sha(arc)}, not {want}")
    _, info = run_cli("info", arc)
    said_c, said_d = (said.replace(f"{d}/", "") for said in (said_c, said_d))
    print(f"cli: {label} archive ({' '.join(opts) or 'defaults'}), {len(files)} files, {n} B, "
          f"on {card}: archive {t_c * 1e3:.1f} ms wall ({n / t_c / 1e9:.3f} GB/s), unarchive "
          f"{t_d * 1e3:.1f} ms wall ({n / t_d / 1e9:.3f} GB/s), peak device memory "
          f"{peak / 2**20:.0f} MiB, launches {launches}; it printed: {said_c} | {said_d}; "
          f"info: {info.splitlines()[0]}", flush=True)
    for path in (arc, *srcs, *outs):
        path.unlink()


def cli_phase(card: str, arr: np.ndarray, text: bytes, members: dict[str, bytes]) -> None:
    """Phase 4f: the command line on every path (cli_runs, the archive,
    the realtext cases, one subprocess)."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        corpus, words = d / "corpus.bin", d / "text.txt"
        arr.tofile(corpus)
        words.write_bytes(text)
        for name, (opts, (mode, backend, conf), kernels) in cli_runs().items():
            hw = mode == cfg.MODE_HUFFWORD
            cli_round_trip(d, name, words if hw else corpus, opts,
                           lambda: gt.compress(text if hw else arr, mode=mode, backend=backend,
                                               conf=conf), kernels, card)
        corpus.unlink()
        words.unlink()
        cli_archive_round_trip(d, "silesia", members, (), None, card, BITSTREAM_KERNELS)

        real = (ROOT / "tests" / "fixtures" / "realtext.txt").read_bytes()[: 1 << 20]
        rt = d / "realtext.txt"
        rt.write_bytes(real)
        for opts, want in cli_pinned().items():
            run_cli("compress", rt, d / "rt.glz", *opts)
            run_cli("decompress", d / "rt.glz")
            run_cli("info", d / "rt.glz", "--stats")
            require(sha(d / "rt.glz") == want, f"cli {' '.join(opts)}: digest {sha(d / 'rt.glz')}")
            require((d / "rt.glz.de").read_bytes() == real, f"cli {' '.join(opts)}: round trip")
        quarters_of = {f"q{k}": q for k, q in enumerate(quarters(real))}
        for opts, want in cli_archive_pinned().items():
            cli_archive_round_trip(d, "realtext", quarters_of, opts, want, card)
        for mode, suffix, write in ((3, ".crs2", glzip_format.write_crs2),
                                    (1, ".crs", glzip_format.write_crs)):
            run_cli("utet", rt, mode)
            require(sha(d / f"realtext.txt{suffix}") == sha(write(real)),
                    f"utet {mode}: the {suffix} differs from the API's")
            for back in ((4, 5, 6) if mode == 3 else (2,)):
                (d / f"realtext.txt{suffix}.de").unlink(missing_ok=True)
                run_cli("utet", d / f"realtext.txt{suffix}", back)
                require((d / f"realtext.txt{suffix}.de").read_bytes() == real,
                        f"utet {back}: output differs from the input")
        run_cli("compress", rt, "--compat", "crs3")
        run_cli("decompress", d / "realtext.txt.crs3")
        require(sha(d / "realtext.txt.crs3") == sha(glzip_format.write_crs3(real))
                and (d / "realtext.txt.crs3.de").read_bytes() == real, "cli --compat crs3")
        print(f"cli: on realtext.txt[:1 MiB] on {card}: {len(cli_pinned())} .glz and "
              f"{len(cli_archive_pinned())} .glzb match the pinned digests and round-trip; "
              f"utet 1-6 and --compat crs3 write the API's files and read them back",
              flush=True)

        t0 = time.perf_counter()
        for argv in (["compress", rt, d / "sub.glz"], ["decompress", d / "sub.glz"]):
            r = subprocess.run([sys.executable, "-m", "glz_tpu_torch.cli", *map(str, argv)],
                               cwd=ROOT, capture_output=True, text=True, timeout=600)
            require(r.returncode == 0, f"python -m glz_tpu_torch.cli {argv[0]}: {r.returncode}"
                                       f"\n{r.stderr}")
        require(sha(d / "sub.glz") == sha(gt.compress(real))
                and (d / "sub.glz.de").read_bytes() == real, "python -m glz_tpu_torch.cli")
        print(f"cli: python -m glz_tpu_torch.cli compress + decompress of realtext.txt[:1 MiB] "
              f"in two processes on {card}: {time.perf_counter() - t0:.1f} s wall (process "
              f"start and CUDA set-up included); .glz = API's, .de = input", flush=True)
    print(f"cli: phase 4f took {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---- 5. the histogram kernel at the main corpus ---------------------------------

def histogram_kernel_time(arr: np.ndarray, dev: torch.device, card: str) -> dict:
    """The histogram kernel's row of the kernels line at the 512 MiB corpus:
    against its plain version (index_add_), torch.bincount (its library
    time), the host library and np.bincount, all equal.  Its launches come
    from phase 7b's sharded_histogram."""
    sym = torch.from_numpy(arr).to(dev)
    t0 = time.perf_counter()
    host = histogram_bytes(arr)
    host_ms = (time.perf_counter() - t0) * 1e3
    want = np.bincount(arr, minlength=256)
    require(np.array_equal(host, want), "histogram: the host library differs from np.bincount")

    def check(got):
        require(np.array_equal(got.cpu().numpy(), want), "histogram: differs from np.bincount")
        require(torch.equal(got, torch.bincount(sym, minlength=256)),
                "histogram: differs from torch.bincount")

    row = measure("histogram", lambda: hist_ops.histogram(sym),
                  lambda: hist_ops.histogram_ref(sym), arr.size + 8 * 256, arr.size,
                  {"histogram": 0}, card, library=lambda: torch.bincount(sym, minlength=256),
                  check=check, source="glz_tpu_torch/csrc/histogram.cu")
    print(f"time: histogram of {arr.size >> 20} MiB in the host library {host_ms:.1f} ms "
          f"(the models' exact histogram, core/codebook.histogram_bytes)", flush=True)
    return row


# ---- 7. the device mesh and the multi-process paths ------------------------------

def mesh_phase(card: str, arr: np.ndarray, dev: torch.device) -> dict:
    """7b: the mesh at world size 1 (NCCL) in this process: sharded_histogram
    on the corpus, lockstep_codec_step at THROUGHPUT's geometry with and
    without max_bits_per_symbol (its group table and group words against
    compress_bytes_lockstep's container with the same codebook), the
    too-tight bound, codec_step at S 2^18 in dispatches of 2^27; then the
    dry run on every card.  Returns the histogram's launches."""
    import torch.distributed as dist

    n = arr.size
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{ranks.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = pmesh.make_mesh(1)
        sym = torch.from_numpy(arr).to(dev)
        want = histogram_bytes(arr)
        # the first collective sets NCCL up; time it apart from the main run
        first_ms, _ = timed_once(lambda: pmesh.sharded_histogram(mesh, sym[:4096]))
        _kernels.reset_launch_counts()
        ms, h = timed_once(lambda: pmesh.sharded_histogram(mesh, sym))
        hist_launches = _kernels.launch_counts()
        require(np.array_equal(h.cpu().numpy(), want), "sharded_histogram != np.bincount")
        require(hist_launches["histogram"] == 1, f"sharded_histogram launches {hist_launches}")
        print(f"mesh: world size 1 (NCCL) on {card}: sharded_histogram of {n >> 20} MiB "
              f"{ms:.3f} ms (the first call, on 4 KiB, {first_ms:.1f} ms with NCCL's set-up), "
              f"equal to the host library's; launches "
              f"{ {k: v for k, v in hist_launches.items() if v} }", flush=True)

        conf = dataclasses.replace(cfg.THROUGHPUT, histogram_budget=None)
        S, rows = conf.stream_symbols, conf.group_rows
        cb = build_codebook(want, lockstep.fused_length_limit(conf))
        f = container.read_container(cb_model.compress_bytes_lockstep(arr, conf))
        cont = i32_tensor(np.frombuffer(f.payload, "<u4"), dev)
        seg = np.cumsum(f.stream_bits.astype(np.int64)) - f.stream_bits.astype(np.int64)
        args = (mesh, sym, n, entry_table(cb, dev), *decode_tables(cb, dev), S, cb.min_len,
                cb.max_len)
        for mbps in (None, 6):
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            payload, gw_all, out = pmesh.lockstep_codec_step(*args, rows=rows,
                                                             max_bits_per_symbol=mbps)
            torch.cuda.synchronize()
            t = (time.perf_counter() - t0) * 1e3
            launches = {k: v for k, v in _kernels.launch_counts().items() if v}
            require(torch.equal(out, sym), f"lockstep_codec_step (bound {mbps}): round trip")
            gw = gw_all.cpu().numpy()
            padded, _ = ke.group_layout(gw)
            require(np.array_equal(padded, f.stream_bits), "lockstep_codec_step: group table "
                    "differs from compress_bytes_lockstep's")
            stride = payload.numel() // gw.size
            require(all(torch.equal(payload[g * stride : g * stride + int(gw[g])],
                                     cont[seg[g] : seg[g] + int(gw[g])])
                        for g in range(gw.size)),
                    "lockstep_codec_step: group words differ from compress_bytes_lockstep's")
            print(f"mesh: lockstep_codec_step {n >> 20} MiB S {S} rows {rows} ({gw.size} "
                  f"groups), max_bits_per_symbol {mbps}: {t:.1f} ms (payload "
                  f"{payload.numel() * 4 >> 20} MiB), group table and words equal to "
                  f"compress_bytes_lockstep's, round trip exact; launches {launches} on {card}",
                  flush=True)
            del payload, out
        try:
            pmesh.lockstep_codec_step(*args, rows=rows, max_bits_per_symbol=1)
            raise RuntimeError("lockstep_codec_step: max_bits_per_symbol=1 did not raise")
        except ValueError as e:
            require("too tight" in str(e), f"lockstep_codec_step: {e}")

        bcb = build_codebook(want, cfg.DEFAULT.length_limit)
        tables = (i32_tensor(bcb.left_justified_codes(), dev), i32_tensor(bcb.lengths, dev),
                  *decode_tables(bcb, dev), bcb.min_len, bcb.max_len)
        S, step = cfg.DEFAULT.stream_symbols, cb_model.MAX_DISPATCH_SYMBOLS
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        bits = 0
        for lo in range(0, n, step):
            part = sym[lo : lo + step]
            _, total_bits, _, out = pmesh.codec_step(mesh, part, part.numel(), *tables, S)
            require(torch.equal(out, part), f"codec_step: round trip at {lo}")
            bits += total_bits
        torch.cuda.synchronize()
        t = (time.perf_counter() - t0) * 1e3
        print(f"mesh: codec_step {n >> 20} MiB S {S} in {-(-n // step)} dispatches: {t:.1f} ms "
              f"({bits} bits), round trip exact; launches "
              f"{ {k: v for k, v in _kernels.launch_counts().items() if v} } on {card}",
              flush=True)
        del sym, cont
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        dryrun.dryrun_multichip(torch.cuda.device_count())
    print(f"mesh: {'; '.join(said.getvalue().strip().splitlines())} "
          f"({time.perf_counter() - t0:.1f} s, a spawned rank a card)", flush=True)
    return hist_launches


def _shard_of(path: str, bounds: list[int]) -> bytes:
    pid = multihost.process_index()
    with open(path, "rb") as fh:
        fh.seek(bounds[pid])
        return fh.read(bounds[pid + 1] - bounds[pid])


def multihost_rank(paths: dict, bounds: dict, confs: dict) -> dict:
    """One of phase 7c's processes, sharing the card with the others: each
    compress path on its shard (process 0 writes the container), then both
    multi-process decodes, each process writing its slice at its offset.
    Returns each step's milliseconds (compress, the payload and table
    gathers, process 0's stitch; decode), launch counts and peak device
    memory."""
    pid = multihost.process_index()
    gathers = {"ms": 0.0, "end": 0.0}
    gather = multihost._gather_ragged

    def timed_gather(a):
        t0 = time.perf_counter()
        try:
            return gather(a)
        finally:
            gathers["end"] = time.perf_counter()
            gathers["ms"] += (gathers["end"] - t0) * 1e3

    multihost._gather_ragged = timed_gather
    out = {}

    def step(label, fn):
        multihost._allgather([0])  # start together
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        gathers.update(ms=0.0, end=0.0)
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec = {"ms": (t1 - t0) * 1e3, "gather_ms": gathers["ms"],
               "launches": {k: v for k, v in _kernels.launch_counts().items() if v},
               "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
        if pid == 0 and isinstance(r, bytes):
            rec["stitch_ms"] = (t1 - gathers["end"]) * 1e3
        out[label] = rec
        return r

    for label, (src, fn) in {"lockstep": ("corpus", multihost.compress_bytes_multihost),
                             "bitstream": ("corpus", multihost.compress_bytes_multihost),
                             "huffword": ("text", multihost.compress_huffword_multihost)}.items():
        shard = _shard_of(paths[src], bounds[label])
        blob = step(label, lambda: fn(shard, confs[label]))
        if pid == 0:
            pathlib.Path(paths[label]).write_bytes(blob)
        del shard, blob
    for label, src, fn in (("decode lockstep", "lockstep", multihost.decompress_bytes_multihost),
                           ("decode huffword", "huffword",
                            multihost.decompress_huffword_multihost)):
        multihost._allgather([0])  # process 0 has written the container
        blob = pathlib.Path(paths[src]).read_bytes()
        local, off = step(label, lambda: fn(blob))
        fd = os.open(paths[f"{src}.out"], os.O_WRONLY)
        try:
            os.pwrite(fd, local, off)
        finally:
            os.close(fd)
        out[label]["bytes"] = len(local)
    return out


# Each multi-process step's kernels, which every process must launch.
MULTIHOST_KERNELS = {"lockstep": ("lane_totals", "encode_groups"),
                     "bitstream": ("lookup_lj_lens", "pack_scan", "pack_tiles"),
                     "huffword": ("lut_gather", "lane_totals_entries", "encode_entries"),
                     "decode lockstep": ("decode_groups",),
                     "decode huffword": ("decode_dual", "lut_gather")}


def multihost_phase(card: str, arr: np.ndarray, text: bytes) -> None:
    """7c: two processes sharing the card, gloo for the gathers: the 512 MiB
    corpus through compress_bytes_multihost under THROUGHPUT (64 groups a
    shard) and DEFAULT (S 2^18 shards), phase 4b's text through
    compress_huffword_multihost (S 512, rows capped to 16, shards from
    split_huffword_shards), then both multi-process decodes.  Each
    container round-trips through decompress in this process, each
    assembled output equals its input, the stitched crc32s are zlib's, and
    the lockstep container is compress_bytes_lockstep's with an exact
    histogram and the HuffWord one compress's at rows 16, byte for byte;
    the same single-process calls are timed."""
    n = arr.size
    confs = {"lockstep": dataclasses.replace(cfg.THROUGHPUT, checksum=True),
             "bitstream": dataclasses.replace(cfg.DEFAULT, checksum=True),
             "huffword": huffword_conf(512, 32)}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rows_hw = multihost.huffword_multihost_rows(confs["huffword"])
        t0 = time.perf_counter()
        text_bounds = multihost.split_huffword_shards(text, 2, confs["huffword"])
        split_ms = (time.perf_counter() - t0) * 1e3
    require(rows_hw == 16 and caught, f"huffword_multihost_rows: {rows_hw}")
    group = cfg.THROUGHPUT.group_rows * LANES * cfg.THROUGHPUT.stream_symbols
    bounds = {"lockstep": [0, n // 2 // group * group, n],
              "bitstream": [0, n // 2 // cfg.DEFAULT.stream_symbols * cfg.DEFAULT.stream_symbols,
                            n],
              "huffword": text_bounds}
    with tempfile.TemporaryDirectory(prefix="glz_smoke_") as tmp:
        paths = {k: os.path.join(tmp, k) for k in ("corpus", "text", "lockstep", "bitstream",
                                                   "huffword", "lockstep.out", "huffword.out")}
        arr.tofile(paths["corpus"])
        pathlib.Path(paths["text"]).write_bytes(text)
        for k, size in (("lockstep.out", n), ("huffword.out", len(text))):
            with open(paths[k], "wb") as fh:
                fh.truncate(size)
        t0 = time.perf_counter()
        got = ranks.run(f"{ROOT / 'chip_smoke.py'}:multihost_rank", 2, paths, bounds, confs,
                        timeout=600)
        wall = time.perf_counter() - t0
        for pid, rec in enumerate(got):
            print(f"multihost: process {pid} of 2 on {card}: " + "; ".join(
                f"{k} {v['ms']:.1f} ms (gathers {v['gather_ms']:.1f}"
                + (f", stitch {v['stitch_ms']:.1f}" if "stitch_ms" in v else "")
                + (f", {v['bytes']} B out" if "bytes" in v else "")
                + f"; peak device memory {v['peak_mib']:.0f} MiB; launches {v['launches']})"
                for k, v in rec.items()), flush=True)
        for step, kernels in MULTIHOST_KERNELS.items():
            require(all(all(rec[step]["launches"].get(k) for k in kernels) for rec in got),
                    f"multihost {step}: a process missed a kernel of {kernels}")
        inputs = {"lockstep": arr, "bitstream": arr, "huffword": text}
        for label, data in inputs.items():
            blob = pathlib.Path(paths[label]).read_bytes()
            f = container.read_container(blob)
            raw = data.tobytes() if isinstance(data, np.ndarray) else data
            require(f.checksum == zlib.crc32(raw), f"multihost {label}: stitched crc32")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            require(gt.decompress(blob) == raw, f"multihost {label}: single-process decode")
            t_d = (time.perf_counter() - t0) * 1e3
            single = {"lockstep": lambda: cb_model.compress_bytes_lockstep(
                          arr, dataclasses.replace(confs["lockstep"], histogram_budget=None)),
                      "bitstream": lambda: gt.compress(arr, conf=confs["bitstream"]),
                      "huffword": lambda: gt.compress(
                          text, mode=cfg.MODE_HUFFWORD,
                          conf=dataclasses.replace(confs["huffword"], group_rows=16))}[label]
            t0 = time.perf_counter()
            one = single()
            torch.cuda.synchronize()
            t_c = (time.perf_counter() - t0) * 1e3
            same = one == blob
            if label != "bitstream":  # its shards end on whole bytes, one stream does not
                require(same, f"multihost {label}: not the single-process container")
            print(f"multihost: {label} container {len(blob)} B ("
                  + (f"group rows {f.group_rows}, {f.n_streams} groups" if f.layout
                     else f"{f.n_streams} streams") + "), crc32 zlib's, "
                  f"decompress in one process {t_d:.1f} ms exact; one process compresses the "
                  f"same input in {t_c:.1f} ms, {'the same' if same else 'another'} container "
                  f"({len(one)} B)", flush=True)
            del blob, one
        for label, data in (("lockstep", arr), ("huffword", text)):
            back = pathlib.Path(paths[f"{label}.out"]).read_bytes()
            raw = data.tobytes() if isinstance(data, np.ndarray) else data
            require(back == raw, f"multihost decode {label}: assembled output differs")
    print(f"multihost: 2 processes sharing {card}: 3 containers and 2 assembled decodes "
          f"exact; shards {bounds}; split_huffword_shards {split_ms:.1f} ms; rows {rows_hw} "
          f"(huffword_multihost_rows); {wall:.1f} s with the processes' start", flush=True)


# ---- 8. device traces of the four main paths -----------------------------------

TRACE_DIR = ROOT / "build" / "traces"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # work on the card's engines
HOST_CATS = ("cpu_op", "cuda_runtime")  # CPU-side events that can cover a gap
# The port's kernels (function names in csrc/) by the wrapper that launches
# them, one kernel a launch; decode_streams_sync_kernel is both stream
# decodes, <bytes> (template argument false) and <dual> (true), in each
# strategy (its fifth template argument; the table where it is absent).
WRAPPER_OF_KERNEL = {
    "lane_totals_entries_kernel": "lane_totals_entries", "lane_totals_kernel": "lane_totals",
    "encode_entries_kernel": "encode_entries", "encode_kernel": "encode_groups",
    "decode_dual_kernel": "decode_dual", "decode_kernel": "decode_groups",
    "lut_gather_kernel": "lut_gather", "lookup_lj_lens_kernel": "lookup_lj_lens",
    "pack_scan_kernel": "pack_scan", "pack_tiles_kernel": "pack_tiles",
    "decode_streams_sync_kernel": "decode_streams", "histogram_kernel": "histogram",
}


def wrapper_of(kernel: str) -> str | None:
    """The port's wrapper that launches a traced kernel, from its mangled or
    demangled name; None for any other kernel."""
    for fn, wrapper in WRAPPER_OF_KERNEL.items():
        m = re.search(rf"(?<![A-Za-z_]){fn}", kernel)
        if m:
            if wrapper == "decode_streams":  # its template arguments, demangled or not
                rest = kernel[m.end():]
                listed = re.match(r"<([^>]*)>", rest)
                args = ([a.strip() for a in listed.group(1).split(",")] if listed else
                        re.findall(r"L[bi](\d+)E", re.match(r"(I(L[bi]\d+E)*)?", rest)[0]))
                strategy = STRATEGIES[int(args[4])] if len(args) > 4 else "table"
                return STREAM_DECODES[(args[:1] in (["1"], ["true"]), strategy)]
            return wrapper
    return None


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _op_name(e: dict) -> str:
    """A device event's name in the summary: the port's wrapper for its
    kernels, the function without template arguments for other kernels."""
    if e["cat"] != "kernel":
        return e["name"]
    return wrapper_of(e["name"]) or e["name"].removeprefix("void ").split("<")[0].split("(")[0]


def trace_summary(trace: dict, span: str) -> dict:
    """What a Chrome trace of torch.profiler says of the record_function
    span `span` (on the trace's one clock, microseconds; results in ms):
    the window (the span's duration); kernel-busy, the union of the kernel
    events inside it; device-busy, the union of kernel, copy and memset
    events; both idle shares (1 - busy / window); the five device
    operations with the most time inside it (name, count, ms); the three
    longest gaps with no device event (ms, and the innermost CPU-side event
    covering the gap's midpoint, or "host (untraced)"); and the port's
    kernel events in the whole trace by wrapper."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == span]
    require(len(spans) == 1, f"trace: {len(spans)} spans named {span!r}")
    w0, w1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    require(w1 > w0, f"trace: span {span!r} has no duration")
    device = []
    for e in events:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if e.get("cat") in DEVICE_CATS and b > a:
            device.append((a, b, e))
    kernel_busy = _union([(a, b) for a, b, e in device if e["cat"] == "kernel"])
    device_busy = _union([(a, b) for a, b, _ in device])
    ops: dict[str, list] = {}
    for a, b, e in device:
        op = ops.setdefault(_op_name(e), [0, 0.0])
        op[0] += 1
        op[1] += b - a
    gaps, t = [], w0
    for a, b in device_busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if w1 > t:
        gaps.append((t, w1))
    host = [e for e in events if e.get("cat") in HOST_CATS]

    def cover(mid: float) -> str:
        over = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        return min(over, key=lambda e: e["dur"])["name"] if over else "host (untraced)"

    window = w1 - w0
    port: dict[str, int] = {}
    for e in events:
        wrapper = wrapper_of(e["name"]) if e.get("cat") == "kernel" else None
        if wrapper:
            port[wrapper] = port.get(wrapper, 0) + 1
    return {
        "window_ms": window / 1e3,
        "kernel_ms": sum(b - a for a, b in kernel_busy) / 1e3,
        "device_ms": sum(b - a for a, b in device_busy) / 1e3,
        "kernel_idle": 1 - sum(b - a for a, b in kernel_busy) / window,
        "device_idle": 1 - sum(b - a for a, b in device_busy) / window,
        "top": [(name, c, ms / 1e3) for name, (c, ms)
                in sorted(ops.items(), key=lambda kv: (-kv[1][1], kv[0]))[:5]],
        "gaps": [((b - a) / 1e3, cover((a + b) / 2))
                 for a, b in sorted(gaps, key=lambda g: (g[0] - g[1], g[0]))[:3]],
        "port_kernels": port,
    }


def trace_line(label: str, s: dict) -> str:
    return (f"trace: {label}: window {s['window_ms']:.3f} ms; kernel-busy "
            f"{s['kernel_ms']:.3f} ms, device-busy {s['device_ms']:.3f} ms; idle (kernels) "
            f"{s['kernel_idle']:.4%}, idle (kernels, copies, memsets) {s['device_idle']:.4%}; "
            f"top device operations: "
            + ", ".join(f"{name} x{c} {ms:.3f} ms" for name, c, ms in s["top"])
            + "; longest gaps: "
            + ", ".join(f"{ms:.3f} ms under {label_}" for ms, label_ in s["gaps"]))


def trace_phase(card: str, arr: np.ndarray, text: bytes, digests: dict[str, str]) -> None:
    """Phase 8: each main path's compress and decompress, apart, each inside
    a timer.Profiler phase, inside timer.device_trace(build/traces/<path>_
    <direction>), inside a record_function span named for the call that
    ends in a synchronize.  Each container must be the one the untraced
    call of phases 4-4d wrote (`digests`), each round trip exact, and each
    port kernel's events in a trace as many as its launches in the call."""
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    prof = Profiler()
    byte_default = dataclasses.replace(cfg.DEFAULT, checksum=True)
    paths = {  # name -> (input, mode, conf, backend)
        "byte_lockstep": (arr, cfg.MODE_BYTE, dataclasses.replace(cfg.THROUGHPUT, checksum=True),
                          "host"),
        "huffword_lockstep": (text, cfg.MODE_HUFFWORD, huffword_conf(), "host"),
        "byte_bitstream": (arr, cfg.MODE_BYTE, byte_default, "host"),
        "huffword_bitstream": (text, cfg.MODE_HUFFWORD, byte_default, "host"),
    }

    def traced(label: str, nbytes: int, fn):
        _kernels.reset_launch_counts()
        with device_trace(TRACE_DIR / label) as trace:
            with prof.phase(label, nbytes):
                with torch.profiler.record_function(label):
                    result = fn()
                    torch.cuda.synchronize()
        launches = {k: v for k, v in _kernels.launch_counts().items() if v}
        s = trace_summary(json.loads(trace.file.read_text()), label)
        require(launches and s["port_kernels"] == launches,
                f"trace {label}: kernel events {s['port_kernels']} != launches {launches}")
        print(f"{trace_line(label, s)}; port kernel events = launches {launches}; "
              f"{trace.file.relative_to(ROOT)} ({trace.file.stat().st_size} B) on {card}",
              flush=True)
        return result

    t0 = time.perf_counter()
    for name, (data, mode, conf, backend) in paths.items():
        raw = data.tobytes() if isinstance(data, np.ndarray) else data
        blob = traced(f"{name}_compress", len(raw),
                      lambda: gt.compress(data, mode=mode, backend=backend, conf=conf))
        require(sha(blob) == digests[name],
                f"trace {name}: the container differs from the untraced call's")
        out = traced(f"{name}_decompress", len(raw), lambda: gt.decompress(blob))
        require(out == raw, f"trace {name}: round trip mismatch")
        del raw, blob, out
    print("profile: phase 8's traced calls (host clock, the profiler on):\n" + prof.report(),
          flush=True)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s", flush=True)


# ---- 9. the decoder strategies ---------------------------------------------------

class LevelsBuild:
    """The counting build of the strategy kernels, byte and dual: the
    "levels" variant of csrc/bitstream.cu that tools/stream_decode_phases.py
    makes, its nvcc started beside the library's (phase 2) and its library
    run in phase 9.
    close() stops the compiler if it still runs and removes the build."""

    def __init__(self):
        spec = importlib.util.spec_from_file_location(
            "stream_decode_phases", ROOT / "tools" / "stream_decode_phases.py")
        self.tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(self.tool)
        _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.dir = tempfile.TemporaryDirectory(dir=_kernels.BUILD_DIR)
        variant = self.tool.strategy_variants((_kernels.CSRC / "bitstream.cu").read_text(),
                                              (_kernels.CSRC / "decode_table.cuh").read_text())
        self.procs = self.tool.start_builds(pathlib.Path(self.dir.name),
                                            {"levels": variant["levels"]})

    def library(self):
        return self.tool.finish_builds(pathlib.Path(self.dir.name), self.procs)["levels"]

    def close(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
        self.dir.cleanup()


def strategy(fn, variant: str, n_codes):
    """A stream decode (or its plain version) with the strategy bound."""
    return functools.partial(fn, variant=variant, n_codes=n_codes)


def check_strategy_case(name: str, dev: torch.device) -> None:
    """The bit-walk and fast kernels of the byte or dual stream decode on the
    card against their plain versions on one case of phase 3c (the two-
    dispatch cases in the device container's dispatches), bit-exact, and the
    output against the input (the tokens)."""
    if name in BITSTREAM_CASES:
        inp = BitstreamInputs(*bitstream_case_data(name), dev)
        if name.startswith("two_dispatch"):
            inp.words, inp.starts = inp.dispatched(inp.S, host=False)
        for v in STRATEGIES[1:]:
            out = inp.decode(strategy(bd.decode_streams, v, inp.cb.symbols.size))
            want = inp.decode(strategy(bd.decode_streams_ref, v, inp.cb.symbols.size))
            require(max_abs_err(out, want) == 0, f"{name}: decode_streams_{v}")
            require(np.array_equal(out.cpu().numpy(), inp.arr), f"{name}: {v} round trip")
        return
    inp = HuffwordBitstreamInputs(*huffword_bitstream_case(name), dev)
    n_codes = (inp.even.symbols.size, inp.odd.symbols.size)
    for v in STRATEGIES[1:]:
        ranks = inp.decode(strategy(bd.decode_streams_dual, v, n_codes))
        want = inp.decode(strategy(bd.decode_streams_dual_ref, v, n_codes))
        require(max_abs_err(ranks, want) == 0, f"{name}: decode_streams_dual_{v}")
        require(np.array_equal(inp.token_ids(ranks), inp.ids), f"{name}: {v} token round trip")


def check_corrupt_streams(dev: torch.device) -> None:
    """A stream that runs past its payload (two 1-bit codes, 90 symbols on
    64 bits): each byte strategy kernel reads what its plain version reads
    there (1 bits for the bit-walk).  A code that matches no codeword: a
    one-code codebook (the 1-bit code 0) over a payload of 1 bits.  Each
    strategy kernel, byte and dual, and its plain version raise
    ValueError."""
    two = build_codebook(np.bincount([5, 9], minlength=256), 32)
    short = torch.tensor([0x0F0F0F0F, 0x12345678], dtype=torch.int32, device=dev)
    for v in STRATEGIES[1:]:
        got, want = (fn(short, torch.zeros(1, dtype=torch.int64, device=dev), 90, 90,
                        *decode_tables(two, dev), 1, 1) for fn in
                     (strategy(bd.decode_streams, v, 2), strategy(bd.decode_streams_ref, v, 2)))
        require(max_abs_err(got, want) == 0, f"decode_streams_{v} past the payload")
    cb = build_codebook(histogram_bytes(np.array([9], np.uint8)), 32)
    words = torch.full((8,), -1, dtype=torch.int32, device=dev)
    starts = torch.zeros(1, dtype=torch.int64, device=dev)
    fc, off = hw_model._dual_tables(cb, cb, dev)
    for v in STRATEGIES[1:]:
        calls = {f"decode_streams{suffix}_{v}": functools.partial(
                     strategy(fn, v, n), words, starts, 100, 128, *tables)
                 for suffix, fn, n, tables in (
                     ("", bd.decode_streams, 1, (*decode_tables(cb, dev), 1, 1)),
                     ("", bd.decode_streams_ref, 1, (*decode_tables(cb, dev), 1, 1)),
                     ("_dual", bd.decode_streams_dual, (1, 1), (fc, off, (1, 1), (1, 1))),
                     ("_dual", bd.decode_streams_dual_ref, (1, 1), (fc, off, (1, 1), (1, 1))))}
        for name, call in calls.items():
            try:
                call()
            except ValueError as e:
                require(str(e) == bd.NO_CODEWORD, f"{name}: raised {e!r}")
                continue
            require(False, f"{name}: a code that matches no codeword did not raise")


def strategy_phase(card: str, arr: np.ndarray, bblob: bytes, text: bytes, hbblob: bytes,
                   ids: np.ndarray, levels: LevelsBuild, dev: torch.device) -> list[dict]:
    """Phase 9: the decoder strategies.  Each strategy kernel against its
    plain version on phase 3c's cases and on a code that matches nothing;
    then phase 4c's byte and phase 4d's HuffWord bitstream containers
    through decompress(variant=v) for each strategy, each output equal to
    its input, the launch counts read just after each call naming the
    routed kernel and no other stream decode; then the kernels' rows: each
    new kernel on the whole container against its plain version (and the
    input, or the tokens), timed as phase 5 times kernels, beside the table
    kernel's time in the same call, and their registers; and the counting
    build (LevelsBuild) on each whole container: the levels a lane walks a
    code and its warp a code step (in the dual form each set's apart)."""
    t_phase = time.perf_counter()
    cases = (*BITSTREAM_CASES, *HUFFWORD_BITSTREAM_CASES)
    for case in cases:
        check_strategy_case(case, dev)
    check_corrupt_streams(dev)
    torch.cuda.synchronize()
    print(f"kernels: decode_streams_bitwalk, decode_streams_fast, decode_streams_dual_bitwalk, "
          f"decode_streams_dual_fast bit-exact vs plain, round trip, on {len(cases)}/"
          f"{len(cases)} cases ({', '.join(cases)}), and past a payload's end; each raises on "
          f"a code that matches no codeword; {time.perf_counter() - t_phase:.1f} s", flush=True)

    launches = {}
    runs = (("byte bitstream", bblob, False,
             lambda out: np.array_equal(np.frombuffer(out, np.uint8), arr)),
            ("HuffWord bitstream", hbblob, True, lambda out: out == text))
    for label, blob, dual, same in runs:
        line = []
        for v in STRATEGIES:
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = gt.decompress(blob, variant=v)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = {k: c for k, c in _kernels.launch_counts().items() if c}
            require(same(out), f"{label}: decompress(variant={v!r}) != input")
            del out
            routed = STREAM_DECODES[(dual, v)]
            stray = [k for k in STREAM_DECODES.values() if k != routed and k in counts]
            require(counts.get(routed, 0) > 0 and not stray,
                    f"{label}: decompress(variant={v!r}) launched {counts}")
            launches[routed] = counts[routed]
            line.append(f"{v} {ms:.1f} ms, launches {counts}")
        print(f"strategies: {label} decompress (host clock, with checksum) on {card}: "
              + "; ".join(line), flush=True)

    f = container.read_container(bblob)
    cb = codebook_from_lengths(container.decode_byte_codebook(f.codebook_blob))
    words = i32_tensor(bitio.bytes_to_words(f.payload), dev)
    sb = f.stream_bits.astype(np.int64)
    starts = torch.from_numpy(np.cumsum(sb) - sb).to(dev)
    tables = decode_tables(cb, dev)
    n = f.n_symbols

    def decode(fn, v):
        return strategy(fn, v, cb.symbols.size)(words, starts, n, f.stream_symbols, *tables,
                                                cb.min_len, cb.max_len)

    def same_as_input(out):
        require(np.array_equal(out.cpu().numpy(), arr), "main shape: stream decode != input")

    nbytes = 4 * words.numel() + 8 * starts.numel() + n + 4 * (2 * 34 + 256)
    rows = [measure(STREAM_DECODES[(False, v)], functools.partial(decode, bd.decode_streams, v),
                    functools.partial(decode, bd.decode_streams_ref, v), nbytes,
                    DECODE_OPS_BASE * n, launches, card, check=same_as_input)
            for v in STRATEGIES[1:]]
    table_ms = spread_text(cuda_spread(functools.partial(decode, bd.decode_streams, "table")))
    lib = levels.library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for v in STRATEGIES[1:]:
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        err = torch.zeros(1, dtype=torch.int32, device=dev)
        c = levels.tool.level_counts(lib, levels.tool.strategy_runner(
            bd.STRATEGIES[v], f, cb, words, starts, tables, out, err, stream))
        require(int(err.item()) == 0, f"levels build: {v} flagged a code")
        same_as_input(out)
        past = [k for k in levels.tool.LEVEL_DEPTHS if k >= REG_LEVELS][:2]
        print(f"levels: {STREAM_DECODES[(False, v)]} at the main shape (the counting build): "
              f"{c['codes']} codes decoded (guesses, rounds, write); a lane walks "
              f"{c['lane_levels']:.2f} levels a code, its warp {c['warp_levels']:.2f} a code "
              f"step ({c['lanes_a_step']:.2f} lanes a step); codes past "
              + ", ".join(f"{k} levels {100 * c[f'codes_past_{k}']:.3f}% (warp steps "
                          f"{100 * c[f'steps_past_{k}']:.2f}%)" for k in past)
              + f"; {REG_LEVELS} levels in registers", flush=True)
        del out
    del words, starts

    hf = container.read_container(hbblob)
    word_first, cb_w, cb_n, _, _ = hw_model.huffword_state_from_blob(hf.codebook_blob)
    even, odd = (cb_w, cb_n) if word_first else (cb_n, cb_w)
    fc, off = hw_model._dual_tables(even, odd, dev)
    hwords = i32_tensor(bitio.bytes_to_words(hf.payload), dev)
    sb = hf.stream_bits.astype(np.int64)
    hstarts = torch.from_numpy(np.cumsum(sb) - sb).to(dev)
    T = hf.n_symbols
    small = max(even.symbols.size, odd.symbols.size) <= 0xFFFF

    def decode_dual(fn, v):
        return strategy(fn, v, (even.symbols.size, odd.symbols.size))(
            hwords, hstarts, T, hf.stream_symbols, fc, off, (even.min_len, odd.min_len),
            (even.max_len, odd.max_len))

    def same_as_tokens(ranks):
        require(np.array_equal(hw_model._ranks_to_ids(ranks, even, odd, small, T, dev), ids),
                "huffword main shape: dual stream decode != tokens")

    nbytes = 4 * hwords.numel() + 8 * hstarts.numel() + 4 * T + 4 * 4 * 34
    rows += [measure(STREAM_DECODES[(True, v)],
                     functools.partial(decode_dual, bd.decode_streams_dual, v),
                     functools.partial(decode_dual, bd.decode_streams_dual_ref, v), nbytes,
                     DECODE_OPS_BASE * T, launches, card, check=same_as_tokens)
             for v in STRATEGIES[1:]]
    dual_ms = spread_text(cuda_spread(functools.partial(decode_dual, bd.decode_streams_dual,
                                                        "table")))
    word, sep = (even, odd) if word_first else (odd, even)
    sets = {"word": (word.min_len, word.max_len), "separator": (sep.min_len, sep.max_len)}
    hinp = types.SimpleNamespace(words=hwords, starts=hstarts, T=T, S=hf.stream_symbols, fc=fc,
                                 off=off, even=even, odd=odd,
                                 len_range=((even.min_len, odd.min_len),
                                            (even.max_len, odd.max_len)))
    for v in STRATEGIES[1:]:
        ranks = torch.empty(T, dtype=torch.int32, device=dev)
        err = torch.zeros(1, dtype=torch.int32, device=dev)
        c = levels.tool.dual_level_counts(lib, levels.tool.dual_strategy_runner(
            bd.STRATEGIES[v], hinp, ranks, err, stream), sets)
        require(int(err.item()) == 0, f"levels build: dual {v} flagged a code")
        same_as_tokens(ranks)
        print(levels.tool.dual_levels_line(v, "at the main shape (the counting build)", c)
              + f"; {DUAL_LEVELS[0]} and {DUAL_LEVELS[1]} levels in registers (deep set, "
              "shallow set)", flush=True)
        del ranks
    print(f"time: the table kernels in the same call: decode_streams {table_ms}; "
          f"decode_streams_dual {dual_ms} on {card}", flush=True)
    regs = [line for line in ptxas_summary(_kernels.build_log())
            if line.startswith("decode_streams_sync_kernel")]
    print(f"registers (ptxas -v) of the stream decodes, each form and strategy: "
          f"{'; '.join(regs)}", flush=True)
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


# ---- phase 10: the benches ---------------------------------------------------

def run_bench(script: str, **env) -> tuple[dict, str, float]:
    """python3 <script> from the repository root on the card (GLZ_PLATFORM
    and the GLZ_BENCH_* knobs cleared, then `env` set): (its last stdout
    line as JSON, its stderr, wall seconds).  Fails unless it exits with 0
    within BENCH_TIMEOUT, its last line is one JSON object with only
    positive numbers, and its launch counts are right (check_bench_launches)."""
    base = {k: v for k, v in os.environ.items()
            if k != "GLZ_PLATFORM" and not k.startswith("GLZ_BENCH_")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, script], cwd=ROOT, env={**base, **env},
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    dt = time.perf_counter() - t0
    require(proc.returncode == 0, f"{script}: exit code {proc.returncode}\n{proc.stderr[-6000:]}")
    lines = proc.stdout.strip().splitlines()
    require(lines, f"{script}: printed nothing")
    result = json.loads(lines[-1])
    require(isinstance(result, dict), f"{script}: last line is not a JSON object")
    bad = {k: v for k, v in result.items()
           if k not in ("metric", "unit") and not (isinstance(v, (int, float)) and v > 0)}
    require(not bad, f"{script}: values not > 0: {bad}")
    check_bench_launches(script, proc.stderr)
    return result, proc.stderr, dt


def check_bench_launches(script: str, stderr: str) -> None:
    """Each part of BENCH_PARTS[script] logged its launch counts, and they
    are exactly its encodes and decodes times the kernels each launches."""
    found = {m[1]: (int(m[2]), int(m[3]), json.loads(m[4]))
             for m in _LAUNCH_LINE.finditer(stderr)}
    parts = BENCH_PARTS[script]
    require(set(found) == set(parts), f"{script}: launch lines for {sorted(found)}, "
                                      f"expected {sorted(parts)}")
    for part, per_call in parts.items():
        encodes, decodes, counts = found[part]
        want = {k: e * encodes + d * decodes for k, (e, d) in per_call.items()}
        require(encodes > 0 and decodes > 0 and counts == want,
                f"{script} {part}: launches {counts} after {encodes} encodes and "
                f"{decodes} decodes, expected {want}")


def bench_phase(card: str) -> None:
    """Phase 10: bench_torch.py at its defaults (512 MiB at S 512, rows 64, 5
    repeats; 100 MiB of HuffWord text at S 512, rows 32; the four-quarter
    batch), then GLZ_HW_PROFILE=1 bench_huffword_torch.py at its default 100
    MiB, each a subprocess on the card.  Prints each one's stderr (the card,
    the libraries, the Profiler report, the launch counts) and its JSON
    line."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    for script, env in (("bench_torch.py", {}),
                        ("bench_huffword_torch.py", {"GLZ_HW_PROFILE": "1"})):
        result, stderr, dt = run_bench(script, **env)
        if script == "bench_torch.py":
            require(sorted(result) == sorted(BENCH_KEYS), f"{script}: keys {list(result)}")
        else:
            require(result["metric"] == "huffword_device_codec_GBps_per_chip"
                    and "sub[device decode kernel]" in stderr,
                    f"{script}: metric {result['metric']} or no sub-step lines")
        for line in stderr.strip().splitlines():
            print(f"bench: {script}: {line}", flush=True)
        print(f"bench: {script} on {card} in {dt:.1f} s: {json.dumps(result)}", flush=True)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)


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
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda}; {name} x{count}; "
          f"{smi}; {nvcc}; {gxx}", flush=True)

    # ---- 2. build (the byte strategy kernels' counting build beside it)
    t0 = time.perf_counter()
    levels = LevelsBuild()
    atexit.register(levels.close)
    _kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s; "
          + "; ".join(ptxas_summary(_kernels.build_log())), flush=True)
    t0 = time.perf_counter()
    native.library()
    print(f"build: host library {native.library_path().name} (g++ {' '.join(native.CXX_FLAGS)}) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

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
    for case in K4_CASES:
        check_k4_case(case, dev)
    for case in K1_CASES:
        check_k1_case(case, dev)
    for case in HIST_CASES:
        check_histogram_case(case, dev)
    torch.cuda.synchronize()
    print(f"kernels: lut_gather (gather_entries, map_ranks), lane_totals_entries, "
          f"encode_entries, decode_dual bit-exact vs plain, "
          f"tokens round-trip, on {len(HUFFWORD_CASES)}/{len(HUFFWORD_CASES)} cases "
          f"({', '.join(HUFFWORD_CASES)}); decode_dual on random words at "
          f"{', '.join(K5_RANDOM_CASES)}; encode_entries alone on {', '.join(K4_CASES)}; "
          f"lane_totals alone on {', '.join(K1_CASES)}; histogram (against its plain "
          f"version, torch.bincount and np.bincount) on {', '.join(HIST_CASES)}; "
          f"{time.perf_counter() - t0:.1f} s",
          flush=True)

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
    digests = {"byte_lockstep": sha(blob)}  # phase 8's traced calls must write these
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
    digests["huffword_lockstep"] = sha(hblob)
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
    digests["byte_bitstream"] = sha(bblob)
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
    digests["huffword_bitstream"] = sha(hbblob)
    hbf = container.read_container(hbblob)
    print(f"main: HuffWord bitstream {hn >> 20} MiB DEFAULT+checksum on {card}: "
          f"{hbf.n_symbols} tokens in {hbf.n_streams} streams of {hbf.stream_symbols}; "
          f"compress {t_c * 1e3:.1f} ms ({hn / t_c / 1e9:.3f} GB/s), decompress "
          f"{t_d * 1e3:.1f} ms ({hn / t_d / 1e9:.3f} GB/s), ratio {len(hbblob) / hn:.4f}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, "
          f"launches {hblaunches}", flush=True)

    # ---- 4e. the batch path: twelve Silesia-sized members
    t0 = time.perf_counter()
    members = silesia_members()
    print(f"batch: {len(members)} members ({', '.join(f'{k} {len(v)}' for k, v in members.items())}"
          f"; {sum(map(len, members.values()))} B) made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    batch_phase(card, members)

    # ---- 4f. the command line on every path
    cli_phase(card, arr, text, members)
    del members

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
        times = cuda_spread(kernel)
        b_ms, b_by = bound(traffic[k], ops[k])
        rows.append({"name": k, "route": "cuda", "source": "glz_tpu_torch/csrc/lockstep.cu",
                     "replaces": REPLACES[k], "launches": launches[k], "max_abs_err": err,
                     **times, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        print(f"time: {k} {spread_text(times)} (plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms by "
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
    hist_row = histogram_kernel_time(arr, dev, card)
    rows.append(hist_row)
    regs = [line for line in ptxas_summary(_kernels.build_log())
            if line.startswith(("lane_totals_kernel", "encode_entries_kernel", "encode_kernel",
                                "decode_dual_kernel", "histogram_kernel"))]
    print(f"registers (ptxas -v) of K1, K4 (each geometry launched), K2, K5 and the "
          f"histogram: {'; '.join(regs)}", flush=True)
    hw_text = text

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
    for key, (pmode, pconf) in archive_pinned_configs().items():
        if pmode == cfg.MODE_NORMAL_TREE:
            blob = gt.compress(text, mode=pmode, conf=pconf)
            require(gt.decompress(blob) == text, f"pinned digest {key}: round trip")
        else:
            blob = gt.compress_archive(quarters(text), mode=pmode, conf=pconf)
            require(gt.decompress_archive(blob) == quarters(text),
                    f"pinned digest {key}: round trip")
        digest = hashlib.sha256(blob).hexdigest()
        require(digest == ARCHIVE_PINNED[key], f"pinned digest {key}: {digest}")
    print(f"digests: {', '.join([*PINNED, *HUFFWORD_PINNED, *BITSTREAM_PINNED, *ARCHIVE_PINNED])} "
          f"match the reference", flush=True)

    # ---- 7. the device mesh (world size 1) and two processes sharing the card
    t0 = time.perf_counter()
    hist_row["launches"] = mesh_phase(card, arr, dev)["histogram"]
    multihost_phase(card, arr, hw_text)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 8. device traces of the four main paths, each direction apart
    trace_phase(card, arr, hw_text, digests)

    # ---- 9. the decoder strategies on the bitstream paths
    rows += strategy_phase(card, arr, bblob, hw_text, hbblob, vocabs[5], levels, dev)

    # ---- 10. the benches, each in its own process
    bench_phase(card)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
