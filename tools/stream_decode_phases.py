#!/usr/bin/env python3
"""Time the phases of the stream decodes (byte and dual) apart on one CUDA
card.

    python3 tools/stream_decode_phases.py      # from the repository root

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
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import glz_tpu_torch as gt  # noqa: E402
from glz_tpu_torch import config as cfg  # noqa: E402
from glz_tpu_torch.core import bitio, container  # noqa: E402
from glz_tpu_torch.core.codebook import codebook_from_lengths  # noqa: E402
from glz_tpu_torch.models.canonical_byte import _i32_tensor, decode_tables  # noqa: E402
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


def build(tmp: pathlib.Path) -> dict[str, ctypes.CDLL]:
    src = (_kernels.CSRC / "bitstream.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        path = tmp / f"{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC), "-shared",
             "-o", str(tmp / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        for entry in ("glz_decode_streams", "glz_decode_streams_dual"):
            fn = getattr(lib, entry)
            fn.argtypes = _kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    for name, lib in libs.items():
        if name.endswith("counted"):
            lib.probe_take.restype = ctypes.c_ulonglong
    return libs


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
    _, _, wf, wv, nv, ids = tok.build_vocabs(chip_smoke.make_word_corpus(chip_smoke.HUFFWORD_BYTES))
    cbs = [build_codebook(v.counts, cfg.DEFAULT.length_limit) for v in (wv, nv)]
    inp = chip_smoke.HuffwordBitstreamInputs(ids, bool(wf), cbs, wv.n, nv.n,
                                             min(cfg.DEFAULT.stream_symbols, 1 << 14), dev)
    want = inp.decode(bd.decode_streams_dual_ref)
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
    print(f"dual decode phases at the HuffWord bitstream shape ({inp.starts.numel()} streams "
          f"of {inp.S} tokens, {inp.T} tokens; word codes {cbs[0].min_len}-{cbs[0].max_len} "
          f"bits, separators {cbs[1].min_len}-{cbs[1].max_len})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_decode_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    arr = chip_smoke.make_corpus(chip_smoke.MAIN_BYTES)
    f = container.read_container(gt.compress(arr, conf=cfg.DEFAULT))
    cb = codebook_from_lengths(container.decode_byte_codebook(f.codebook_blob))
    words = _i32_tensor(bitio.bytes_to_words(f.payload), dev)
    sb = f.stream_bits.astype(np.int64)
    starts = torch.from_numpy(np.cumsum(sb) - sb).to(dev)
    fc, offs, symtab = decode_tables(cb, dev)
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
