"""Headline benchmark on one CUDA card: canonical-byte encode+decode GB/s,
the port's counterpart of bench.py, with the same knobs, corpus, timed
regions and JSON line.

    python3 bench_torch.py          # one CUDA card; GLZ_PLATFORM=cpu for the CPU

Prints ONE JSON line on stdout, bench.py's keys:
  {"metric": "enwik8_byte_codec_GBps_per_chip", "value": N, "unit": "GB/s",
   "vs_baseline": N / 1.0, "huffword_*": ..., "batch4_*": ...}

BASELINE.md's committed target is >= 1 GB/s combined encode+decode (a
target, not a measurement), so vs_baseline is the ratio to 1 GB/s.
value = 2*bytes / (t_codebook + t_encode + t_decode) on glz_tpu_torch's
lockstep pipeline:

  codebook = sampled host histogram (host library) + host codebook build
  encode   = lane totals (K1), one small D2H of the group word counts,
             reverse-sweep encode (K2), on symbols already on the card
  decode   = lockstep decode (K3), output in file order

Every timed call is warmed once first, and the host and kernel libraries
are built or loaded before that, their times logged; each timed value is the min over the repeats of the host clock
around a call ending in torch.cuda.synchronize().  The corpus is bench.py's
(the AND of three uniform byte draws, ~4.4 bits/byte, the same bytes).

Then, as in bench.py: two edge round trips ("ragged": n - 123,457 valid
symbols; "deepcode": geometric symbols whose codebook caps at 26 bits),
the HuffWord device pass (BASELINE config 3: S 512, rows 32; end to end
and device-resident kernels only) and the four-file batch (serial and
pipelined, encode and decode).  Per-phase times, launch counts per part,
the card's name and power limit, torch's version and the libraries' build
times go to stderr.

Environment knobs: GLZ_BENCH_MB (default 512), GLZ_BENCH_STREAM (512
symbols a stream), GLZ_BENCH_ROWS (group rows, 64), GLZ_BENCH_REPEATS (5),
GLZ_BENCH_TIMEOUT (3000 s watchdog), GLZ_BENCH_EXACT_HIST (scan everything),
GLZ_BENCH_EDGES (0 skips the edges), GLZ_BENCH_HW (0 skips HuffWord),
GLZ_BENCH_HW_MB (min(MB, 100)), GLZ_BENCH_BATCH (0 skips the batch),
GLZ_BENCH_TRACE (a directory: a device trace of one encode + decode).
bench.py's GLZ_JAX_CACHE has no counterpart: nothing here compiles
through JAX, and the kernel library is built once into build/.

Unlike bench.py, a failed part does not leave the exit code 0: a round-trip
or edge mismatch prints the zero-valued line, and an exception in the
HuffWord or batch part sets its zero-valued key; either way the line is
printed and the script exits non-zero.  Without a card and without
GLZ_PLATFORM=cpu it exits non-zero at once and prints no line.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from bench_huffword_torch import (Launches, Mismatch, bench_device, host_peak_mib, huffword_conf,
                                  log, mib, prepare, sync, timeit, watchdog, zero_line)
from bench_huffword_torch import make_corpus as hw_corpus
from glz_tpu_torch import config as cfg
from glz_tpu_torch import decompress
from glz_tpu_torch.core import container, lockstep
from glz_tpu_torch.core.api import compress_archive, compress_batch, decompress_batch
from glz_tpu_torch.core.codebook import build_codebook, sampled_histogram
from glz_tpu_torch.models import huffword as hwm
from glz_tpu_torch.models.canonical_byte import decode_tables, entry_table, group_tables
from glz_tpu_torch.models.transfer import i32_tensor, round_up
from glz_tpu_torch.ops.lockstep_decode import decode_groups, decode_groups_dual
from glz_tpu_torch.ops.lockstep_encode import (MAX_FUSED_LEN, encode_payload_from_entries,
                                               encode_payload_from_symbols)
from glz_tpu_torch.ops.lut import gather_entries, map_ranks
from glz_tpu_torch.utils import tokenizer as tok
from glz_tpu_torch.utils.timer import Phase, Profiler, device_trace

METRIC = "enwik8_byte_codec_GBps_per_chip"


def make_corpus(n_bytes: int) -> np.ndarray:
    """bench.make_corpus: non-repeating bytes at ~4.4 bits/byte order-0
    entropy, the AND of three uniform byte draws (seed 0xE58)."""
    rng = np.random.default_rng(0xE58)
    out = rng.integers(0, 256, size=n_bytes, dtype=np.uint8)
    out &= rng.integers(0, 256, size=n_bytes, dtype=np.uint8)
    out &= rng.integers(0, 256, size=n_bytes, dtype=np.uint8)
    return out


def deep_corpus(n_bytes: int) -> np.ndarray:
    """bench.py's deep-codebook edge input: geometric symbols (seed 0xDEEB)
    whose natural tree is deeper than 26 bits at full size."""
    rng = np.random.default_rng(0xDEEB)
    return (np.minimum(rng.geometric(0.5, size=n_bytes), 64) - 1).astype(np.uint8)


def _byte_codec(sym: torch.Tensor, n: int, cb, S: int, rows: int, dev: torch.device,
                calls: Launches):
    """(enc, dec) closures of the lockstep codec on `sym` (group-padded u8 on
    the card): enc() -> (payload, padded group word counts); dec(payload,
    group word counts) -> u8 output in file order.  Tables go to the card
    here, outside both."""
    tbl = entry_table(cb, dev)
    dtables = decode_tables(cb, dev)

    def enc():
        calls.encodes += 1
        return encode_payload_from_symbols(sym, n, tbl, S, rows)

    def dec(payload, group_words):
        calls.decodes += 1
        return decode_groups(payload, *group_words, *dtables, S, cb.min_len, cb.max_len, rows)

    return enc, dec


def _bench_bytes(n: int, S: int, rows: int, repeats: int, dev: torch.device
                 ) -> tuple[float, np.ndarray]:
    """The headline: returns (GB/s, the corpus).  Raises Mismatch when the
    round trip or an edge is not exact."""
    t0 = time.perf_counter()
    arr = make_corpus(n)
    log(f"corpus gen: {time.perf_counter() - t0:.1f} s ({n >> 20} MiB)")
    G = rows * 128
    group_syms = G * S
    padded_n = -(-n // group_syms) * group_syms
    t0 = time.perf_counter()
    host = np.zeros(padded_n, np.uint8)
    host[:n] = arr
    data = torch.from_numpy(host).to(dev)
    sync(dev)
    log(f"H2D: {time.perf_counter() - t0:.1f} s; "
        f"{padded_n // group_syms} groups x {G} streams x {S} symbols")

    prof = Profiler()
    calls = Launches("byte")

    # ---- histogram (host library, threaded) + codebook (host): the
    # THROUGHPUT preset's evenly-spaced-block sampled histogram with +1
    # smoothing; GLZ_BENCH_EXACT_HIST=1 scans everything.  MAX_FUSED_LEN:
    # the encode's fused lj|len entry word needs max_len <= 26.
    budget = None if os.environ.get("GLZ_BENCH_EXACT_HIST") else (8 << 20)

    def hist_codebook():
        return build_codebook(sampled_histogram(arr, budget), MAX_FUSED_LEN)

    cb = hist_codebook()  # warm (thread pool, allocator)
    t_cb = timeit(hist_codebook, repeats, dev)
    prof.phases.append(Phase(f"histogram+codebook (C++{', sampled' if budget else ''})",
                             t_cb, n))
    log(f"histogram+codebook: {t_cb * 1e3:.1f} ms, len range [{cb.min_len},{cb.max_len}]")

    # ---- encode: K1, the exact group geometry on the host, K2.  (bench.py's
    # speculative geometry, spec_rows, is not ported: it overlaps the
    # geometry's D2H with the TPU kernel and does not change the payload.)
    enc, dec = _byte_codec(data, n, cb, S, rows, dev, calls)
    t0 = time.perf_counter()
    payload, group_words = enc()
    sync(dev)
    log(f"encode first call: {time.perf_counter() - t0:.2f} s")
    t_enc_dev = timeit(enc, repeats, dev)
    prof.phases.append(Phase("device encode (K1 + K2)", t_enc_dev, n))
    ratio = group_words.sum() * 4 / n
    t_enc = t_cb + t_enc_dev
    log(f"encode: {n / t_enc / 1e9:.3f} GB/s (device {n / t_enc_dev / 1e9:.3f})  "
        f"ratio={ratio:.4f}")

    # ---- decode: K3.  The group tables go to the card here, outside the
    # timed call, as bench.py's dargs do.  (bench.py's mgw, the TPU
    # kernel's payload window, has no counterpart: K3 reads the payload
    # where it lies.)
    groups = group_tables(group_words, n, G, S, dev)
    t0 = time.perf_counter()
    out = dec(payload, groups)
    sync(dev)
    log(f"decode first call: {time.perf_counter() - t0:.2f} s")
    t_dec = timeit(lambda: dec(payload, groups), repeats, dev)
    prof.phases.append(Phase("device decode (K3)", t_dec, n))
    log(f"decode: {n / t_dec / 1e9:.3f} GB/s")
    log(prof.report())

    trace_dir = os.environ.get("GLZ_BENCH_TRACE")
    if trace_dir:
        with device_trace(trace_dir, device=None if dev.type == "cuda" else "cpu") as t:
            dec(enc()[0], groups)
            sync(dev)
        log(f"profiler trace written to {t.file}")

    # K3 writes file order, so no unpack step (bench.py's unpack_symbols)
    if not np.array_equal(out[:n].cpu().numpy(), arr):
        raise Mismatch("ROUND TRIP MISMATCH")
    del out, payload

    # ---- edge cases: a ragged tail and a 26-bit codebook through the same
    # two calls.  (bench.py's min_mgw_rows / min_p_rows floors, which let
    # these reuse the headline's TPU compiles, have no counterpart.)
    if os.environ.get("GLZ_BENCH_EDGES", "1") != "0":
        def edge_roundtrip(tag, arr_e, n_valid):
            t0 = time.perf_counter()
            cb_e = build_codebook(sampled_histogram(arr_e[:n_valid], budget), MAX_FUSED_LEN)
            enc_e, dec_e = _byte_codec(torch.from_numpy(arr_e).to(dev), n_valid, cb_e, S,
                                       rows, dev, calls)
            pay_e, gw_e = enc_e()
            got = dec_e(pay_e, group_tables(gw_e, n_valid, G, S, dev))[:n_valid]
            ok = np.array_equal(got.cpu().numpy(), arr_e[:n_valid])
            log(f"edge[{tag}]: len range [{cb_e.min_len},{cb_e.max_len}], "
                f"{time.perf_counter() - t0:.1f} s — {'OK' if ok else 'MISMATCH'}")
            return ok

        # (a) ragged tail: same padded geometry, short final group/stream
        edges_ok = edge_roundtrip("ragged", host, n - 123457)
        del host
        # (b) deep codebook: geometric frequencies push the natural tree
        # past 26 bits; package-merge caps at MAX_FUSED_LEN exactly
        edges_ok &= edge_roundtrip("deepcode", deep_corpus(padded_n), n)
        log(f"host peak after the edges: {host_peak_mib():.0f} MiB")
        if not edges_ok:
            raise Mismatch("EDGE CASE MISMATCH")
    calls.report()

    value = 2 * n / (t_enc + t_dec) / 1e9
    log(f"combined: {value:.3f} GB/s (enc {n / t_enc / 1e9:.2f} dec {n / t_dec / 1e9:.2f})")
    return value, arr


def _bench_batch(arr: np.ndarray, S: int, rows: int, repeats: int, dev: torch.device
                 ) -> dict:
    """BASELINE config 4 shape: a 4-file batch through compress_batch and
    decompress_batch, the serial loop against the 2-deep pipeline (file
    i+1's host phases overlap file i's kernels).  Also logs the
    shared-codebook batch's and the archive's sizes."""
    n4 = arr.size // 4
    files = [arr[i * n4 : (i + 1) * n4].tobytes() for i in range(4)]
    total = 4 * n4
    conf = cfg.GlzConfig(stream_symbols=S, layout=cfg.LAYOUT_LOCKSTEP,
                         histogram_budget=8 << 20, group_rows=rows)
    calls = Launches("batch")

    def comp(**kw):
        calls.encodes += len(files)
        return compress_batch(files, conf=conf, device=dev, **kw)

    def decomp(**kw):
        calls.decodes += len(blobs)
        return decompress_batch(blobs, device=dev, **kw)

    blobs = comp()  # warm
    t_ser = timeit(lambda: comp(pipeline=False), repeats, dev)
    t_pipe = timeit(comp, repeats, dev)
    log(f"batch4 encode: serial {total / t_ser / 1e9:.3f} GB/s, "
        f"pipelined {total / t_pipe / 1e9:.3f} GB/s ({t_ser / t_pipe:.2f}x)")
    if decomp() != files:  # warm + verify
        raise Mismatch("BATCH DECODE MISMATCH")
    t_dser = timeit(lambda: decomp(pipeline=False), repeats, dev)
    t_dpipe = timeit(decomp, repeats, dev)
    log(f"batch4 decode: serial {total / t_dser / 1e9:.3f} GB/s, "
        f"pipelined {total / t_dpipe / 1e9:.3f} GB/s ({t_dser / t_dpipe:.2f}x)")
    # the archive against per-file containers with the SAME shared codebook
    shared = comp(shared_codebook=True)
    calls.encodes += len(files)
    arc = compress_archive(files, conf=conf, device=dev)
    per_total = sum(len(b) for b in shared)
    log(f"batch4 shared-codebook archive: {len(arc)} B vs per-file "
        f"{per_total} B ({per_total - len(arc)} B saved)")
    calls.report()
    return {"batch4_serial_GBps": round(total / t_ser / 1e9, 4),
            "batch4_pipelined_GBps": round(total / t_pipe / 1e9, 4),
            "batch4_dec_serial_GBps": round(total / t_dser / 1e9, 4),
            "batch4_dec_pipelined_GBps": round(total / t_dpipe / 1e9, 4)}


def _bench_huffword(n: int, repeats: int, dev: torch.device) -> tuple[dict, tuple]:
    """HuffWord device codec GB/s (BASELINE config 3): bench_huffword_torch's
    corpus; encode = entry gather + reverse-sweep encode, decode = dual
    lockstep decode + rank map + detokenize.  The tokenize/vocab phase is
    timed apart, as bench_huffword.py does.  Returns (keys, the arguments
    of _bench_huffword_kernels after n)."""
    t0 = time.perf_counter()
    data = hw_corpus(n)
    log(f"huffword corpus gen: {time.perf_counter() - t0:.1f} s ({n >> 20} MiB)")
    conf = huffword_conf()

    t0 = time.perf_counter()
    _, _, word_first, wv, nv, ids = tok.build_vocabs(data)
    t_tok = time.perf_counter() - t0
    log(f"huffword tokenize+vocab: {t_tok:.2f} s "
        f"({ids.size} tokens, vocab {wv.n}+{nv.n})")
    calls = Launches("huffword")

    def enc():
        calls.encodes += 1
        return hwm._compress_huffword_device(data, conf, word_first, wv, nv, ids, device=dev)

    def dec():
        calls.decodes += 1
        return decompress(blob, device=dev)

    blob = enc()  # warm
    t_enc = timeit(enc, repeats, dev)
    if dec() != data:
        raise Mismatch("HUFFWORD ROUND TRIP MISMATCH")
    t_dec = timeit(dec, repeats, dev)
    calls.report()
    value = 2 * n / (t_enc + t_dec) / 1e9
    log(f"huffword: ratio {len(blob) / n:.4f}; enc {n / t_enc / 1e9:.3f} GB/s, "
        f"dec(+detok) {n / t_dec / 1e9:.3f} GB/s, combined {value:.3f} GB/s; "
        f"end-to-end incl. tokenize {2 * n / (t_tok + t_enc + t_dec) / 1e9:.3f} GB/s")
    return ({"huffword_GBps": round(value, 4),
             "huffword_tokenize_s": round(t_tok, 3),
             "huffword_e2e_GBps": round(2 * n / (t_tok + t_enc + t_dec) / 1e9, 4)},
            (blob, word_first, wv, nv, ids, conf))


def _bench_huffword_kernels(n, blob, word_first, wv, nv, ids, conf, repeats,
                            dev: torch.device) -> dict:
    """Device-resident HuffWord codec timing: the ids and the container's
    payload staged on the card once, the kernels timed alone (no payload or
    id transfers in the timed region but the encode's small D2H of the
    group word counts).  models/huffword's device paths minus transfers.
    Raises Mismatch unless the decode reproduces the ids."""
    T = ids.size
    S = lockstep.huffword_stream_tokens(conf)
    small = max(wv.n, nv.n) <= 0xFFFF
    rows = min(conf.group_rows, lockstep.huffword_rows_cap(S, small))
    G = rows * 128
    limit = lockstep.fused_length_limit(conf)
    cbs = [build_codebook(wv.counts, limit), build_codebook(nv.counts, limit)]
    calls = Launches("huffword_kernels")

    # ---- stage the encode's inputs on the card once
    padded_T = round_up(max(T, 1), G * S)
    ids_pad = np.zeros(padded_T, np.uint16 if small else np.uint32)
    ids_pad[:T] = ids.astype(ids_pad.dtype)
    ids_d = torch.from_numpy(ids_pad.view(np.int16 if small else np.int32)).to(dev)
    tbl_d = i32_tensor(np.concatenate(
        [cb.left_justified_codes() | cb.lengths.astype(np.uint32) for cb in cbs]), dev)
    n0 = max(wv.n, 1)

    def enc_kernel():
        calls.encodes += 1
        chunk = gather_entries(ids_d, tbl_d, 0, n0, T, bool(word_first))
        return encode_payload_from_entries(chunk, S, rows)

    enc_kernel()  # warm
    t_enc_k = timeit(enc_kernel, repeats, dev)

    # ---- stage the decode's inputs on the card once (from the container)
    f = container.read_container(blob)
    cb_even, cb_odd = (cbs[0], cbs[1]) if word_first else (cbs[1], cbs[0])
    starts, counts = group_tables(f.stream_bits, T, G, S, dev)
    payload_d = i32_tensor(np.frombuffer(f.payload, dtype="<u4"), dev)
    fc, offsets = hwm._dual_tables(cb_even, cb_odd, dev)
    n_even = max(cb_even.symbols.size, 1)
    sym_cat = i32_tensor(np.concatenate(
        [cb_even.symbols if cb_even.symbols.size else np.zeros(1, np.uint32),
         cb_odd.symbols if cb_odd.symbols.size else np.zeros(1, np.uint32)]), dev)

    def dec_kernel():  # K5 writes int32 ranks in file order: no pack2, no unpack
        calls.decodes += 1
        ranks = decode_groups_dual(payload_d, starts, counts, fc, offsets, S,
                                   (cb_even.min_len, cb_odd.min_len),
                                   (cb_even.max_len, cb_odd.max_len), rows)
        return map_ranks(ranks, sym_cat, n_even, small)

    ids2 = dec_kernel()  # warm + oracle: the kernel path must reproduce the ids
    got = ids2[:T].cpu().numpy().view(np.uint16 if small else np.uint32)
    if not np.array_equal(got.astype(np.int64), ids.astype(np.int64)):
        raise Mismatch("HUFFWORD KERNEL ROUND TRIP MISMATCH")
    t_dec_k = timeit(dec_kernel, repeats, dev)
    calls.report()
    kernel_v = 2 * n / (t_enc_k + t_dec_k) / 1e9
    log(f"huffword kernel-only (device-resident): enc {n / t_enc_k / 1e9:.3f} "
        f"GB/s, dec {n / t_dec_k / 1e9:.3f} GB/s, combined {kernel_v:.3f} GB/s")
    return {"huffword_kernel_GBps": round(kernel_v, 4),
            "huffword_kernel_enc_GBps": round(n / t_enc_k / 1e9, 4),
            "huffword_kernel_dec_GBps": round(n / t_dec_k / 1e9, 4)}


def main() -> int:
    mb_bytes = mib("GLZ_BENCH_MB", "512")
    S = int(os.environ.get("GLZ_BENCH_STREAM", "512"))
    rows = int(os.environ.get("GLZ_BENCH_ROWS", "64"))
    repeats = int(os.environ.get("GLZ_BENCH_REPEATS", "5"))
    try:
        dev = bench_device()
    except RuntimeError as e:
        log(f"bench_torch: {e}")
        return 2
    dog = watchdog(int(os.environ.get("GLZ_BENCH_TIMEOUT", "3000")), METRIC)
    try:
        return _run(mb_bytes, S, rows, repeats, dev)
    finally:
        dog.cancel()


def _run(n: int, S: int, rows: int, repeats: int, dev: torch.device) -> int:
    try:
        prepare(dev)
        value, arr = _bench_bytes(n, S, rows, repeats, dev)
    except Exception:
        log(f"byte bench FAILED — benchmark invalid:\n{traceback.format_exc()}")
        print(zero_line(METRIC), flush=True)
        return 1

    result = {"metric": METRIC, "value": round(value, 4), "unit": "GB/s",
              "vs_baseline": round(value / 1.0, 4)}
    failed = []

    def part(zero_key, fn, *args):
        """fn(*args), its keys merged into the line; on any exception, the
        traceback on stderr and bench.py's zero-valued key instead."""
        try:
            return fn(*args)
        except Exception:
            log(f"{fn.__name__} FAILED:\n{traceback.format_exc()}")
            failed.append(zero_key)
            result[zero_key] = 0.0
            return None

    if os.environ.get("GLZ_BENCH_HW", "1") != "0":
        hw_n = mib("GLZ_BENCH_HW_MB", str(min(n / (1 << 20), 100)))
        hw_repeats = min(repeats, 3)
        got = part("huffword_GBps", _bench_huffword, hw_n, hw_repeats, dev)
        if got is not None:
            result.update(got[0])
            keys = part("huffword_kernel_GBps", _bench_huffword_kernels, hw_n, *got[1],
                        hw_repeats, dev)
            result.update(keys or {})
    if os.environ.get("GLZ_BENCH_BATCH", "1") != "0":
        result.update(part("batch4_serial_GBps", _bench_batch, arr, S, rows,
                           min(repeats, 2), dev) or {})
    log(f"host peak: {host_peak_mib():.0f} MiB")
    print(json.dumps(result), flush=True)
    if failed:
        log(f"FAILED parts: {', '.join(failed)} — exit 1")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
