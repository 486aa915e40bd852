"""HuffWord device-path benchmark on one CUDA card (BASELINE config 3), the
port's counterpart of bench_huffword.py.

    python3 bench_huffword_torch.py     # GLZ_BENCH_MB (default 100)

Generates bench_huffword.py's English-like corpus (Zipf word draws +
punctuation, the same bytes), then times the HuffWord lockstep path of
glz_tpu_torch (S 512 tokens, group rows 32) in phases:
  tokenize+vocab (host library) | encode: entry gather (K6), lane totals
  and reverse-sweep encode (K4) | decode: dual-codebook lockstep decode
  (K5), rank map (K6) and detokenize (host library)
and prints one JSON line with the device codec GB/s (encode+decode over
original bytes); the phases go to stderr.  GLZ_HW_PROFILE=1 also breaks
encode and decode into their sub-steps.

Runs on the card; GLZ_PLATFORM=cpu runs the kernels' plain PyTorch
versions on the CPU instead.  Without a card and without that setting it
exits non-zero at once.  A round-trip mismatch or any exception prints the
zero-valued line and exits non-zero.

The helpers below (device choice, timing, watchdog, launch counts) are
shared with bench_torch.py, which imports them, as it imports the corpus.
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

from glz_tpu_torch import config as cfg
from glz_tpu_torch import decompress
from glz_tpu_torch.core import container
from glz_tpu_torch.core.codebook import build_codebook
from glz_tpu_torch.core import lockstep
from glz_tpu_torch.core.lockstep import LANES
from glz_tpu_torch.models import huffword as hw
from glz_tpu_torch.models.canonical_byte import group_tables
from glz_tpu_torch.models.transfer import i32_tensor, round_up
from glz_tpu_torch.ops import _kernels
from glz_tpu_torch.ops.lockstep_decode import decode_groups_dual
from glz_tpu_torch.ops.lockstep_encode import encode_payload_from_entries
from glz_tpu_torch.ops.lut import gather_entries, map_ranks
from glz_tpu_torch.utils import native
from glz_tpu_torch.utils import tokenizer as tok
from glz_tpu_torch.utils.timer import Phase, Profiler

METRIC = "huffword_device_codec_GBps_per_chip"


class Mismatch(RuntimeError):
    """A decoded output differs from the input: the benchmark is invalid."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def mib(name: str, default: str) -> int:
    """Bytes from the environment knob `name`, in MiB (fractions allowed)."""
    return int(float(os.environ.get(name, default)) * (1 << 20))


def zero_line(metric: str) -> str:
    return json.dumps({"metric": metric, "value": 0.0, "unit": "GB/s", "vs_baseline": 0.0})


def watchdog(seconds: int, metric: str) -> threading.Timer:
    """Print the zero-valued line and exit 3 if no result came within
    `seconds` (a hung launch or device init).  Cancel it when done."""
    def fire():
        log(f"WATCHDOG: no result within {seconds}s")
        print(zero_line(metric), flush=True)
        os._exit(3)
    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t


def bench_device() -> torch.device:
    """The card, or the CPU under GLZ_PLATFORM=cpu (the command line's switch,
    which runs the plain versions).  Raises RuntimeError when neither."""
    if os.environ.get("GLZ_PLATFORM") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; GLZ_PLATFORM=cpu runs the "
                           "kernels' plain PyTorch versions on the CPU")
    return torch.device("cuda")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timeit(fn, repeats: int, dev: torch.device) -> float:
    """Min over `repeats` of the host clock around fn() and a synchronize."""
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def host_peak_mib() -> float:
    """This process's peak resident host memory (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def prepare(dev: torch.device) -> None:
    """Log the device's context on stderr (torch, the card's name and power
    limit) and build or load the host library and, on the card, the kernel
    library, so that no build lands in a timed call; log their times."""
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
            f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    else:
        log(f"device: cpu (GLZ_PLATFORM=cpu: the kernels' plain PyTorch versions); "
            f"torch {torch.__version__}")
    libs = [("host library", native.library_path, native.library)]
    if dev.type == "cuda":
        libs.append(("kernel library", _kernels.library_path, _kernels.library))
    for what, path, load in libs:
        built = not path().exists()
        t0 = time.perf_counter()
        load()
        log(f"{what}: {path().name} {'built' if built else 'loaded'} in "
            f"{time.perf_counter() - t0:.1f} s")


class Launches:
    """The kernel launch counts of one part of a bench: reset when the part
    starts, logged with the encodes and decodes it ran when it ends
    (`launches[<part>] after E encodes and D decodes: {...}`; the counts stay
    0 on the CPU, where no kernel launches)."""

    def __init__(self, part: str):
        self.part = part
        self.encodes = 0
        self.decodes = 0
        _kernels.reset_launch_counts()

    def report(self) -> None:
        counts = {k: v for k, v in _kernels.launch_counts().items() if v}
        log(f"launches[{self.part}] after {self.encodes} encodes and {self.decodes} "
            f"decodes: {json.dumps(counts)}")


def make_corpus(n_bytes: int) -> bytes:
    """bench_huffword.make_corpus: English-like text, Zipf(1.1) draws from
    20,000 words, each followed by one of six separators (seed 0x3AD)."""
    rng = np.random.default_rng(0x3AD)
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


def huffword_conf():
    """BASELINE config 3's geometry: 512 tokens a stream, 32 group rows,
    the lockstep layout."""
    return cfg.GlzConfig(stream_symbols=512, layout=cfg.LAYOUT_LOCKSTEP, group_rows=32)


def _subphase_profile(data, conf, word_first, wv, nv, ids, blob, dev):
    """GLZ_HW_PROFILE=1: break the device path into sub-steps (codebooks,
    id packing, H2D, entry gather, encode kernel, D2H, and the decode side)
    to locate host and transfer bottlenecks.  Each sub-step ends in a
    synchronize."""
    def tick(tag, t0):
        sync(dev)
        t1 = time.perf_counter()
        log(f"    sub[{tag}]: {(t1 - t0) * 1e3:.0f} ms")
        return t1

    calls = Launches("huffword_subphases")
    T = ids.size
    S = lockstep.huffword_stream_tokens(conf)
    f = container.read_container(blob)
    rows = f.group_rows
    group_syms = rows * LANES * S
    t0 = time.perf_counter()
    limit = lockstep.fused_length_limit(conf)
    cbs = [build_codebook(wv.counts, limit), build_codebook(nv.counts, limit)]
    t0 = tick("codebooks", t0)
    ent_tbls = [cb.left_justified_codes() | cb.lengths.astype(np.uint32) for cb in cbs]
    padded_T = round_up(max(T, 1), group_syms)
    n0 = max(wv.n, 1)
    combined = i32_tensor(np.concatenate(ent_tbls), dev)
    small = max(wv.n, nv.n) <= 0xFFFF
    ids_pad = np.zeros(padded_T, np.uint16 if small else np.uint32)
    ids_pad[:T] = ids.astype(ids_pad.dtype)
    t0 = tick("pack ids (host)", t0)
    ids_d = torch.from_numpy(ids_pad.view(np.int16 if small else np.int32)).to(dev)
    t0 = tick(f"H2D ids ({ids_pad.nbytes >> 20} MiB)", t0)
    calls.encodes += 1
    chunk = gather_entries(ids_d, combined, 0, n0, T, bool(word_first))
    t0 = tick("device entry gather", t0)
    payload, _ = encode_payload_from_entries(chunk, S, rows)
    t0 = tick("device encode kernel", t0)
    payload.cpu()
    t0 = tick(f"D2H payload ({payload.numel() * 4 >> 20} MiB)", t0)

    word_first, cb_w, cb_n, wv2, nv2 = hw.huffword_state_from_blob(f.codebook_blob)
    cb_even, cb_odd = (cb_w, cb_n) if word_first else (cb_n, cb_w)
    t0 = time.perf_counter()
    dpay = i32_tensor(np.frombuffer(f.payload, dtype="<u4"), dev)
    t0 = tick("H2D payload", t0)
    calls.decodes += 1
    starts, counts = group_tables(f.stream_bits, T, rows * LANES, S, dev)
    fc, offsets = hw._dual_tables(cb_even, cb_odd, dev)
    ranks = decode_groups_dual(dpay, starts, counts, fc, offsets, S,
                               (cb_even.min_len, cb_odd.min_len),
                               (cb_even.max_len, cb_odd.max_len), rows)
    t0 = tick("device decode kernel", t0)
    n_even = max(cb_even.symbols.size, 1)
    sym_cat = i32_tensor(np.concatenate([cb_even.symbols, cb_odd.symbols]), dev)
    mapped = map_ranks(ranks, sym_cat, n_even, small)
    t0 = tick("device rank map", t0)
    ids2 = mapped[:T].cpu().numpy().view(np.uint16 if small else np.uint32).astype(np.int64)
    t0 = tick(f"D2H ids ({mapped.numel() * mapped.element_size() >> 20} MiB)", t0)
    out = tok.detokenize(ids2, word_first, wv2, nv2)
    tick("detokenize (host)", t0)
    calls.report()
    if out != data:
        raise Mismatch("subphase round trip mismatch")


def _bench(n: int, repeats: int, dev: torch.device) -> float:
    """The HuffWord lockstep round trip, timed; returns the GB/s."""
    t0 = time.perf_counter()
    data = make_corpus(n)
    log(f"corpus gen: {time.perf_counter() - t0:.1f} s ({len(data) >> 20} MiB)")

    prof = Profiler()
    conf = huffword_conf()
    with prof.phase("tokenize+vocab (host)", n):
        _, _, word_first, wv, nv, ids = tok.build_vocabs(data)
    T = ids.size
    log(f"tokens: {T} ({n / T:.2f} B/token), vocab {wv.n}+{nv.n}")

    calls = Launches("huffword")

    def enc():
        calls.encodes += 1
        return hw._compress_huffword_device(data, conf, word_first, wv, nv, ids, device=dev)

    t0 = time.perf_counter()
    blob = enc()  # warm
    sync(dev)
    log(f"encode first call: {time.perf_counter() - t0:.2f} s")
    t_enc = timeit(enc, repeats, dev)
    prof.phases.append(Phase("encode (entry gather + K4)", t_enc, n))
    f = container.read_container(blob)
    log(f"ratio: {len(blob) / n:.4f} ({len(blob)} bytes, layout {f.layout})")

    def dec():
        calls.decodes += 1
        return decompress(blob, device=dev)

    if dec() != data:
        raise Mismatch("ROUND TRIP MISMATCH")
    t_dec = timeit(dec, repeats, dev)
    prof.phases.append(Phase("decode (K5 + detokenize)", t_dec, n))
    calls.report()
    log(prof.report())

    if os.environ.get("GLZ_HW_PROFILE"):
        _subphase_profile(data, conf, word_first, wv, nv, ids, blob, dev)

    value = 2 * n / (t_enc + t_dec) / 1e9
    log(f"combined end-to-end: {value:.3f} GB/s (enc {n / t_enc / 1e9:.3f} "
        f"dec {n / t_dec / 1e9:.3f})")
    return value


def main() -> int:
    n = mib("GLZ_BENCH_MB", "100")
    repeats = int(os.environ.get("GLZ_BENCH_REPEATS", "3"))
    try:
        dev = bench_device()
    except RuntimeError as e:
        log(f"bench_huffword_torch: {e}")
        return 2
    dog = watchdog(int(os.environ.get("GLZ_BENCH_TIMEOUT", "3000")), METRIC)
    try:
        prepare(dev)
        value = _bench(n, repeats, dev)
    except Exception:
        log(f"huffword bench FAILED:\n{traceback.format_exc()}")
        print(zero_line(METRIC), flush=True)
        return 1
    finally:
        dog.cancel()
    log(f"host peak: {host_peak_mib():.0f} MiB")
    print(json.dumps({"metric": METRIC, "value": round(value, 4), "unit": "GB/s",
                      "vs_baseline": round(value / 1.0, 4)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
