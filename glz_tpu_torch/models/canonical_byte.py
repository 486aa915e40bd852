"""Canonical byte-symbol codec: the bitstream layout (layout 0) and the
lockstep layout (layout 2).

Histogram and codebook on the host (256 symbols, microseconds); the kernels
on the card.  Containers are byte-identical to the JAX package's for the
same input, configuration and (stream_symbols, group_rows).

Lockstep: lane totals, the reverse-sweep encode and the lockstep decode.
The whole input is encoded in one launch per kernel.  The container does
not depend on how the input is split into launches, because every split is
a whole number of groups; all kernel index math is 64-bit.

Bitstream: the byte lookup (K7) and the bit pack (its scan and its pack)
per dispatch of MAX_DISPATCH_SYMBOLS rounded down to whole streams, and the
stream decode.  Two containers, as in the JAX package:
  * compress_bytes_host (its backend="host", the default) writes the host
    encoder's: an exact histogram, one bit stream across the dispatches,
    each packed from the running bit offset (the word two dispatches share
    is ORed on the card), and payload bytes up to the last code bit, the
    last partial byte padded with 1s.  The split does not show in it;
  * compress_bytes_device (backend="device") writes the device path's: each
    dispatch's payload padded to whole u32 words (stored big-endian), the
    pad bits added to the recorded bit count of the dispatch's last stream.
Decode never reads past a stream's symbol count, so it reads both.

Each step is a span of utils/timer.py (`histogram`, `codebook`, `tables`,
`encode` / `decode`, `d2h`, `serialize`; the copies' own in
models/transfer.py, the container's and `verify` in core/container.py, the
bit streams' in core/bitio.py).  Every copy between host and card goes
through models/transfer.py.  The front door (core/api.py) parses a
container once and hands the GlzFile to the decode of its layout.
"""

from __future__ import annotations

import numpy as np
import torch

from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import bitio, container, lockstep
from glz_tpu_torch.core.codebook import (Codebook, build_codebook, canonical_codebook,
                                         sampled_histogram)
from glz_tpu_torch.models import transfer
from glz_tpu_torch.ops.decode import decode_streams
from glz_tpu_torch.ops.encode import encode_block_fast
from glz_tpu_torch.ops.lockstep_decode import decode_groups
from glz_tpu_torch.ops.lockstep_encode import encode_payload_from_symbols
from glz_tpu_torch.utils import timer

# Symbols per bitstream dispatch (rounded down to whole streams).  Not a
# knob: it decides where the device container's word-alignment pads go, so
# it is the JAX package's value.
MAX_DISPATCH_SYMBOLS = 1 << 27


def _as_array(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


def entry_table(cb: Codebook, dev: torch.device) -> torch.Tensor:
    """The fused lj|len entry table of the encode kernels (max_len <= 26)."""
    with timer.span("tables"):
        return transfer.i32_tensor(cb.left_justified_codes() | cb.lengths.astype(np.uint32), dev)


def decode_tables(cb: Codebook, dev: torch.device):
    """(fc_lj, offsets, symtab) int32 tensors of the decode kernel."""
    with timer.span("tables"):
        symtab = np.zeros(256, np.uint32)
        symtab[: cb.symbols.size] = cb.symbols
        return (transfer.i32_tensor(cb.first_code_left_justified(), dev),
                transfer.i32_tensor(cb.decode_offsets(), dev), transfer.i32_tensor(symtab, dev))


def group_tables(group_words: np.ndarray, n_symbols: int, G: int, S: int,
                 dev: torch.device):
    """(group_starts int64, group_counts int32) tensors from the padded
    per-group word counts a container stores."""
    with timer.span("tables"):
        group_words = np.asarray(group_words, dtype=np.int64)
        starts = np.cumsum(group_words) - group_words
        counts = np.clip(n_symbols - np.arange(group_words.size) * G * S, 0, G * S)
        return torch.from_numpy(starts).to(dev), transfer.i32_tensor(counts, dev)


def stream_starts(f: container.GlzFile, dev: torch.device) -> torch.Tensor:
    """The first bit of each stream of bitstream container f (int64 on
    `dev`), after checking that its stream table covers its symbols."""
    S = f.stream_symbols
    if S < 1 or f.n_streams * S < f.n_symbols:
        raise ValueError("corrupt .glz container: stream table too short")
    with timer.span("tables"):
        sbits = f.stream_bits.astype(np.int64)
        return torch.from_numpy(np.cumsum(sbits) - sbits).to(dev)


def _byte_codebook(arr: np.ndarray, budget: int | None, limit: int | None) -> Codebook:
    """The codebook of one input: its histogram (sampled within `budget`
    bytes; budget None counts every byte), then the length-limited code."""
    with timer.span("histogram"):
        hist = sampled_histogram(arr, budget)
    with timer.span("codebook"):
        return build_codebook(hist, limit)


def _parsed_byte_codebook(f: container.GlzFile) -> Codebook:
    """The codebook a byte-mode container stores."""
    with timer.span("codebook"):
        return canonical_codebook(container.decode_byte_codebook(f.codebook_blob))


def empty_container(conf: cfg.GlzConfig, lengths: np.ndarray | None = None) -> bytes:
    """The container of an empty input: bitstream layout, one stream of 0
    bits, the code lengths (all zero when none are given) and no payload."""
    f = container.GlzFile(
        mode=cfg.MODE_BYTE,
        n_symbols=0,
        stream_symbols=conf.stream_symbols,
        stream_bits=np.zeros(1, dtype=np.uint64),
        codebook_blob=container.encode_byte_codebook(
            np.zeros(256, np.uint8) if lengths is None else lengths.astype(np.uint8)),
        payload=b"",
        checksum=container.checksum_of(b"", conf),
    )
    return container.write_container(f)


def compress_bytes_lockstep(data: bytes | np.ndarray,
                            conf: cfg.GlzConfig = cfg.THROUGHPUT,
                            codebook: Codebook | None = None,
                            device=None) -> bytes:
    """Layout-2 (lockstep) compression on the card (device=None) or, with
    device='cpu', through the kernels' plain versions.

    Code lengths are capped at 26 (package-merge) so the fused lj|len entry
    word applies.  codebook: optional pre-built shared Codebook
    (max_len must be <= 26)."""
    dev = transfer.resolve_device(device)
    arr = _as_array(data)
    n = arr.size
    S = lockstep.stream_symbols(conf)
    rows = lockstep.group_rows(conf)
    if n == 0:
        return empty_container(conf)

    if codebook is not None:
        cb = codebook
        if cb.max_len > lockstep.MAX_FUSED_LEN:
            raise ValueError(
                f"shared codebook max_len {cb.max_len} exceeds the "
                f"fused-entry limit {lockstep.MAX_FUSED_LEN}")
    else:
        cb = _byte_codebook(arr, conf.histogram_budget, lockstep.fused_length_limit(conf))
    tbl = entry_table(cb, dev)
    sym = transfer.symbols_on(arr, transfer.round_up(n, rows * lockstep.LANES * S), dev)
    with timer.span("encode"):
        payload, group_counts = encode_payload_from_symbols(sym, n, tbl, S, rows)
    with timer.span("d2h"):
        words = transfer.host_array(payload)
    f = container.GlzFile(
        mode=cfg.MODE_BYTE,
        n_symbols=n,
        stream_symbols=S,
        stream_bits=group_counts,
        codebook_blob=container.encode_byte_codebook(cb.lengths.astype(np.uint8)),
        payload=transfer.words_buffer(words),
        layout=container.LAYOUT_LOCKSTEP,
        checksum=container.checksum_of(arr, conf),
        group_rows=rows,
    )
    return container.write_container(f)


def decompress_bytes_lockstep(f: container.GlzFile, device=None) -> bytes:
    """Decode a parsed layout-2 container with the lockstep decode kernel."""
    dev = transfer.resolve_device(device)
    if f.n_symbols == 0:
        return b""
    cb = _parsed_byte_codebook(f)
    G = lockstep.group_streams(f)
    starts, counts = group_tables(f.stream_bits, f.n_symbols, G, f.stream_symbols, dev)
    tables = decode_tables(cb, dev)
    payload = transfer.payload_words_on(f.payload, dev)
    with timer.span("decode"):
        out = decode_groups(payload, starts, counts, *tables, f.stream_symbols, cb.min_len,
                            cb.max_len, f.group_rows)
    return container.verify(transfer.host_bytes(out[: f.n_symbols]), f)


# ---- bitstream layout (layout 0) ---------------------------------------------

def compress_bytes_device(data: bytes | np.ndarray, conf: cfg.GlzConfig = cfg.DEFAULT,
                          codebook: Codebook | None = None, device=None) -> bytes:
    """Layout-0 (bitstream) compression into the device path's container
    (word-aligned dispatches), on the card (device=None) or, with
    device='cpu', through the kernels' plain versions.  The container equals
    the JAX package's compress_bytes_device (its backend='device' path) byte
    for byte.

    codebook: optional pre-built shared Codebook (every file of a shared
    batch encodes with the same code)."""
    dev = transfer.resolve_device(device)
    arr = _as_array(data)
    n = arr.size
    if n == 0:
        return empty_container(conf)
    S = bitio.plan_streams(n, conf)
    dispatch = max((MAX_DISPATCH_SYMBOLS // S) * S, S)
    cb = codebook if codebook is not None else _byte_codebook(arr, conf.histogram_budget,
                                                              conf.length_limit)
    lj_tbl, len_tbl = _lj_len_tables(cb, dev)

    payload_parts: list[bytes] = []
    stream_bits_parts: list[np.ndarray] = []
    for lo in range(0, n, dispatch):
        n_valid = min(n, lo + dispatch) - lo
        sym = transfer.symbols_on(arr[lo : lo + n_valid], transfer.round_up(n_valid, S), dev)
        with timer.span("encode"):
            words, total_bits, stream_bits = encode_block_fast(sym, n_valid, lj_tbl, len_tbl,
                                                               S)
        del sym
        with timer.span("d2h"):
            sb = stream_bits[: -(-n_valid // S)].cpu().numpy()
            host = transfer.host_array(words)
        # word-align this dispatch: inflate its last stream's recorded advance
        sb[-1] += 32 * words.numel() - total_bits
        with timer.span("serialize"):
            payload_parts.append(host.view(np.uint32).astype(">u4").tobytes())
            timer.count(timer.HOST_COPY_BYTES, 2 * host.nbytes)
        stream_bits_parts.append(sb)
        del words

    with timer.span("serialize"):
        payload = b"".join(payload_parts)
        timer.count(timer.HOST_COPY_BYTES, len(payload))
    f = container.GlzFile(
        mode=cfg.MODE_BYTE,
        n_symbols=n,
        stream_symbols=S,
        stream_bits=np.concatenate(stream_bits_parts),
        codebook_blob=container.encode_byte_codebook(cb.lengths.astype(np.uint8)),
        payload=payload,
        checksum=container.checksum_of(arr, conf),
    )
    return container.write_container(f)


def compress_bytes_host(data: bytes | np.ndarray, conf: cfg.GlzConfig = cfg.DEFAULT,
                        codebook: Codebook | None = None, device=None) -> bytes:
    """Layout-0 (bitstream) compression into the host encoder's container
    (glz_tpu/core/api.py:compress_bytes_host, glz_tpu's default), on the
    card (device=None) or, with device='cpu', through the kernels' plain
    versions.  The histogram is exact whatever conf.histogram_budget says.

    Dispatch k is packed from bit pos_k (the bits of dispatches 0..k-1), so
    its first word is the previous one's last when pos_k % 32 != 0: that
    word stays on the card and is ORed into the next dispatch's first.  The
    D2H'd words become the payload where they lie (bitio.words_to_payload),
    so the container's join is the payload's one host copy.

    codebook: optional pre-built shared Codebook."""
    dev = transfer.resolve_device(device)
    arr = _as_array(data)
    n = arr.size
    if n == 0:
        return empty_container(conf, None if codebook is None else codebook.lengths)
    S = bitio.plan_streams(n, conf)
    dispatch = max((MAX_DISPATCH_SYMBOLS // S) * S, S)
    cb = codebook if codebook is not None else _byte_codebook(arr, None, conf.length_limit)
    lj_tbl, len_tbl = _lj_len_tables(cb, dev)

    word_parts: list[np.ndarray] = []
    stream_bits_parts: list[np.ndarray] = []
    pos = 0                # bits so far
    carry = None           # the last, partial word so far (1 word, on the card)
    for lo in range(0, n, dispatch):
        n_valid = min(n, lo + dispatch) - lo
        sym = transfer.symbols_on(arr[lo : lo + n_valid], transfer.round_up(n_valid, S), dev)
        with timer.span("encode"):
            words, total_bits, stream_bits = encode_block_fast(sym, n_valid, lj_tbl, len_tbl,
                                                               S, bit_offset=pos)
            del sym
            if carry is not None:
                words[:1].bitwise_or_(carry)
        pos += total_bits
        last = lo + n_valid == n
        whole = words.numel() - (1 if pos & 31 and not last else 0)
        carry = words[whole:] if whole < words.numel() else None
        with timer.span("d2h"):
            word_parts.append(transfer.host_array(words[:whole]).view(np.uint32))
            stream_bits_parts.append(stream_bits[: -(-n_valid // S)].cpu().numpy())
        del words

    with timer.span("serialize"):
        if len(word_parts) == 1:
            words = word_parts[0]
        else:
            words = np.concatenate(word_parts)
            timer.count(timer.HOST_COPY_BYTES, words.nbytes)
        payload = bitio.words_to_payload(words, pos)
    f = container.GlzFile(
        mode=cfg.MODE_BYTE,
        n_symbols=n,
        stream_symbols=S,
        stream_bits=np.concatenate(stream_bits_parts).astype(np.uint64),
        codebook_blob=container.encode_byte_codebook(cb.lengths.astype(np.uint8)),
        payload=payload,
        checksum=container.checksum_of(arr, conf),
    )
    return container.write_container(f)


def decompress_bytes_device(f: container.GlzFile, device=None,
                            variant: str = cfg.DECODER_TABLE) -> bytes:
    """Decode a parsed layout-0 byte container (written by either package,
    word-aligned dispatches or the host encoder's byte-aligned payload) with
    the stream decode kernel of the decoder strategy `variant` ("table",
    "fast" or "bitwalk"; any other raises ValueError, as glz_tpu's host
    decode does, once there is a symbol to decode)."""
    dev = transfer.resolve_device(device)
    if f.n_symbols == 0:
        return container.verify(b"", f)
    cb = _parsed_byte_codebook(f)
    if cb.max_len == 0:
        raise ValueError("corrupt .glz container: no byte has a code")
    starts = stream_starts(f, dev)
    tables = decode_tables(cb, dev)
    payload = transfer.payload_words_on(transfer.bitstream_words(f.payload), dev)
    with timer.span("decode"):
        out = decode_streams(payload, starts, f.n_symbols, f.stream_symbols, *tables,
                             cb.min_len, cb.max_len, variant=variant, n_codes=cb.symbols.size)
    return container.verify(transfer.host_bytes(out), f)


def _lj_len_tables(cb: Codebook, dev: torch.device):
    """(lj, length) int32 tables of the byte lookup (K7)."""
    with timer.span("tables"):
        return (transfer.i32_tensor(cb.left_justified_codes(), dev),
                transfer.i32_tensor(cb.lengths, dev))
