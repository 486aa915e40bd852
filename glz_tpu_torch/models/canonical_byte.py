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
"""

from __future__ import annotations

import warnings
import zlib

import numpy as np
import torch

from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import bitio, container
from glz_tpu_torch.core.api import _plan_streams, _verify
from glz_tpu_torch.core.codebook import (Codebook, build_codebook, canonical_codebook,
                                         histogram_bytes, sampled_histogram)
from glz_tpu_torch.core.lockstep import LANES
from glz_tpu_torch.ops.decode import decode_streams
from glz_tpu_torch.ops.encode import encode_block_fast
from glz_tpu_torch.ops.lockstep_decode import decode_groups
from glz_tpu_torch.ops.lockstep_encode import (MAX_FUSED_LEN,
                                               encode_payload_from_symbols)

# Symbols per bitstream dispatch (rounded down to whole streams).  Not a
# knob: it decides where the device container's word-alignment pads go, so
# it is the JAX package's value.
MAX_DISPATCH_SYMBOLS = 1 << 27


def resolve_device(device) -> torch.device:
    """None means the card.  Raises when no card is present: the CPU runs
    only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def _as_array(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


def _crc(arr: np.ndarray, conf: cfg.GlzConfig) -> int | None:
    if not conf.checksum:
        return None
    return zlib.crc32(arr.tobytes())


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _lockstep_stream_symbols(conf: cfg.GlzConfig) -> int:
    """Validate conf.stream_symbols for the lockstep layout (a power of two
    in [64, 8192])."""
    S = conf.stream_symbols
    if S & (S - 1) or not 64 <= S <= 8192:
        raise ValueError(
            f"lockstep layout needs stream_symbols a power of two in "
            f"[64, 8192], got {S}; use cfg.THROUGHPUT or set it explicitly")
    return S


def _i32_tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """u32 values -> int32 bit-pattern tensor on `dev`."""
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32).view(np.int32)).to(dev)


def entry_table(cb: Codebook, dev: torch.device) -> torch.Tensor:
    """The fused lj|len entry table of the encode kernels (max_len <= 26)."""
    return _i32_tensor(cb.left_justified_codes() | cb.lengths.astype(np.uint32), dev)


def decode_tables(cb: Codebook, dev: torch.device):
    """(fc_lj, offsets, symtab) int32 tensors of the decode kernel."""
    symtab = np.zeros(256, np.uint32)
    symtab[: cb.symbols.size] = cb.symbols
    return (_i32_tensor(cb.first_code_left_justified(), dev),
            _i32_tensor(cb.decode_offsets(), dev), _i32_tensor(symtab, dev))


def group_tables(group_words: np.ndarray, n_symbols: int, G: int, S: int,
                 dev: torch.device):
    """(group_starts int64, group_counts int32) tensors from the padded
    per-group word counts a container stores."""
    group_words = np.asarray(group_words, dtype=np.int64)
    starts = np.cumsum(group_words) - group_words
    counts = np.clip(n_symbols - np.arange(group_words.size) * G * S, 0, G * S)
    return torch.from_numpy(starts).to(dev), _i32_tensor(counts, dev)


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
        checksum=_crc(np.zeros(0, np.uint8), conf),
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
    dev = resolve_device(device)
    arr = _as_array(data)
    n = arr.size
    S = _lockstep_stream_symbols(conf)
    rows = conf.group_rows
    if rows not in (8, 16, 32, 64):
        raise ValueError(f"group_rows must be 8, 16, 32 or 64, got {rows}")
    group_syms = rows * LANES * S
    if n == 0:
        return empty_container(conf)

    limit = min(conf.length_limit or MAX_FUSED_LEN, MAX_FUSED_LEN)
    if codebook is not None:
        cb = codebook
        if cb.max_len > MAX_FUSED_LEN:
            raise ValueError(
                f"shared codebook max_len {cb.max_len} exceeds the "
                f"fused-entry limit {MAX_FUSED_LEN}")
    else:
        cb = build_codebook(sampled_histogram(arr, conf.histogram_budget), limit)
    tbl = entry_table(cb, dev)
    host = np.zeros(_round_up(n, group_syms), dtype=np.uint8)
    host[:n] = arr
    sym = torch.from_numpy(host).to(dev)
    payload, group_counts = encode_payload_from_symbols(sym, n, tbl, S, rows)
    words = payload.cpu().numpy()
    f = container.GlzFile(
        mode=cfg.MODE_BYTE,
        n_symbols=n,
        stream_symbols=S,
        stream_bits=group_counts,
        codebook_blob=container.encode_byte_codebook(cb.lengths.astype(np.uint8)),
        payload=words.astype("<i4", copy=False).tobytes(),
        layout=container.LAYOUT_LOCKSTEP,
        checksum=_crc(arr, conf),
        group_rows=rows,
    )
    return container.write_container(f)


def decompress_bytes_lockstep(blob: bytes, device=None) -> bytes:
    """Decode a layout-2 container with the lockstep decode kernel."""
    dev = resolve_device(device)
    f = container.read_container(blob)
    if f.layout != container.LAYOUT_LOCKSTEP:
        raise ValueError("not a lockstep-layout container")
    if f.n_symbols == 0:
        return b""
    cb = canonical_codebook(container.decode_byte_codebook(f.codebook_blob))
    S = f.stream_symbols
    if S & (S - 1) or not 64 <= S <= 8192:
        raise ValueError(f"corrupt .glz container: lockstep stream_symbols {S}")
    G = f.group_rows * LANES
    if f.n_streams * G * S < f.n_symbols:
        raise ValueError("corrupt .glz container: group table too short")
    starts, counts = group_tables(f.stream_bits, f.n_symbols, G, S, dev)
    words = np.frombuffer(f.payload, dtype="<u4", count=len(f.payload) // 4)
    out = decode_groups(_i32_tensor(words, dev), starts, counts,
                        *decode_tables(cb, dev), S, cb.min_len, cb.max_len,
                        f.group_rows)
    return _verify(out[: f.n_symbols].cpu().numpy().tobytes(), f)


# ---- bitstream layout (layout 0) ---------------------------------------------

def _symbols_on(chunk: np.ndarray, padded: int, dev: torch.device) -> torch.Tensor:
    """A u8 chunk on `dev`, zero-padded to `padded` symbols (read-only input
    buffers are only read)."""
    out = torch.zeros(padded, dtype=torch.uint8, device=dev)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        out[: chunk.size].copy_(torch.from_numpy(chunk))
    return out


def compress_bytes_device(data: bytes | np.ndarray, conf: cfg.GlzConfig = cfg.DEFAULT,
                          codebook: Codebook | None = None, device=None) -> bytes:
    """Layout-0 (bitstream) compression into the device path's container
    (word-aligned dispatches), on the card (device=None) or, with
    device='cpu', through the kernels' plain versions; a lockstep conf goes
    to compress_bytes_lockstep.  The container equals the JAX package's
    compress_bytes_device (its backend='device' path) byte for byte.

    codebook: optional pre-built shared Codebook (every file of a shared
    batch encodes with the same code)."""
    if conf.layout == cfg.LAYOUT_LOCKSTEP:
        return compress_bytes_lockstep(data, conf, codebook=codebook, device=device)
    dev = resolve_device(device)
    arr = _as_array(data)
    n = arr.size
    if n == 0:
        return empty_container(conf)
    S = _plan_streams(n, conf)
    dispatch = max((MAX_DISPATCH_SYMBOLS // S) * S, S)
    cb = codebook if codebook is not None else build_codebook(
        sampled_histogram(arr, conf.histogram_budget), conf.length_limit)
    lj_tbl = _i32_tensor(cb.left_justified_codes(), dev)
    len_tbl = _i32_tensor(cb.lengths, dev)

    payload_parts: list[bytes] = []
    stream_bits_parts: list[np.ndarray] = []
    for lo in range(0, n, dispatch):
        n_valid = min(n, lo + dispatch) - lo
        sym = _symbols_on(arr[lo : lo + n_valid], _round_up(n_valid, S), dev)
        words, total_bits, stream_bits = encode_block_fast(sym, n_valid, lj_tbl, len_tbl, S)
        del sym
        sb = stream_bits[: -(-n_valid // S)].cpu().numpy()
        # word-align this dispatch: inflate its last stream's recorded advance
        sb[-1] += 32 * words.numel() - total_bits
        payload_parts.append(words.cpu().numpy().view(np.uint32).astype(">u4").tobytes())
        stream_bits_parts.append(sb)
        del words

    f = container.GlzFile(
        mode=cfg.MODE_BYTE,
        n_symbols=n,
        stream_symbols=S,
        stream_bits=np.concatenate(stream_bits_parts),
        codebook_blob=container.encode_byte_codebook(cb.lengths.astype(np.uint8)),
        payload=b"".join(payload_parts),
        checksum=_crc(arr, conf),
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
    word stays on the card and is ORed into the next dispatch's first.

    codebook: optional pre-built shared Codebook."""
    dev = resolve_device(device)
    arr = _as_array(data)
    n = arr.size
    if n == 0:
        return empty_container(conf, None if codebook is None else codebook.lengths)
    S = _plan_streams(n, conf)
    dispatch = max((MAX_DISPATCH_SYMBOLS // S) * S, S)
    cb = codebook if codebook is not None else build_codebook(histogram_bytes(arr),
                                                              conf.length_limit)
    lj_tbl = _i32_tensor(cb.left_justified_codes(), dev)
    len_tbl = _i32_tensor(cb.lengths, dev)

    word_parts: list[np.ndarray] = []
    stream_bits_parts: list[np.ndarray] = []
    pos = 0                # bits so far
    carry = None           # the last, partial word so far (1 word, on the card)
    for lo in range(0, n, dispatch):
        n_valid = min(n, lo + dispatch) - lo
        sym = _symbols_on(arr[lo : lo + n_valid], _round_up(n_valid, S), dev)
        words, total_bits, stream_bits = encode_block_fast(sym, n_valid, lj_tbl, len_tbl, S,
                                                           bit_offset=pos)
        del sym
        if carry is not None:
            words[:1].bitwise_or_(carry)
        pos += total_bits
        whole = words.numel() - (1 if pos & 31 else 0)
        carry = words[whole:] if pos & 31 else None
        word_parts.append(words[:whole].cpu().numpy().view(np.uint32))
        stream_bits_parts.append(stream_bits[: -(-n_valid // S)].cpu().numpy())
        del words
    if carry is not None:
        word_parts.append(carry.cpu().numpy().view(np.uint32))

    f = container.GlzFile(
        mode=cfg.MODE_BYTE,
        n_symbols=n,
        stream_symbols=S,
        stream_bits=np.concatenate(stream_bits_parts).astype(np.uint64),
        codebook_blob=container.encode_byte_codebook(cb.lengths.astype(np.uint8)),
        payload=bitio.words_to_bytes(np.concatenate(word_parts), pos),
        checksum=_crc(arr, conf),
    )
    return container.write_container(f)


def decompress_bytes_device(blob: bytes, device=None) -> bytes:
    """Decode a byte-mode container: layout 0 (written by either package,
    word-aligned dispatches or the host encoder's byte-aligned payload) with
    the stream decode kernel, layout 2 with decompress_bytes_lockstep."""
    f = container.read_container(blob)
    if f.mode != cfg.MODE_BYTE:
        raise ValueError("not a byte-mode container")
    if f.layout == container.LAYOUT_LOCKSTEP:
        return decompress_bytes_lockstep(blob, device=device)
    dev = resolve_device(device)
    if f.n_symbols == 0:
        return _verify(b"", f)
    cb = canonical_codebook(container.decode_byte_codebook(f.codebook_blob))
    if cb.max_len == 0:
        raise ValueError("corrupt .glz container: no byte has a code")
    S = f.stream_symbols
    if S < 1 or f.n_streams * S < f.n_symbols:
        raise ValueError("corrupt .glz container: stream table too short")
    sbits = f.stream_bits.astype(np.int64)
    starts = np.cumsum(sbits) - sbits
    out = decode_streams(_i32_tensor(bitio.bytes_to_words(f.payload), dev),
                         torch.from_numpy(starts).to(dev), f.n_symbols, S,
                         *decode_tables(cb, dev), cb.min_len, cb.max_len)
    return _verify(out.cpu().numpy().tobytes(), f)
