"""MSB-first bit streams as bytes and u32 words (host numpy).

A copy of glz_tpu/core/bitio.py's packing half (pack_codes_msb and
BitWriter, which the .crs writer uses) and its serialisation half, and of
glz_tpu/core/api.py's _plan_streams (plan_streams: how a bitstream
container splits its symbols into streams).  Codes
are emitted most-significant bit first; a word w covers stream bits
[32w, 32w + 32), and its bytes are stored big-endian.  A bitstream payload
that ends inside a byte pads that byte with 1s (the reference codec's
flush_bits).

words_to_bytes (or words_to_payload, its in-place form) and bytes_to_words
are the `bitio.words_to_bytes` and `bitio.bytes_to_words` spans of
utils/timer.py (inside the callers' `serialize`), each counting as
`host_copy_bytes` every payload-sized host buffer it writes.
"""

from __future__ import annotations

import sys

import numpy as np

from glz_tpu_torch.utils import timer

_U64 = np.uint64
_U32 = np.uint32


def plan_streams(n_symbols: int, conf) -> int:
    """Pick symbols-per-stream: honor conf.stream_symbols but cap stream
    count (size budget) and guarantee at least one stream."""
    if n_symbols == 0:
        return conf.stream_symbols
    s = conf.stream_symbols
    n_streams = -(-n_symbols // s)
    if n_streams > conf.max_streams:
        s = -(-n_symbols // conf.max_streams)
    return s


def pack_codes_msb(codes: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, int]:
    """Pack per-symbol codes (right-justified values, bit length in lens)
    into an MSB-first bit stream.

    Returns (u32 word array in big-endian bit order, total_bits).  Word w
    covers stream bits [32w, 32w+32), most significant bit first; serialize
    with words.astype('>u4').tobytes().
    """
    codes = np.asarray(codes, dtype=np.uint64)
    lens = np.asarray(lens, dtype=np.uint64)
    if codes.size == 0:
        return np.zeros(0, dtype=_U32), 0
    ends = np.cumsum(lens, dtype=np.uint64)
    total_bits = int(ends[-1])
    offsets = ends - lens
    n_words = (total_bits + 31) >> 5

    lj = (codes << (_U64(32) - lens)) & _U64(0xFFFFFFFF)  # left-justified in 32
    phase = offsets & _U64(31)
    lo_idx = (offsets >> _U64(5)).astype(np.int64)
    lo_val = (lj >> phase).astype(_U32)
    hi_val = ((lj << (_U64(32) - phase)) & _U64(0xFFFFFFFF)).astype(_U32)
    # phase == 0 -> shift by 32 is UB; mask it out
    hi_val = np.where(phase == 0, _U32(0), hi_val)

    words = np.zeros(n_words + 1, dtype=_U32)
    np.bitwise_or.at(words, lo_idx, lo_val)
    np.bitwise_or.at(words, lo_idx + 1, hi_val)
    return words[:n_words], total_bits


def words_to_bytes(words: np.ndarray, total_bits: int, pad_ones: bool = True) -> bytes:
    """Serialize u32 bit-words to bytes; pad the final partial byte with 1s
    (matching reference flush_bits) unless pad_ones=False (zero padding).
    The caller's words stay as they are: two host copies, the big-endian
    words and the bytes returned."""
    with timer.span("bitio.words_to_bytes"):
        big = words.astype(">u4")
        out = _cut_and_pad(big.view(np.uint8), total_bits, pad_ones).tobytes()
        timer.count(timer.HOST_COPY_BYTES, big.nbytes + len(out))
        return out


def words_to_payload(words: np.ndarray, total_bits: int, pad_ones: bool = True) -> memoryview:
    """words_to_bytes in place, for u32 words the caller hands over (a
    D2H'd buffer): they are swapped to big-endian where they lie and the
    final partial byte is padded there, and the payload's bytes are returned
    as a view of that memory.  No host copy."""
    with timer.span("bitio.words_to_bytes"):
        if words.dtype != np.uint32 or not words.flags.c_contiguous:
            raise ValueError(f"words_to_payload takes contiguous uint32 words, not {words.dtype}")
        if sys.byteorder == "little":
            words.byteswap(inplace=True)
        return memoryview(_cut_and_pad(words.view(np.uint8), total_bits, pad_ones))


def _cut_and_pad(raw: np.ndarray, total_bits: int, pad_ones: bool) -> np.ndarray:
    """The stream's bytes of big-endian words' bytes `raw`, the final partial
    byte's unused bits set to 1 (pad_ones) or 0, in place."""
    n_bytes = (total_bits + 7) >> 3
    raw = raw[:n_bytes]
    rem = total_bits & 7
    if rem and n_bytes:
        mask = (1 << (8 - rem)) - 1
        if pad_ones:
            raw[-1] |= mask
        else:
            raw[-1] &= ~mask & 0xFF
    return raw


def bytes_to_words(data: bytes | np.ndarray) -> np.ndarray:
    """Byte stream -> u32 big-endian bit words (zero-padded tail), converted
    into one new buffer."""
    with timer.span("bitio.bytes_to_words"):
        if isinstance(data, (bytes, bytearray, memoryview)):
            arr = np.frombuffer(data, dtype=np.uint8)
            copied = 0
        else:
            arr = np.asarray(data, dtype=np.uint8)
            copied = 0 if arr is data else arr.nbytes  # another dtype is converted
        whole = arr.size // 4
        words = np.empty(-(-arr.size // 4), dtype=np.uint32)
        words[:whole] = arr[: 4 * whole].view(">u4")
        if whole < words.size:
            tail = np.zeros(4, dtype=np.uint8)
            tail[: arr.size - 4 * whole] = arr[4 * whole :]
            words[whole] = tail.view(">u4")[0]
        timer.count(timer.HOST_COPY_BYTES, copied + words.nbytes)
        return words


class BitWriter:
    """Sequential MSB-first bit writer (host compat paths: reference
    container formats).  Mirrors Buffer's bit facilities (buffer.h:241-295).
    """

    def __init__(self) -> None:
        self._out = bytearray()
        self._acc = 0
        self._nbits = 0

    def write_bits(self, code: int, n: int) -> None:
        self._acc = (self._acc << n) | (code & ((1 << n) - 1))
        self._nbits += n
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def left_bits(self) -> int:
        return (8 - self._nbits) % 8

    def flush_bits(self, pad_bit: int = 1) -> None:
        while self._nbits:
            self.write_bits(pad_bit, 1)

    def write_bytes(self, b: bytes) -> None:
        assert self._nbits == 0
        self._out.extend(b)

    def getvalue(self) -> bytes:
        return bytes(self._out)
