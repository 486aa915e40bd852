"""MSB-first bit streams as bytes and u32 words (host numpy).

A copy of glz_tpu/core/bitio.py's packing half (pack_codes_msb and
BitWriter, which the .crs writer uses) and its serialisation half.  Codes
are emitted most-significant bit first; a word w covers stream bits
[32w, 32w + 32), and its bytes are stored big-endian.  A bitstream payload
that ends inside a byte pads that byte with 1s (the reference codec's
flush_bits).
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64
_U32 = np.uint32


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
    (matching reference flush_bits) unless pad_ones=False (zero padding)."""
    n_bytes = (total_bits + 7) >> 3
    raw = bytearray(words.astype(">u4").tobytes()[:n_bytes])
    rem = total_bits & 7
    if rem and n_bytes:
        mask = (1 << (8 - rem)) - 1
        if pad_ones:
            raw[-1] |= mask
        else:
            raw[-1] &= ~mask & 0xFF
    return bytes(raw)


def bytes_to_words(data: bytes | np.ndarray) -> np.ndarray:
    """Byte stream -> u32 big-endian bit words (zero-padded tail)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(data, dtype=np.uint8)
    else:
        arr = np.asarray(data, dtype=np.uint8)
    pad = (-arr.size) % 4
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, dtype=np.uint8)])
    return arr.view(">u4").astype(np.uint32)


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
