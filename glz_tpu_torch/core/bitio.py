"""MSB-first bit streams as bytes and u32 words (host numpy).

A copy of the serialisation half of glz_tpu/core/bitio.py.  Codes are
emitted most-significant bit first; a word w covers stream bits
[32w, 32w + 32), and its bytes are stored big-endian.  A bitstream payload
that ends inside a byte pads that byte with 1s (the reference codec's
flush_bits).
"""

from __future__ import annotations

import numpy as np


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
