"""Broken timed paths: the control and the faults that `correct` must
catch.  Each wraps the program's entry points and breaks what they give.

  control          every decompress answer with one byte altered: the
                   configuration's lossless guarantee broken (the codec
                   states no precision to lower);
  unchanged        compress returns its input and decompress its
                   container, unchanged: a step that returns its state;
  half             half of each file (or of the batch's files) left out
                   of the compress;
  flip_container   one payload bit of every container altered where
                   compress produces it;
  unstable         the same on every other compress call of an input only
                   (its first, its third, ...): one input no longer gives
                   one container;
  raises           every compress call raises: an answer that never comes.
The cells run on one card, so no fault leaves out an exchange between
cards.
"""

from __future__ import annotations

import struct

from glzbench.harness import Entry


def _flip_byte(data: bytes) -> bytes:
    if not data:
        return b"\x01"
    b = bytearray(data)
    b[len(b) // 2] ^= 0x01
    return bytes(b)


def _flip_payload_bit(blob: bytes) -> bytes:
    """One bit in the middle of a container's payload section (in the middle
    of the container when it has no payload)."""
    b = bytearray(blob)
    at = len(b) // 2
    if len(b) >= 32 and b[:4] == b"GLZ1":
        n_groups, _, cb_size = struct.unpack_from("<III", b, 16)
        start = 32 + cb_size + 4 * n_groups
        if start < len(b):
            at = (start + len(b)) // 2
    if b:
        b[at] ^= 0x10
    return bytes(b)


class Control(Entry):
    def decompress(self, blob):
        return _flip_byte(super().decompress(blob))

    def decompress_batch(self, blobs):
        return [_flip_byte(d) for d in super().decompress_batch(blobs)]


class Unchanged(Entry):
    def compress(self, data):
        return data

    def decompress(self, blob):
        return blob

    def compress_batch(self, datas):
        return list(datas)

    def decompress_batch(self, blobs):
        return list(blobs)


class Half(Entry):
    def compress(self, data):
        return super().compress(data[: len(data) // 2])

    def compress_batch(self, datas):
        return super().compress_batch(datas[: len(datas) // 2])


class FlipContainer(Entry):
    def compress(self, data):
        return _flip_payload_bit(super().compress(data))

    def compress_batch(self, datas):
        return [_flip_payload_bit(b) for b in super().compress_batch(datas)]


class Unstable(Entry):
    def __init__(self, *args):
        super().__init__(*args)
        self.seen: dict = {}  # calls so far, by the input's identity

    def _odd(self, key) -> bool:
        self.seen[key] = self.seen.get(key, 0) + 1
        return self.seen[key] % 2 == 1

    def compress(self, data):
        blob = super().compress(data)
        return _flip_payload_bit(blob) if self._odd(id(data)) else blob

    def compress_batch(self, datas):
        blobs = super().compress_batch(datas)
        if self._odd(tuple(map(id, datas))):
            return [_flip_payload_bit(b) for b in blobs]
        return blobs


class Raises(Entry):
    def compress(self, data):
        raise RuntimeError("a broken compress")

    def compress_batch(self, datas):
        raise RuntimeError("a broken compress")


FAULTS = {"control": Control, "unchanged": Unchanged, "half": Half,
          "flip_container": FlipContainer, "unstable": Unstable, "raises": Raises}
