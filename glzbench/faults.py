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

A cell of several processes (glzbench/spmd.py) has SHARDED in their place,
each on every rank: the same six, each where the ranks' path produces it
(control: every rank's slice altered; unchanged: rank 0's "container" is
its shard and each slice the container at offset 0; half: each shard cut
to its first half in whole groups; flip_container and unstable: rank 0's
stitched container; raises: the last rank's compress raises, the others
wait in the exchange), and two that leave out part of the exchange:
  local_codebook   each rank codes its shard with its own histogram's
                   code: the histograms' all-gather left out;
  shard_dropped    the last rank's payload and group table left out of
                   process 0's stitch.
"""

from __future__ import annotations

import struct

import numpy as np

from glzbench.harness import Entry
from glzbench.spmd import ShardEntry, group_bytes


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


class ShardControl(ShardEntry):
    def decompress(self, blob):
        out, offset = super().decompress(blob)
        return _flip_byte(out), offset


class ShardUnchanged(ShardEntry):
    def compress(self, shard):
        return shard if self.rank == 0 else None

    def decompress(self, blob):
        return bytes(blob), 0


class ShardHalf(ShardEntry):
    def __init__(self, config, device=None):
        super().__init__(config, device)
        self.group = group_bytes(config)

    def compress(self, shard):
        return super().compress(shard[: max(1, len(shard) // 2 // self.group) * self.group])


class ShardFlipContainer(ShardEntry):
    def compress(self, shard):
        blob = super().compress(shard)
        return None if blob is None else _flip_payload_bit(blob)


class ShardUnstable(ShardEntry):
    def __init__(self, config, device=None):
        super().__init__(config, device)
        self.calls = 0

    def compress(self, shard):
        blob = super().compress(shard)
        self.calls += 1
        return _flip_payload_bit(blob) if blob is not None and self.calls % 2 else blob


class ShardRaises(ShardEntry):
    def compress(self, shard):
        if self.rank == self.world - 1:
            raise RuntimeError("a broken compress on the last rank")
        return super().compress(shard)


class _Patched(ShardEntry):
    """An entry that replaces one function of the program's multihost module
    while it lives (`close` puts the program's back)."""
    ATTR = ""

    def __init__(self, config, device=None):
        super().__init__(config, device)
        self.saved = getattr(self.mh, self.ATTR)
        setattr(self.mh, self.ATTR, self.broken)

    def close(self):
        setattr(self.mh, self.ATTR, self.saved)


class LocalCodebook(_Patched):
    ATTR = "_shared_byte_codebook"

    def broken(self, local_data, limit):
        from glz_tpu_torch.core.codebook import build_codebook, histogram_bytes

        return build_codebook(histogram_bytes(np.frombuffer(local_data, np.uint8)), limit)


class ShardDropped(_Patched):
    ATTR = "_gather_ragged"

    def broken(self, arr):
        parts = self.saved(arr)
        return parts[:-1] if self.rank == 0 else parts


SHARDED = {"control": ShardControl, "unchanged": ShardUnchanged, "half": ShardHalf,
           "flip_container": ShardFlipContainer, "unstable": ShardUnstable,
           "local_codebook": LocalCodebook, "shard_dropped": ShardDropped,
           "raises": ShardRaises}
