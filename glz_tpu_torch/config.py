"""Runtime configuration for glz_tpu_torch.

The same knobs, constants and presets as the JAX package's configuration:
a container written under one `GlzConfig` must be byte-identical in both
packages, so every field keeps its meaning and its default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


# Symbol modes (container header byte 5)
MODE_BYTE = 0        # 256 byte symbols
MODE_HUFFWORD = 1    # dual word/non-word token dictionaries
MODE_NORMAL_TREE = 2 # legacy explicit-tree codec

# Decoder strategies
DECODER_BITWALK = "bitwalk"
DECODER_FAST = "fast"
DECODER_TABLE = "table"
DECODER_DEVICE = "device"

# Payload layouts (mirrored by glz_tpu_torch.core.container constants)
LAYOUT_BITSTREAM = "bitstream"  # bit-stitched streams + per-stream bit table
LAYOUT_LOCKSTEP = "lockstep"    # decoder-consumption-order words (GPU path)


@dataclasses.dataclass(frozen=True)
class GlzConfig:
    """Knobs for the block-parallel codec.

    stream_symbols: input symbols per independent stream.  The lockstep
        layout needs a power of two in [64, 8192].
    max_streams: upper bound on stream count for the bitstream layout.
    table_bits: decoder LUT width of the bitstream decoders.
    length_limit: optional hard cap on code length (package-merge).  The
        lockstep layout additionally caps at 26: the encode kernel's fused
        lj|len entry word spends 6 bits on the length.
    layout: payload layout for byte-mode compress().
    checksum: store a crc32 of the original data in the container and verify
        it on decompress.
    histogram_budget: byte budget for the codebook histogram.  None = exact
        scan; a value estimates frequencies from evenly spaced 4 KiB blocks
        with +1 smoothing (any histogram yields a valid code, so round trips
        stay exact).
    group_rows: lockstep group geometry — a group decodes group_rows*128
        streams in lockstep; 8/16/32/64 are supported and the container
        records the value (header byte 7).
    """

    stream_symbols: int = 1 << 18
    max_streams: int = 1 << 16
    table_bits: int = 16
    length_limit: Optional[int] = 32
    layout: str = LAYOUT_BITSTREAM
    checksum: bool = False
    histogram_budget: Optional[int] = None
    group_rows: int = 8


# Few streams, tiny header: the bitstream preset for the smallest container.
# HuffWord reads its stream size as "no preference" (models/huffword.py).
RATIO = GlzConfig(stream_symbols=1 << 19, max_streams=192)

# Lockstep layout, 512-symbol streams in 64-row (8192-stream) groups,
# sampled histogram: the main path of the codec.
THROUGHPUT = GlzConfig(stream_symbols=1 << 9, layout=LAYOUT_LOCKSTEP,
                       histogram_budget=8 << 20, group_rows=64)

DEFAULT = GlzConfig()
