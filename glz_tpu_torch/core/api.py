"""compress()/decompress(): the front door.

This slice of the port carries the lockstep layout in byte mode and in
HuffWord mode, and the empty-input container.  Every other mode and layout
raises NotImplementedError naming the slice that brings it.
"""

from __future__ import annotations

import zlib

from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import container

# Slices of the port (ROADMAP.md, queue A) that bring the other routes.
_LATER_MODES = {
    cfg.MODE_NORMAL_TREE: "the front-door slice (ROADMAP A5)",
}
_BITSTREAM_SLICE = "the bitstream device slice (ROADMAP A8)"


def _verify(data: bytes, f: container.GlzFile) -> bytes:
    """crc32 integrity check when the container carries one."""
    if f.checksum is not None:
        if zlib.crc32(data) & 0xFFFFFFFF != f.checksum:
            raise ValueError("checksum mismatch: corrupt container or decoder bug")
    return data


def _pipelined(fn, datas, pipeline: bool) -> list:
    """Per-file compress with a 2-deep overlap: with pipeline=True two files
    are in flight at once on a thread pool, so one file's host phases run
    while the other's kernels do.  Results come back in input order."""
    if len(datas) <= 1 or not pipeline:
        return [fn(d) for d in datas]
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        return list(ex.map(fn, datas))


def compress(data: bytes, mode: int = cfg.MODE_BYTE,
             conf: cfg.GlzConfig = cfg.THROUGHPUT, device=None) -> bytes:
    """Compress `data` into a .glz container (byte or HuffWord mode,
    lockstep layout).

    device: None runs on the card; 'cpu' runs the kernels' plain versions."""
    from glz_tpu_torch.models.canonical_byte import compress_bytes_lockstep

    if mode == cfg.MODE_HUFFWORD:
        from glz_tpu_torch.models.huffword import compress_huffword
        return compress_huffword(data, conf, device=device)
    if mode != cfg.MODE_BYTE:
        if mode in _LATER_MODES:
            raise NotImplementedError(f"mode {mode} comes with {_LATER_MODES[mode]}")
        raise ValueError(f"unsupported mode {mode}")
    if conf.layout != cfg.LAYOUT_LOCKSTEP:
        raise NotImplementedError(
            f"layout {conf.layout!r} comes with {_BITSTREAM_SLICE}; "
            f"use layout {cfg.LAYOUT_LOCKSTEP!r} (cfg.THROUGHPUT)")
    return compress_bytes_lockstep(data, conf, device=device)


def decompress(blob: bytes, device=None) -> bytes:
    """Decompress a .glz container (mode and layout are self-describing)."""
    from glz_tpu_torch.models.canonical_byte import (decompress_bytes_lockstep,
                                                     resolve_device)
    from glz_tpu_torch.models.huffword import decompress_huffword

    resolve_device(device)
    f = container.read_container(blob)
    if f.mode not in (cfg.MODE_BYTE, cfg.MODE_HUFFWORD):
        if f.mode in _LATER_MODES:
            raise NotImplementedError(
                f"container mode {f.mode} comes with {_LATER_MODES[f.mode]}")
        raise ValueError(f"unsupported container mode {f.mode}")
    if f.layout == container.LAYOUT_LOCKSTEP:
        if f.mode == cfg.MODE_HUFFWORD:
            return decompress_huffword(blob, device=device)
        return decompress_bytes_lockstep(blob, device=device)
    if f.n_symbols == 0:
        return _verify(b"", f)
    raise NotImplementedError(f"bitstream-layout containers come with {_BITSTREAM_SLICE}")
