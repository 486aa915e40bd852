"""compress()/decompress(): the front door, with glz_tpu's signatures and
defaults (glz_tpu/core/api.py).

The port carries byte mode and HuffWord mode in both payload layouts:
bitstream (layout 0) and lockstep (layout 2).  `backend` picks the
container as glz_tpu's does: "host" (the default) writes the host
encoder's byte container (one bit stream, payload bytes up to the last
code bit), "device" the device path's (word-aligned dispatches), and a
HuffWord "device" request writes a lockstep container.  Every backend runs
on the card; device='cpu' runs the kernels' plain versions.  The
normal-tree mode raises NotImplementedError naming the slice that brings
it.
"""

from __future__ import annotations

import zlib

from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import container

# Slices of the port (ROADMAP.md, queue A) that bring the other routes.
_LATER_MODES = {
    cfg.MODE_NORMAL_TREE: "the rest of the front-door slice (ROADMAP A1)",
}
BACKENDS = ("host", "device")
VARIANTS = (cfg.DECODER_BITWALK, cfg.DECODER_FAST, cfg.DECODER_TABLE, cfg.DECODER_DEVICE)


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def _plan_streams(n_symbols: int, conf: cfg.GlzConfig) -> int:
    """Pick symbols-per-stream: honor conf.stream_symbols but cap stream
    count (size budget) and guarantee at least one stream."""
    if n_symbols == 0:
        return conf.stream_symbols
    s = conf.stream_symbols
    n_streams = -(-n_symbols // s)
    if n_streams > conf.max_streams:
        s = -(-n_symbols // conf.max_streams)
    return s


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


def compress(data: bytes, mode: int = cfg.MODE_BYTE, backend: str = "host",
             conf: cfg.GlzConfig = cfg.DEFAULT, device=None) -> bytes:
    """Compress `data` into a .glz container, as glz_tpu.compress does with
    the same arguments: a lockstep conf writes the lockstep layout whatever
    the backend; otherwise byte mode writes compress_bytes_host's container
    (backend "host") or compress_bytes_device's ("device"), and HuffWord
    mode a bitstream container ("host") or a lockstep one ("device").

    device: None runs on the card; 'cpu' runs the kernels' plain versions."""
    check_backend(backend)
    if mode == cfg.MODE_HUFFWORD:
        from glz_tpu_torch.models.huffword import compress_huffword
        return compress_huffword(data, conf, backend=backend, device=device)
    if mode != cfg.MODE_BYTE:
        if mode in _LATER_MODES:
            raise NotImplementedError(f"mode {mode} comes with {_LATER_MODES[mode]}")
        raise ValueError(f"unsupported mode {mode}")
    from glz_tpu_torch.models import canonical_byte as cb_model
    if conf.layout == cfg.LAYOUT_LOCKSTEP:
        return cb_model.compress_bytes_lockstep(data, conf, device=device)
    if backend == "device":
        return cb_model.compress_bytes_device(data, conf, device=device)
    return cb_model.compress_bytes_host(data, conf, device=device)


def decompress(blob: bytes, backend: str = "host", variant: str = cfg.DECODER_TABLE,
               device=None) -> bytes:
    """Decompress a .glz container (mode and layout are self-describing).
    Every backend and decoder variant decodes on the card (device=None)
    with the same output bytes; they are taken for glz_tpu's signature."""
    from glz_tpu_torch.models.canonical_byte import decompress_bytes_device, resolve_device
    from glz_tpu_torch.models.huffword import decompress_huffword

    check_backend(backend)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    resolve_device(device)
    f = container.read_container(blob)
    if f.mode == cfg.MODE_HUFFWORD:
        return decompress_huffword(blob, device=device)
    if f.mode == cfg.MODE_BYTE:
        return decompress_bytes_device(blob, device=device)
    if f.mode in _LATER_MODES:
        raise NotImplementedError(
            f"container mode {f.mode} comes with {_LATER_MODES[f.mode]}")
    raise ValueError(f"unsupported container mode {f.mode}")
