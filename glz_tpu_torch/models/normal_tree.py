"""Normal (explicit-tree) Huffman codec: the reference codec's legacy model.

A copy of glz_tpu/models/normal_tree.py.  The .crs bytes
(compat/glzip_format.py) ride inside a mode-2 .glz container, with crc32
when conf.checksum, so decompress() routes on the self-describing header.
Tree-walk decode is strictly serial and the canonical models subsume it:
the mode is host code in glz_tpu too, with no kernel, and it stays host
code here.  `device` is only validated, as every entry point's is.
"""

from __future__ import annotations

import numpy as np

from glz_tpu_torch import config as cfg
from glz_tpu_torch.compat import glzip_format
from glz_tpu_torch.core import container
from glz_tpu_torch.models.transfer import resolve_device


def compress_normal_tree(data: bytes, conf: cfg.GlzConfig = cfg.DEFAULT,
                         device=None) -> bytes:
    resolve_device(device)
    crs = glzip_format.write_crs(data)
    f = container.GlzFile(
        mode=cfg.MODE_NORMAL_TREE,
        n_symbols=len(data),
        stream_symbols=0,
        stream_bits=np.zeros(0, np.uint64),
        codebook_blob=b"",  # the .crs payload carries its own serialized tree
        payload=crs,
        checksum=container.checksum_of(data, conf),
    )
    return container.write_container(f)


def decompress_normal_tree(f: container.GlzFile, device=None) -> bytes:
    """Decode a parsed normal-tree container."""
    resolve_device(device)
    return container.verify(glzip_format.read_crs(f.payload), f)
