"""glz_tpu_torch: the canonical-Huffman codec of glz_tpu on PyTorch and CUDA.

A port of the JAX package `glz_tpu` to one NVIDIA Hopper card.  It keeps its
own copies of the host code and imports nothing of `glz_tpu`.  For the same
input and configuration it writes byte-identical .glz containers, and each
package decodes the other's.

The port carries byte mode and HuffWord mode (word and non-word
dictionaries) in both payload layouts: lockstep (the THROUGHPUT preset) and
bitstream (DEFAULT, RATIO), the normal-tree mode (host code, as in
glz_tpu), the multi-file batch and the .glzb archive.  Lane totals, the reverse-sweep encode, the
lockstep decodes and the vocabulary gather (csrc/lockstep.cu), and the byte
lookup, the bit pack and the stream decodes (csrc/bitstream.cu) run as
hand-written CUDA kernels.  The entry points take glz_tpu's arguments and
defaults, so the same call writes the same file; they run on the card
unless the caller passes device='cpu', which runs the kernels' plain
PyTorch versions.

Public API:
    compress(data, mode=MODE_BYTE, backend="host", conf=DEFAULT, device=None)
                                                 -> bytes (.glz container)
    decompress(blob, backend="host", variant=DECODER_TABLE, device=None)
                                                 -> bytes
    compress_batch(datas, mode=MODE_BYTE, backend="host", conf=DEFAULT,
                   pipeline=True, shared_codebook=False, device=None)
                                                 -> list[bytes]
    decompress_batch(blobs, backend="host", pipeline=True, device=None)
                                                 -> list[bytes]
    compress_archive(datas, mode=MODE_BYTE, backend="host", conf=DEFAULT,
                     device=None)                -> bytes (.glzb archive)
    decompress_archive(blob, backend="host", device=None)
                                                 -> list[bytes]
    compress_huffword_shared(datas, conf=DEFAULT, backend="host",
                             pipeline=True, device=None)
                                                 -> list[bytes] (one shared
                                                    dual codebook)
    codebook_from_lengths(lengths)               -> Codebook
"""

__version__ = "0.1.0"

from glz_tpu_torch import config  # noqa: F401
from glz_tpu_torch.config import GlzConfig  # noqa: F401
from glz_tpu_torch.core.api import (compress, decompress,  # noqa: F401
                                    compress_batch, decompress_batch,
                                    compress_archive, decompress_archive,
                                    compress_huffword_shared)
from glz_tpu_torch.core.codebook import codebook_from_lengths  # noqa: F401
