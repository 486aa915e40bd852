"""The byte histogram: u8 [n] -> int64 [256], exact.

Counterpart of glz_tpu/ops/histogram.py, whose histogram_scatter (an XLA
scatter-add) and histogram_matmul (one-hot matmuls for the TPU's MXU,
over inputs padded to 2^19-byte chunks) become one kernel
(csrc/histogram.cu) that takes any length.  Its only caller is
parallel/mesh.sharded_histogram: the single-card models count bytes on the
host, where the data already is (core/codebook.histogram_bytes).

histogram_ref is the plain version (a scatter-add, histogram_scatter's
counterpart); the wrapper runs it for a CPU tensor and launches the kernel
for a CUDA tensor.
"""

from __future__ import annotations

import torch

from glz_tpu_torch.ops import _kernels

N_BINS = 256
# Bytes the plain version turns into int64 indices at once.
_REF_CHUNK = 1 << 26


def _check(data: torch.Tensor) -> None:
    _kernels.check(data, "data", torch.uint8, (data.numel(),), data.device)


def histogram_ref(data: torch.Tensor) -> torch.Tensor:
    """Plain version: int64 [256] counts of each byte value of u8 `data`
    (CPU or CUDA), by index_add_ over chunks of the input."""
    _check(data)
    out = torch.zeros(N_BINS, dtype=torch.int64, device=data.device)
    for lo in range(0, data.numel(), _REF_CHUNK):
        idx = data[lo : lo + _REF_CHUNK].long()
        out.index_add_(0, idx, torch.ones_like(idx))
    return out


def histogram(data: torch.Tensor) -> torch.Tensor:
    """The byte histogram (replaces glz_tpu/ops/histogram.py:histogram).
    See histogram_ref for the function; CUDA tensors launch the kernel.
    data: u8, one dimension, any length and alignment."""
    _check(data)
    if _kernels.runs_plain(data):
        return histogram_ref(data)
    out = torch.zeros(N_BINS, dtype=torch.int64, device=data.device)
    if data.numel():
        _kernels.launch("glz_histogram", "histogram", _kernels.ptr(data), data.numel(),
                        _kernels.ptr(out))
    return out
