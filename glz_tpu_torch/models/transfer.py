"""Every copy between the host and the card, for the models.

The copies are the lever of this codec's speed: histogram, codebook and
container are host work of microseconds, the kernels take milliseconds,
and the input, the payload and the output cross between host and card once
a call each.  So they live here, in one module, and nothing else under
models/ or parallel/ defines one.

Each helper is a span of utils/timer.py (`pad`, `h2d`, `d2h`, `serialize`)
or runs inside its caller's, and counts the bytes it writes on the host as
`host_copy_bytes`.  On the card each byte is copied on the host at most
once a call: a compress sends the caller's bytes unpadded into a device
buffer whose tail is zeroed there (symbols_on), and the D2H'd payload words
are joined into the container as they are (words_buffer: the container's
join is their one copy); a decompress sends the payload's bytes from the
blob as they lie (payload_words_on) and copies only the output into the
bytes it returns (host_bytes).  With device='cpu' the copies into the
device buffers are host copies too, and are counted.

Every payload-sized copy from the card (the payload words, the decoded
output, HuffWord's token ids) goes through host_array: it lands in
page-locked memory that PyTorch's caching host allocator hands back call
after call, so it runs at the DMA's rate instead of faulting in a fresh
pageable tensor, and counts `d2h_bytes` and `d2h_pinned_bytes`.  Callers
reach it as `transfer.host_array`, so that one patch of this module's
attribute sees every such copy.  The small copies (stream bit counts, group
counts) stay plain `.cpu()` copies.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from glz_tpu_torch.core import bitio
from glz_tpu_torch.utils import timer


def resolve_device(device) -> torch.device:
    """None means the card.  Raises when no card is present: the CPU runs
    only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def i32_tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """u32 values -> int32 bit-pattern tensor on `dev`."""
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32).view(np.int32)).to(dev)


def symbols_on(chunk: np.ndarray, padded: int, dev: torch.device) -> torch.Tensor:
    """A u8 chunk on `dev`, zero-padded to `padded` symbols, with no host
    copy on the way (read-only input buffers are only read): the tail's
    zeros on `dev` (`pad`), then the chunk's copy straight from the caller's
    buffer into the rest (`h2d`; on the CPU a host copy, counted)."""
    with timer.span("pad"):
        out = torch.empty(padded, dtype=torch.uint8, device=dev)
        out[chunk.size :].zero_()
    with timer.span("h2d"), warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        out[: chunk.size].copy_(torch.from_numpy(chunk))
        if dev.type == "cpu":
            timer.count(timer.HOST_COPY_BYTES, chunk.size)
    return out


def ids_on(ids: np.ndarray, T: int, padded: int, small: bool,
           dev: torch.device) -> torch.Tensor:
    """Token ids as u16 (`small`) or u32 bit patterns on `dev`, zero-padded
    to `padded`: the padded host copy (`pad`), then the copy to `dev`
    (`h2d`)."""
    with timer.span("pad"):
        ids_pad = np.zeros(padded, np.uint16 if small else np.uint32)
        ids_pad[:T] = ids.astype(ids_pad.dtype)
        timer.count(timer.HOST_COPY_BYTES, 2 * T * ids_pad.itemsize)
    with timer.span("h2d"):
        return torch.from_numpy(ids_pad.view(np.int16 if small else np.int32)).to(dev)


def payload_words_on(payload, dev: torch.device) -> torch.Tensor:
    """A payload's little-endian u32 words (a container's '<u4' payload, or
    bitstream_words' array) as an int32 bit-pattern tensor on `dev`: the
    bytes sent as they lie, with no host copy on the way to the card, then
    viewed as int32 on the device's allocation, which is aligned wherever
    they lay in the blob (`h2d`; on the CPU a host copy, counted)."""
    raw = np.frombuffer(payload, dtype=np.uint8)
    raw = raw[: raw.size // 4 * 4]
    with timer.span("h2d"), warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        out = torch.from_numpy(raw).to(dev, copy=True)
        if dev.type == "cpu":
            timer.count(timer.HOST_COPY_BYTES, raw.size)
    return out.view(torch.int32)


def bitstream_words(payload: bytes) -> np.ndarray:
    """A bitstream payload's big-endian u32 words (bitio.bytes_to_words, a
    host copy, which it counts: `serialize`)."""
    with timer.span("serialize"):
        return bitio.bytes_to_words(payload)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A payload-sized tensor on the host, as a numpy array.  From the card
    it lands in a page-locked block of PyTorch's caching host allocator,
    which hands a freed block out again for a later request of its size
    class, so calls in a steady state allocate none (a fresh pageable
    tensor of that size is mapped anew each call, and the copy faults in
    its pages).  The block is released once the array and its views are
    dropped: callers read it once and return nothing that aliases it.
    Counts `d2h_bytes` and, through page-locked memory, `d2h_pinned_bytes`;
    when none can be allocated, the pageable `.cpu()`.  A tensor on the CPU
    comes back as `.cpu()` gives it: its own storage, nothing counted."""
    if t.device.type == "cpu":
        return t.numpy()
    nbytes = t.numel() * t.element_size()
    timer.count(timer.D2H_BYTES, nbytes)
    try:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    except RuntimeError:  # page-locked memory exhausted
        return t.cpu().numpy()
    host.copy_(t)
    timer.count(timer.D2H_PINNED_BYTES, nbytes)
    return host.numpy()


def host_bytes(out: torch.Tensor) -> bytes:
    """A decoded u8 tensor as bytes: the copy to the host (`d2h`, which
    waits for the kernels ahead of it; from the card into a page-locked
    block, host_array), then into a bytes object (`serialize`), the call's
    one host copy of the output, after which the block is released."""
    with timer.span("d2h"):
        host = host_array(out)
    with timer.span("serialize"):
        data = host.tobytes()
        timer.count(timer.HOST_COPY_BYTES, len(data))
    return data


def words_buffer(words: np.ndarray) -> memoryview:
    """D2H'd payload words as the '<u4' bytes a container stores: a view of
    the words on a little-endian host, so that write_container's join is
    their one host copy."""
    return memoryview(np.ascontiguousarray(words).view(np.uint32).astype("<u4", copy=False)
                      ).cast("B")
