"""The codec on a device mesh: one process per card, each holding its shard.

A port of glz_tpu/parallel/mesh.py on torch.distributed.  glz_tpu
shard_maps its steps over a jax.sharding.Mesh that one process drives;
here every rank of the process group already initialised
(multihost.initialize, or torch.distributed.init_process_group) is one
device of a DeviceMesh, runs the step on its own shard and joins the
collectives (NCCL between cards, gloo for CPU tensors).  A rank's flat
device index is its row-major position in the mesh, which is its rank, as
glz_tpu's _flat_device_index.

  * sharded_histogram: the histogram kernel on the local shard, then a sum
    over the mesh;
  * sharded_encode: each rank encodes its shard as one bitstream dispatch
    (K7 + the pack) from bit 0; its words, total bits and stream bits are
    its own (glz_tpu returns them sharded);
  * lockstep_codec_step: lane totals, the reverse-sweep encode into a
    fixed-stride payload, the gather of every group's word count, and the
    lockstep decode of the same groups;
  * codec_step: sharded_encode, then each rank decodes its own shard.

Every rank passes a shard of the same size (one collective checks it);
`n_valid` is the valid symbol count of the whole input.  Collectives run on
the tensors' own device.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from glz_tpu_torch.core.lockstep import LANES
from glz_tpu_torch.models.transfer import resolve_device
from glz_tpu_torch.ops.decode import decode_streams
from glz_tpu_torch.ops.encode import encode_block_fast
from glz_tpu_torch.ops.histogram import histogram
from glz_tpu_torch.ops.lockstep_decode import decode_groups
from glz_tpu_torch.ops.lockstep_encode import encode_groups, lane_totals


def make_mesh(n_devices: int | None = None, axis_names=("data",), shape=None,
              device=None) -> DeviceMesh:
    """A 1- or 2-axis DeviceMesh over every rank of the process group (one
    rank per device; n_devices must be the world size), on the card unless
    device='cpu'."""
    world = dist.get_world_size()
    n_devices = world if n_devices is None else n_devices
    shape = tuple(shape or (n_devices,))
    if n_devices != world or math.prod(shape) != n_devices or len(shape) != len(axis_names):
        raise ValueError(f"a mesh of shape {shape} over axes {tuple(axis_names)} needs "
                         f"{n_devices} ranks, one per device; the process group has {world}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=tuple(axis_names))


def _flat_device_index(mesh: DeviceMesh) -> int:
    """This rank's row-major index over a 1- or 2-axis mesh."""
    idx = 0
    for c, size in zip(mesh.get_coordinate(), mesh.shape):
        idx = idx * size + c
    return idx


def _gather_mesh(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """The concatenation of every rank's `t` in flat device order."""
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("the mesh must hold every rank of the process group in rank order")
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def _shard_base(mesh: DeviceMesh, local: torch.Tensor) -> int:
    """The first symbol of this rank's shard, after checking that every rank
    holds a shard of the same size (every rank raises alike)."""
    n = local.numel()
    sizes = _gather_mesh(mesh, torch.tensor([n], dtype=torch.int64,
                                            device=local.device)).tolist()
    if min(sizes) != max(sizes):
        raise ValueError(f"every rank must hold a shard of the same size, got {sizes}")
    return _flat_device_index(mesh) * n


def sharded_histogram(mesh: DeviceMesh, local: torch.Tensor) -> torch.Tensor:
    """The byte histogram of the whole input (int64 [256], on every rank):
    the histogram kernel on this rank's u8 shard, summed over each mesh
    axis."""
    h = histogram(local)
    for dim in range(mesh.ndim):
        dist.all_reduce(h, group=mesh.get_group(dim))
    return h


def sharded_encode(mesh: DeviceMesh, local: torch.Tensor, n_valid: int,
                   lj_tbl: torch.Tensor, len_tbl: torch.Tensor, stream_symbols: int):
    """Encode this rank's shard (u8, a whole number of streams; symbols of
    the whole input at or past n_valid code nothing) as one bit stream from
    bit 0.  lj_tbl[b] = code[b] << (32 - len[b]), len_tbl[b] = len[b] (int32
    [256]).  Returns (words int32 [ceil(total_bits / 32)], total_bits,
    stream_bits int64 [shard / stream_symbols]) of this rank; the shards
    are word-aligned, so a file's payload is their words in rank order."""
    if local.numel() % stream_symbols:
        raise ValueError(f"each shard must hold whole streams of {stream_symbols} symbols, "
                         f"got {local.numel()}")
    base = _shard_base(mesh, local)
    local_valid = min(max(n_valid - base, 0), local.numel())
    return encode_block_fast(local, local_valid, lj_tbl, len_tbl, stream_symbols)


def lockstep_codec_step(mesh: DeviceMesh, local: torch.Tensor, n_valid: int,
                        entry_tbl: torch.Tensor, fc_lj: torch.Tensor,
                        offsets: torch.Tensor, symtab: torch.Tensor, S: int,
                        min_len: int, max_len: int, rows: int = 8,
                        max_bits_per_symbol: int | None = None):
    """The lockstep kernels on the mesh: groups (rows*128 streams x S
    symbols) are the shard unit, the codebook tables are every rank's, and
    the group word counts are gathered so every rank holds the container's
    group table in file order.

    Per rank: lane totals (K1), the reverse-sweep encode (K2) into a payload
    of a fixed stride a group (every symbol at max_len bits, or at
    max_bits_per_symbol where the caller knows a tighter bound, plus the
    decoder's slack), then the lockstep decode (K3) of the same groups.
    Returns (payload int32 [local_groups * stride_rows * 128], gw_all int32
    [n_groups], out u8): group g of this rank holds its gw_all word count
    at payload[g * stride_rows * 128:], and out is the shard's decoded
    valid symbols.  A max_bits_per_symbol that some group's words exceed
    raises ValueError ("too tight") on every rank before the encode."""
    G = rows * LANES
    group_syms = G * S
    n = local.numel()
    if n == 0 or n % group_syms:
        raise ValueError("pad input to a whole number of groups per device")
    base = _shard_base(mesh, local)
    local_groups = n // group_syms
    local_valid = min(max(n_valid - base, 0), n)
    bps = max_bits_per_symbol if max_bits_per_symbol is not None else max_len
    if bps < 1:
        raise ValueError(f"max_bits_per_symbol must be >= 1, got {bps}")
    stride_rows = -(-(group_syms * bps // 32 + 2 * G) // LANES) + 2 * rows

    ctot, gw = lane_totals(local, entry_tbl, local_valid, S, rows)
    gw_all = _gather_mesh(mesh, gw)
    if max_bits_per_symbol is not None:
        worst = int(gw_all.max())
        # glz_tpu's decoder reads a (rows+1)-row window, so its safe band
        # ends rows+1 rows short of the stride; the same bound holds here
        if worst > (stride_rows - rows - 1) * LANES:
            raise ValueError(
                f"max_bits_per_symbol={max_bits_per_symbol} too tight: a "
                f"group produced {worst} payload words > safe bound "
                f"{(stride_rows - rows - 1) * LANES} (stride {stride_rows * LANES} "
                "minus the decoder's window slack); raise the bound")
    g = torch.arange(local_groups, dtype=torch.int32, device=local.device)
    grow = g * stride_rows
    payload, _ = encode_groups(local, entry_tbl, local_valid, ctot, gw, grow, S, rows,
                               local_groups * stride_rows * LANES)
    counts = (local_valid - g.long() * group_syms).clamp(0, group_syms).to(torch.int32)
    out = decode_groups(payload, grow.long() * LANES, counts, fc_lj, offsets, symtab, S,
                        min_len, max_len, rows)
    return payload, gw_all, out[:local_valid]


def codec_step(mesh: DeviceMesh, local: torch.Tensor, n_valid: int, lj_tbl: torch.Tensor,
               len_tbl: torch.Tensor, fc_lj: torch.Tensor, offsets: torch.Tensor,
               symtab: torch.Tensor, min_len: int, max_len: int, stream_symbols: int):
    """One sharded codec step: sharded_encode, then each rank decodes its
    own shard from its words, the streams starting at the exclusive cumsum
    of its stream bits (decode_streams: the decode tables fc_lj, offsets,
    symtab and the code length range).  Returns (words, total_bits,
    stream_bits, out): sharded_encode's and the shard's decoded valid
    symbols (u8)."""
    words, total_bits, stream_bits = sharded_encode(mesh, local, n_valid, lj_tbl, len_tbl,
                                                    stream_symbols)
    local_valid = min(max(n_valid - _flat_device_index(mesh) * local.numel(), 0),
                      local.numel())
    starts = torch.cumsum(stream_bits, 0) - stream_bits
    out = decode_streams(words, starts, local_valid, stream_symbols, fc_lj, offsets, symtab,
                         min_len, max_len)
    return words, total_bits, stream_bits, out
