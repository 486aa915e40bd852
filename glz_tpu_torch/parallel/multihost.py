"""Multi-process orchestration: several processes compress or decompress
one file, each its own contiguous shard, and process 0 stitches the
file-order container.  A port of glz_tpu/parallel/multihost.py, function
for function, on torch.distributed: the same containers byte for byte and
the same errors.

Every process runs the same program after `initialize` (one process group,
gloo for host tensors; NCCL also joins for CUDA tensors where there is a
card).  The collectives here carry host arrays over gloo, so several
processes may share one card (NCCL refuses two ranks on one device).  The
gather recipe is glz_tpu's: sizes first, then payloads padded to the
largest and trimmed.  gloo carries int64 exactly; arrays of other types
travel as their bytes.

Paths (selected by conf.layout / the entry point):
  * compress_bytes_multihost, bitstream layout: each process writes its
    shard with the host encoder's container (models/canonical_byte.
    compress_bytes_host) under one codebook from the summed histograms;
    process 0 stitches the stream tables;
  * compress_bytes_multihost, lockstep layout: each process runs the
    lockstep encode (compress_bytes_lockstep) with that codebook; group
    segments are self-contained, so the stitch is a concatenation of group
    tables and payloads;
  * compress_huffword_multihost: per-process tokenize and vocabularies, the
    vocabulary union through a gather of per-class token blobs, shared dual
    codebooks, per-process lockstep token encode, group-table stitch.

Containers honour conf.checksum: each process crc32s its shard and process
0 combines them (utils/crc.crc32_concat) without seeing the bytes.

Every shard check gathers first, so every process raises the same error
and none is left waiting in a collective.  The kernels run on the card of
each process unless the caller passes device='cpu'.
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist

from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import container, lockstep
from glz_tpu_torch.core.api import compress
from glz_tpu_torch.core.codebook import build_codebook, histogram_bytes
from glz_tpu_torch.core.lockstep import LANES
from glz_tpu_torch.models.canonical_byte import (compress_bytes_host, compress_bytes_lockstep,
                                                 decompress_bytes_lockstep)
from glz_tpu_torch.models.huffword import (decompress_huffword, encode_lockstep_tokens,
                                           huffword_cb_blob)
from glz_tpu_torch.parallel import mesh as pmesh
from glz_tpu_torch.utils import crc
from glz_tpu_torch.utils import tokenizer as tok

# Seconds any collective may wait for the other processes (and the set-up
# for all of them to join) before it raises.
DEFAULT_TIMEOUT = 600.0


def init_group(address: str, world_size: int, rank: int,
               timeout: float = DEFAULT_TIMEOUT) -> None:
    """Join the process group at `address` ("host:port" or a URL): gloo, and
    NCCL for CUDA tensors where a card is present; every collective raises
    after `timeout` seconds."""
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=address if "://" in address else
                            f"tcp://{address}", world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, timeout: float = DEFAULT_TIMEOUT) -> None:
    """init_group for several processes (a no-op for one)."""
    if num_processes is None or num_processes <= 1:
        return
    init_group(coordinator_address, num_processes, process_id, timeout)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(axis_name: str = "data", device=None):
    return pmesh.make_mesh(process_count(), axis_names=(axis_name,), device=device)


def _allgather(vec) -> np.ndarray:
    """Gather a small non-negative int vector from every process ->
    [nproc, k] int64, exactly (gloo carries int64)."""
    v = np.array(vec, np.int64).reshape(-1)
    if v.size and int(v.min()) < 0:
        raise ValueError(f"_allgather expects non-negative sizes, got {v}")
    if process_count() == 1:
        return v[None].copy()
    t = torch.from_numpy(v)
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.stack(parts).numpy()


def _gather_ragged(arr: np.ndarray) -> list[np.ndarray]:
    """Ragged per-process arrays -> list of nproc trimmed arrays (sizes
    first, then a padded gather of their bytes)."""
    arr = np.ascontiguousarray(arr)
    send = arr.reshape(-1).view(np.uint8)
    sizes = _allgather([send.size])[:, 0]
    if sizes.size == 1:
        return [arr.copy()]
    pad = torch.zeros(int(sizes.max()), dtype=torch.uint8)
    pad.numpy()[: send.size] = send
    parts = [torch.empty_like(pad) for _ in range(sizes.size)]
    dist.all_gather(parts, pad)
    return [p[: int(n)].numpy().view(arr.dtype) for p, n in zip(parts, sizes)]


def compress_bytes_multihost(local_data: bytes, conf=None, stream_symbols: int = 1 << 18,
                             device=None):
    """Each process compresses its shard with a shared codebook; process 0
    returns the stitched container, the others None.  conf.layout selects
    the bitstream (host encoder's container) or lockstep path; one process
    returns compress(local_data, conf=conf)."""
    conf = conf or cfg.GlzConfig(stream_symbols=stream_symbols)
    if process_count() == 1:
        return compress(local_data, conf=conf, device=device)
    if conf.layout == cfg.LAYOUT_LOCKSTEP:
        return _compress_bytes_lockstep_multihost(local_data, conf, device)
    return _compress_bytes_bitstream_multihost(local_data, conf, device)


def _stitched_checksum(local_data: bytes, conf) -> int | None:
    """Whole-file crc32 from per-shard crc32s (every process computes and
    gathers; process 0 uses the combined value); None when conf.checksum
    is off."""
    local = container.checksum_of(local_data, conf)
    if local is None:
        return None
    meta = _allgather([local & 0xFFFFFFFF, len(local_data)])
    return crc.crc32_concat(meta[:, 0], meta[:, 1])


def _shared_byte_codebook(local_data: bytes, limit):
    """The sum of every process's exact histogram, and the same codebook
    built from it everywhere."""
    local_hist = histogram_bytes(np.frombuffer(local_data, np.uint8))
    global_hist = _allgather(local_hist).sum(axis=0)
    return build_codebook(global_hist.astype(np.int64), limit)


def _validate_shards(n_local: int, align: int, what: str) -> None:
    """Gather every shard's size first, so every process raises the SAME
    error and none is left blocked in the next collective."""
    meta = _allgather([n_local, n_local % align])
    empty = np.flatnonzero(meta[:, 0] == 0)
    if empty.size:
        raise ValueError(
            f"host {int(empty[0])} got an empty shard; every process must "
            f"hold at least one {what} ({align} symbols) — an empty shard "
            "would insert a phantom zero-length unit into the stitched "
            "table and desynchronize every later shard")
    mis = np.flatnonzero(meta[:-1, 1] != 0)
    if mis.size:
        bad = int(mis[0])
        raise ValueError(
            f"shard of {int(meta[bad, 0])} bytes on host {bad} is not a "
            f"multiple of the {what} ({align}); align shard boundaries "
            f"(only the last host may hold a partial {what.split()[0]})")


def _compress_bytes_bitstream_multihost(local_data: bytes, conf, device):
    # the stitched container records one stream_symbols and maps stream k to
    # symbols [k*S, (k+1)*S): a non-last shard that is not a multiple of S
    # would desynchronize every later shard
    _validate_shards(len(local_data), conf.stream_symbols,
                     f"stream (stream_symbols={conf.stream_symbols})")
    cb = _shared_byte_codebook(local_data, conf.length_limit)
    checksum = _stitched_checksum(local_data, conf)
    # the shard containers are intermediates: no per-shard crc
    local_blob = compress_bytes_host(local_data, dataclasses.replace(conf, checksum=False),
                                     codebook=cb, device=device)

    f = container.read_container(local_blob)
    meta = _allgather([f.n_symbols])
    payloads = _gather_ragged(np.frombuffer(f.payload, np.uint8))
    tables = _gather_ragged(f.stream_bits.astype(np.int64))

    if process_index() != 0:
        return None
    parts = []
    bits_tables = []
    n_total = 0
    for p in range(process_count()):
        body = payloads[p]
        tbl = tables[p].astype(np.uint64)
        # inflate the shard's last stream advance to the byte-aligned size
        tbl[-1] += body.size * 8 - int(tbl.sum())
        parts.append(body.tobytes())
        bits_tables.append(tbl)
        n_total += int(meta[p, 0])
    g = container.GlzFile(
        mode=f.mode,
        n_symbols=n_total,
        stream_symbols=f.stream_symbols,
        stream_bits=np.concatenate(bits_tables),
        codebook_blob=f.codebook_blob,  # the same on every process (shared code)
        payload=b"".join(parts),
        checksum=checksum,
    )
    return container.write_container(g)


def _compress_bytes_lockstep_multihost(local_data: bytes, conf, device):
    """Group segments are self-contained runs of consumption-ordered words
    whose lengths the group table records, so process 0's stitch is a
    concatenation."""
    S = lockstep.stream_symbols(conf)
    group_syms = conf.group_rows * LANES * S
    # group g covers symbols [g*G*S, (g+1)*G*S) of the FILE, so every
    # non-last shard must hold whole groups
    _validate_shards(len(local_data), group_syms,
                     f"lockstep group (group_rows*128*stream_symbols="
                     f"{group_syms} bytes)")

    cb = _shared_byte_codebook(local_data, lockstep.fused_length_limit(conf))
    checksum = _stitched_checksum(local_data, conf)
    local_blob = compress_bytes_lockstep(local_data, dataclasses.replace(conf, checksum=False),
                                         codebook=cb, device=device)

    f = container.read_container(local_blob)
    meta = _allgather([f.n_symbols])
    words = _gather_ragged(np.frombuffer(f.payload, "<u4").astype(np.uint32))
    tables = _gather_ragged(f.stream_bits.astype(np.int64))

    if process_index() != 0:
        return None
    g = container.GlzFile(
        mode=f.mode,
        n_symbols=int(meta[:, 0].sum()),
        stream_symbols=S,
        stream_bits=np.concatenate(tables).astype(np.uint64),
        codebook_blob=f.codebook_blob,
        payload=np.concatenate(words).astype("<u4").tobytes(),
        layout=container.LAYOUT_LOCKSTEP,
        group_rows=f.group_rows,
        checksum=checksum,
    )
    return container.write_container(g)


def _group_range(f) -> tuple[int, int, int, int]:
    """(first group, end group, first symbol, symbol count) of this
    process's contiguous share of a lockstep container's groups."""
    nproc, pid = process_count(), process_index()
    gs = f.group_rows * LANES * f.stream_symbols
    g0 = f.n_streams * pid // nproc
    g1 = f.n_streams * (pid + 1) // nproc
    return g0, g1, g0 * gs, max(0, min(f.n_symbols, g1 * gs) - g0 * gs)


def _sub_file(f, g0: int, g1: int, n_local: int) -> container.GlzFile:
    """Groups [g0, g1) of lockstep container f as a GlzFile of their own
    (their segments are self-contained), its payload a view of f's.  It
    keeps f's codebook (HuffWord: word_first is token 0's class, and groups
    start at even tokens) and no checksum, which covers the whole file."""
    gw = f.stream_bits.astype(np.int64)
    lo_w = int(gw[:g0].sum())
    hi_w = lo_w + int(gw[g0:g1].sum())
    return dataclasses.replace(f, n_symbols=n_local, stream_bits=f.stream_bits[g0:g1],
                               payload=f.payload[4 * lo_w : 4 * hi_w], checksum=None)


def decompress_bytes_multihost(blob: bytes, device=None):
    """Shard-parallel decode of a lockstep byte container: process k decodes
    its contiguous range of groups and returns (local_bytes, byte_offset);
    callers write each slice at its offset.  Bitstream containers have no
    byte-aligned shard points: decode those in one process
    (glz_tpu_torch.decompress).  The container's crc32 covers the whole
    file, which no process holds: check it over the assembled output."""
    f = container.read_container(blob)
    if f.mode != cfg.MODE_BYTE or f.layout != container.LAYOUT_LOCKSTEP:
        raise ValueError(
            "multihost decompress supports lockstep byte containers; "
            "decode other containers in one process via glz_tpu_torch.decompress")
    g0, g1, byte0, n_local = _group_range(f)
    if n_local == 0:
        return b"", byte0
    return decompress_bytes_lockstep(_sub_file(f, g0, g1, n_local), device=device), byte0


def decompress_huffword_multihost(blob: bytes, device=None):
    """Shard-parallel decode of a lockstep HuffWord container: process k
    decodes its contiguous group range (group boundaries sit at even token
    indices, so token parity holds) and detokenizes it; byte offsets come
    from one gather of the output sizes.  Returns (local_bytes,
    byte_offset)."""
    f = container.read_container(blob)
    if f.mode != cfg.MODE_HUFFWORD or f.layout != container.LAYOUT_LOCKSTEP:
        raise ValueError(
            "multihost decompress supports lockstep huffword containers; "
            "decode other containers in one process via glz_tpu_torch.decompress")
    g0, g1, _, n_local = _group_range(f)
    local = (decompress_huffword(_sub_file(f, g0, g1, n_local), device=device)
             if n_local else b"")
    sizes = _allgather([len(local)])[:, 0]
    return local, int(sizes[: process_index()].sum())


# ---- HuffWord -------------------------------------------------------------------

def huffword_multihost_rows(conf) -> int:
    """Group rows of the HuffWord multi-process path: conf.group_rows capped,
    with a warning, by the dual decode's non-pack2 bound (known before the
    vocabulary union)."""
    return lockstep.capped_rows(conf.group_rows, lockstep.huffword_stream_tokens(conf),
                                pack2=False)


def split_huffword_shards(data: bytes, nproc: int, conf=None) -> list[int]:
    """Byte offsets [0, ..., len(data)] of nproc shards that satisfy
    compress_huffword_multihost's alignment contract: every cut sits at a
    global token boundary whose index is a multiple of rows*128*S and whose
    first byte re-tokenizes context-freely (not a glue character followed
    by an alnum).  S and rows come from `conf` as compress_huffword_multihost
    derives them.  For a program that holds the whole file; each process
    then tokenizes only its shard."""
    from glz_tpu_torch.utils import native

    conf = conf or cfg.GlzConfig()
    S = lockstep.huffword_stream_tokens(conf)
    rows = huffword_multihost_rows(conf)

    arr = np.frombuffer(data, np.uint8)
    starts = native.tokenize(arr)[0][:-1] if arr.size else np.zeros(0, np.int64)
    T = starts.size
    group_syms = rows * LANES * S
    glue = frozenset(b"'-_")

    def clean(t: int) -> bool:
        p = int(starts[t])
        if data[p] in glue and p + 1 < len(data) and tok._ALNUM[data[p + 1]]:
            return False
        return True

    bounds = [0]
    prev_t = 0
    for k in range(1, nproc):
        t = T * k // nproc // group_syms * group_syms
        while t > prev_t and not clean(t):
            t -= group_syms
        if t <= prev_t:
            raise ValueError(
                f"cannot split {len(data)} bytes ({T} tokens) into {nproc} "
                f"group-aligned huffword shards at group size {group_syms}; "
                "use fewer hosts or a smaller stream_symbols")
        bounds.append(int(starts[t]))
        prev_t = t
    bounds.append(len(data))
    return bounds


def compress_huffword_multihost(local_data: bytes, conf=None, device=None):
    """HuffWord lockstep across processes: per-process tokenize and
    vocabularies, the vocabulary union, shared dual codebooks, per-process
    lockstep token encode, process 0's group-table stitch (process 0 returns
    the container, the others None; one process returns compress(...,
    mode=MODE_HUFFWORD, backend="device")).

    Alignment contract (checked after a gather; every process raises):
    every non-last shard's token count is a multiple of the group token
    count (huffword_multihost_rows(conf) * 128 * S), and every shard's first
    token class is shard 0's.  split_huffword_shards plans such offsets."""
    conf = conf or cfg.GlzConfig()
    if process_count() == 1:
        return compress(local_data, mode=cfg.MODE_HUFFWORD, backend="device", conf=conf,
                        device=device)

    S = lockstep.huffword_stream_tokens(conf)
    rows = huffword_multihost_rows(conf)
    group_syms = rows * LANES * S
    starts, lengths, word_first, wv, nv, ids = tok.build_vocabs(local_data)
    T = ids.size

    pid, nproc = process_index(), process_count()
    meta = _allgather([T, T % group_syms, 1 if word_first else 0])
    empty = np.flatnonzero(meta[:, 0] == 0)
    if empty.size:
        raise ValueError(
            f"host {int(empty[0])} got an empty shard; every process must "
            f"hold at least one huffword lockstep group ({group_syms} "
            f"tokens at stream_symbols={S})")
    if int((meta[:-1, 1] != 0).sum()):
        bad = int(np.flatnonzero(meta[:-1, 1] != 0)[0])
        raise ValueError(
            f"shard on host {bad} holds {int(meta[bad, 0])} tokens, not a "
            f"multiple of the lockstep group size {group_syms}; use "
            "split_huffword_shards to plan group-aligned shard offsets")
    if int((meta[:, 2] != meta[0, 2]).sum()):
        raise ValueError(
            "shard first-token classes disagree across hosts — global "
            "word/non-word alternation would break; use "
            "split_huffword_shards to plan shard offsets")
    word_first = bool(meta[0, 2])

    # the vocabulary union: gather each class's token text, lengths and
    # counts, then one (length, content) merge
    union_vocabs = []
    id_maps = []
    for v in (wv, nv):
        tok_lens = np.diff(v.offsets).astype(np.int64)
        blob_parts = _gather_ragged(np.frombuffer(v.blob, np.uint8))
        len_parts = _gather_ragged(tok_lens)
        cnt_parts = _gather_ragged(v.counts.astype(np.int64))
        union, maps = tok.merge_vocab_parts(blob_parts, len_parts, cnt_parts)
        union_vocabs.append(union)
        id_maps.append(maps[pid])
    uwv, unv = union_vocabs

    limit = lockstep.fused_length_limit(conf)
    cbs = [build_codebook(uwv.counts, limit), build_codebook(unv.counts, limit)]

    # local ids -> union ids, then the shard's encode.  Shard token offsets
    # are multiples of the (even) group size, so local parity is global.
    is_word = (np.arange(T) % 2 == 0) == word_first
    gids = np.where(is_word,
                    id_maps[0][np.minimum(ids, max(wv.n - 1, 0))] if wv.n else 0,
                    id_maps[1][np.minimum(ids, max(nv.n - 1, 0))] if nv.n else 0)
    payload, group_counts = encode_lockstep_tokens(
        gids, T, word_first, cbs, uwv.n, unv.n, S, rows=rows, device=device)

    checksum = _stitched_checksum(local_data, conf)
    words = _gather_ragged(payload.astype(np.uint32))
    tables = _gather_ragged(group_counts.astype(np.int64))

    if pid != 0:
        return None
    f = container.GlzFile(
        mode=cfg.MODE_HUFFWORD,
        n_symbols=int(meta[:, 0].sum()),
        stream_symbols=S,
        stream_bits=np.concatenate(tables).astype(np.uint64),
        codebook_blob=huffword_cb_blob(word_first, uwv, unv, cbs),
        payload=np.concatenate(words).astype("<u4").tobytes(),
        layout=container.LAYOUT_LOCKSTEP,
        group_rows=rows,
        checksum=checksum,
    )
    return container.write_container(f)
