"""The front door, with glz_tpu's signatures and defaults
(glz_tpu/core/api.py): compress()/decompress(), the multi-file batch and
the .glzb archive.

The port carries byte mode and HuffWord mode in both payload layouts:
bitstream (layout 0) and lockstep (layout 2), and the normal-tree mode (a
host codec, as in glz_tpu).  `backend` picks the container as glz_tpu's
does: "host" (the default) writes the host encoder's byte container (one
bit stream, payload bytes up to the last code bit), "device" the device
path's (word-aligned dispatches), and a HuffWord "device" request writes a
lockstep container; like glz_tpu, any backend but "device" means "host".  decompress's `variant` picks the decoder strategy
as glz_tpu's does (see decompress).  Every backend and strategy runs on
the card; device='cpu' runs the kernels' plain versions.  Every entry
point passes `device` down to each call it makes.

The front door decides, each in one place, what the models are handed:
it parses a container once and gives the GlzFile to the decode of its mode
and layout, picks the byte encoder (_byte_encoder) and HuffWord's layout
(_huffword_lockstep), normalises the decoder strategy for each mode, and
runs the shared-codebook batch of both modes.  The models import nothing of
it.

Each entry point is a root span of utils/timer.py (`compress`,
`decompress`, `compress_batch`, `decompress_batch`; the archive goes
through the batch), and the steps below it are its child spans.
"""

from __future__ import annotations

import concurrent.futures
import struct
import time

import numpy as np

from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import container, lockstep
from glz_tpu_torch.core.codebook import build_codebook, sampled_histogram
from glz_tpu_torch.models import canonical_byte as cb_model
from glz_tpu_torch.models import huffword as hw_model
from glz_tpu_torch.models import normal_tree
from glz_tpu_torch.models.transfer import resolve_device
from glz_tpu_torch.utils import timer
from glz_tpu_torch.utils import tokenizer as tok


def _pipelined(fn, datas, pipeline: bool) -> list:
    """Per-file compress with a 2-deep overlap: with pipeline=True two files
    are in flight at once on a thread pool, so one file's host phases run
    while the other's kernels do.  Results come back in input order.

    Each file's call is a `batch.file` span; on the pool, a `batch.wait`
    span before it runs from the submission to the worker's start.  Both
    take the caller's open span (the batch) as their parent."""
    if len(datas) <= 1 or not pipeline:
        def serial(d):
            with timer.span("batch.file"):
                return fn(d)
        return [serial(d) for d in datas]
    batch = timer.current()
    submitted = time.perf_counter_ns()

    def one(d):
        with timer.span("batch.wait", parent=batch, start_ns=submitted):
            pass
        with timer.span("batch.file", parent=batch):
            return fn(d)

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        return list(ex.map(one, datas))


def _byte_encoder(backend: str, conf: cfg.GlzConfig):
    """The byte model's compress for backend and conf: a lockstep conf
    writes the lockstep layout whatever the backend."""
    if conf.layout == cfg.LAYOUT_LOCKSTEP:
        return cb_model.compress_bytes_lockstep
    if backend == "device":
        return cb_model.compress_bytes_device
    return cb_model.compress_bytes_host


def _huffword_lockstep(backend: str, conf: cfg.GlzConfig) -> bool:
    """HuffWord writes the lockstep layout when backend is "device" or
    conf.layout is lockstep, as glz_tpu's compress_huffword does."""
    return backend == "device" or conf.layout == cfg.LAYOUT_LOCKSTEP


def compress(data: bytes, mode: int = cfg.MODE_BYTE, backend: str = "host",
             conf: cfg.GlzConfig = cfg.DEFAULT, device=None) -> bytes:
    """Compress `data` into a .glz container, as glz_tpu.compress does with
    the same arguments: a lockstep conf writes the lockstep layout whatever
    the backend; otherwise byte mode writes compress_bytes_host's container
    (backend "host") or compress_bytes_device's ("device"), and HuffWord
    mode a bitstream container ("host") or a lockstep one ("device").

    device: None runs on the card; 'cpu' runs the kernels' plain versions."""
    with timer.span("compress"):
        return _compress(data, mode, backend, conf, device)


def _compress(data, mode, backend, conf, device) -> bytes:
    if mode == cfg.MODE_HUFFWORD:
        if _huffword_lockstep(backend, conf):
            return hw_model.compress_huffword_lockstep(data, conf, device=device)
        return hw_model.compress_huffword_bitstream(data, conf, device=device)
    if mode == cfg.MODE_NORMAL_TREE:
        return normal_tree.compress_normal_tree(data, conf, device=device)
    if mode != cfg.MODE_BYTE:
        raise ValueError(f"unsupported mode {mode}")
    return _byte_encoder(backend, conf)(data, conf, device=device)


def decompress(blob: bytes, backend: str = "host", variant: str = cfg.DECODER_TABLE,
               device=None) -> bytes:
    """Decompress a .glz container (mode and layout are self-describing),
    with the decoder strategy glz_tpu.decompress runs for the same
    arguments, each a kernel on the card (device=None):

      byte bitstream     backend "device" or variant "device": the table;
                         else variant "table", "fast" or "bitwalk", and any
                         other raises ValueError (once there is a symbol)
      HuffWord bitstream variant "fast" or "bitwalk"; any other the table
      lockstep, normal tree   the one decoder, whatever the variant

    Every strategy gives the same bytes for a valid container."""
    with timer.span("decompress"):
        return _decompress(blob, backend, variant, device)


def _decompress(blob, backend, variant, device) -> bytes:
    resolve_device(device)
    f = container.read_container(blob)
    if f.mode == cfg.MODE_HUFFWORD:
        if variant not in (cfg.DECODER_BITWALK, cfg.DECODER_FAST):
            variant = cfg.DECODER_TABLE
        return hw_model.decompress_huffword(f, device=device, variant=variant)
    if f.mode == cfg.MODE_BYTE:
        if f.layout == container.LAYOUT_LOCKSTEP:
            return cb_model.decompress_bytes_lockstep(f, device=device)
        if backend == "device" or variant == cfg.DECODER_DEVICE:
            variant = cfg.DECODER_TABLE
        return cb_model.decompress_bytes_device(f, device=device, variant=variant)
    if f.mode == cfg.MODE_NORMAL_TREE:
        return normal_tree.decompress_normal_tree(f, device=device)
    raise ValueError(f"unsupported container mode {f.mode}")


# ---- the multi-file batch ----------------------------------------------------

def compress_batch(datas: list[bytes], mode: int = cfg.MODE_BYTE, backend: str = "host",
                   conf: cfg.GlzConfig = cfg.DEFAULT, pipeline: bool = True,
                   shared_codebook: bool = False, device=None) -> list[bytes]:
    """Compress independent inputs (a multi-file corpus), as
    glz_tpu.compress_batch does with the same arguments.

    shared_codebook=False (the default): each file gets its own codebook and
    container, compress()'s for the same arguments.  With pipeline=True two
    files are in flight at once on a thread pool, so one file's host phases
    (histogram, codebook, container, crc32) run while the other's kernels
    do; the kernels of both go to the default stream.  Results come back in
    input order and equal the serial loop's.

    shared_codebook=True: ONE codebook is built from the frequencies of the
    whole file list and every container uses it.  Each container still
    embeds the codebook and decodes alone; compress_archive stores it once.
    conf.layout and backend select the container as in compress()."""
    with timer.span("compress_batch"):
        if shared_codebook:
            return _compress_batch_shared(datas, mode, backend, conf, pipeline, device)
        return _pipelined(
            lambda d: compress(d, mode=mode, backend=backend, conf=conf, device=device),
            datas, pipeline)


def _compress_batch_shared(datas, mode, backend, conf, pipeline, device) -> list[bytes]:
    if mode == cfg.MODE_HUFFWORD:
        return compress_huffword_shared(datas, conf, backend=backend, pipeline=pipeline,
                                        device=device)
    if mode != cfg.MODE_BYTE:
        raise ValueError("shared_codebook supports byte and huffword modes")
    hist = np.zeros(256, np.int64)
    for d in datas:
        with timer.span("histogram"):
            hist += sampled_histogram(np.frombuffer(d, np.uint8), conf.histogram_budget)
    limit = (lockstep.fused_length_limit(conf) if conf.layout == cfg.LAYOUT_LOCKSTEP
             else conf.length_limit)
    with timer.span("codebook"):
        cb = build_codebook(hist, limit)
    encode = _byte_encoder(backend, conf)
    return _pipelined(lambda d: encode(d, conf, codebook=cb, device=device), datas, pipeline)


def compress_huffword_shared(datas: list[bytes], conf: cfg.GlzConfig = cfg.DEFAULT,
                             backend: str = "host", pipeline: bool = True,
                             device=None) -> list[bytes]:
    """Compress a multi-file corpus with ONE shared dual codebook.

    Each file's vocabularies are built independently, merged with
    tokenizer.merge_vocab_parts, and every file's token ids are remapped
    into the union before encoding.  Every returned container embeds the
    full shared codebook and decodes independently.  With pipeline=True two
    files are in flight at once on a thread pool.  conf.layout and backend
    select the container as in compress()."""
    rows = lockstep.group_rows(conf)
    is_lockstep = _huffword_lockstep(backend, conf)
    dev = resolve_device(device)
    per = [tok.build_vocabs(d) for d in datas]

    union_vocabs = []
    id_maps = []
    for cls in (3, 4):  # wv, nv of build_vocabs' return tuple
        parts = [(np.frombuffer(p[cls].blob, np.uint8),
                  np.diff(p[cls].offsets), p[cls].counts) for p in per]
        union, maps = tok.merge_vocab_parts(
            [b for b, _, _ in parts], [l for _, l, _ in parts],
            [c for _, _, c in parts])
        union_vocabs.append(union)
        id_maps.append(maps)
    uwv, unv = union_vocabs

    if is_lockstep:
        S = lockstep.huffword_stream_tokens(conf)
        rows = lockstep.capped_rows(rows, S, max(uwv.n, unv.n) <= 0xFFFF)
        limit = lockstep.fused_length_limit(conf)
    else:
        limit = conf.length_limit
    with timer.span("codebook"):
        cbs = [build_codebook(uwv.counts, limit), build_codebook(unv.counts, limit)]

    def one(args):
        data, (_, _, word_first, wv, nv, ids), k = args
        T = ids.size
        if T:
            is_word = (np.arange(T) % 2 == 0) == word_first
            gids = np.where(
                is_word,
                id_maps[0][k][np.minimum(ids, max(wv.n - 1, 0))] if wv.n else 0,
                id_maps[1][k][np.minimum(ids, max(nv.n - 1, 0))] if nv.n else 0)
        else:
            gids = np.zeros(0, np.int64)
        if is_lockstep:
            return hw_model.lockstep_container(data, conf, word_first, uwv, unv, gids, cbs,
                                               S, rows, dev)
        return hw_model.bitstream_container(data, conf, word_first, uwv, unv, gids, cbs, dev)

    jobs = [(d, p, k) for k, (d, p) in enumerate(zip(datas, per))]
    return _pipelined(one, jobs, pipeline)


def decompress_batch(blobs: list[bytes], backend: str = "host", pipeline: bool = True,
                     device=None) -> list[bytes]:
    """Decompress containers with compress_batch's 2-deep pipeline (one
    file's host phases, detokenize and crc32, while the other's kernels
    run)."""
    with timer.span("decompress_batch"):
        return _pipelined(lambda b: decompress(b, backend=backend, device=device), blobs,
                          pipeline)


# ---- .glzb archive: a shared-codebook batch with the codebook stored ONCE -----
#
# Entry containers are whole .glz files whose codebook bytes are factored
# out: the archive stores the longest common SUFFIX of every container's
# codebook blob once (byte mode: the whole blob; HuffWord: everything after
# the per-file word_first byte), and each entry keeps only its per-file
# prefix.  Rebuilding an entry is byte splicing, so every entry decodes
# through the ordinary container path.
#
# Layout (little-endian), glz_tpu's byte for byte:
#   0:4  magic b"GLZB"; 4:1 version (1); 5:1 mode; 6:2 reserved
#   8:4  n_files (u32); 12:4 shared codebook size (u32); 16:.. shared blob
#   then per file: u32 prefix_len, u64 body_len, prefix, body
#   (body = the .glz container bytes with the codebook section removed)

ARCHIVE_MAGIC = b"GLZB"
_ARCHIVE_HEADER = "<4sBBHII"
_ENTRY_HEADER = "<IQ"


def common_suffix_len(blobs: list[bytes]) -> int:
    """Length of the longest suffix that every blob ends with (0 for no
    blobs): one backward scan of each blob against the first, so O(total
    length).  glz_tpu searches downward from the shortest length instead,
    O(L^2); the result is the same."""
    if not blobs:
        return 0
    first = np.frombuffer(blobs[0], np.uint8)
    shared = min(len(b) for b in blobs)
    for b in blobs[1:]:
        if not shared:
            break
        tail = np.frombuffer(b, np.uint8)[len(b) - shared:][::-1]
        differ = np.flatnonzero(tail != first[first.size - shared:][::-1])
        if differ.size:
            shared = int(differ[0])
    return shared


def compress_archive(datas: list[bytes], mode: int = cfg.MODE_BYTE, backend: str = "host",
                     conf: cfg.GlzConfig = cfg.DEFAULT, device=None) -> bytes:
    """Shared-codebook multi-file archive (.glzb), as glz_tpu.compress_archive
    writes it: one codebook for the whole corpus, n_files - 1 fewer
    codebook copies than per-file containers."""
    blobs = compress_batch(datas, mode=mode, backend=backend, conf=conf,
                           shared_codebook=True, device=device)
    cbs = [container.read_container(b).codebook_blob for b in blobs]
    shared_len = common_suffix_len(cbs)
    shared = cbs[0][len(cbs[0]) - shared_len:] if shared_len else b""
    parts = [struct.pack(_ARCHIVE_HEADER, ARCHIVE_MAGIC, 1, mode, 0, len(blobs), shared_len),
             shared]
    cb_off = container.HEADER_SIZE
    for b, c in zip(blobs, cbs):
        prefix = c[: len(c) - shared_len]
        body = b[:cb_off] + b[cb_off + len(c):]
        parts += [struct.pack(_ENTRY_HEADER, len(prefix), len(body)), prefix, body]
    return b"".join(parts)


def archive_peek_layout(blob: bytes | memoryview) -> int:
    """Payload layout of a .glzb archive's first entry, from its headers
    only (every entry of an archive shares one layout).  Reads no payload
    and touches no card, so it takes no `device`."""
    mv = memoryview(blob)
    if len(mv) < 16 or bytes(mv[:4]) != ARCHIVE_MAGIC:
        raise ValueError("not a .glzb archive")
    _m, _v, _mode, _r, n_files, shared_len = struct.unpack_from(_ARCHIVE_HEADER, mv, 0)
    if n_files == 0:
        return container.LAYOUT_BITSTREAM
    off = 16 + shared_len
    if off + 12 > len(mv):
        raise ValueError("corrupt .glzb archive: truncated before entry 0")
    plen, _blen = struct.unpack_from(_ENTRY_HEADER, mv, off)
    off += 12 + plen
    return container.peek_layout(mv[off : off + container.HEADER_SIZE])


def archive_entries(blob: bytes | memoryview
                    ) -> tuple[int, memoryview, list[tuple[memoryview, memoryview]]]:
    """(mode, shared codebook, [(prefix, body) of each file]) of a .glzb
    archive, read from its headers without decoding.  Every offset is
    checked against the archive's size, so a truncated or corrupt archive
    raises ValueError."""
    mv = memoryview(blob)
    if len(mv) < 16 or bytes(mv[:4]) != ARCHIVE_MAGIC:
        raise ValueError("not a .glzb archive")
    _m, version, mode, _r, n_files, shared_len = struct.unpack_from(_ARCHIVE_HEADER, mv, 0)
    if version != 1:
        raise ValueError(f"unsupported .glzb version {version}")
    off = 16
    if off + shared_len > len(mv):
        raise ValueError("corrupt .glzb archive: truncated shared codebook")
    shared = mv[off : off + shared_len]
    off += shared_len
    entries = []
    for k in range(n_files):
        if off + 12 > len(mv):
            raise ValueError(f"corrupt .glzb archive: truncated entry {k}")
        plen, blen = struct.unpack_from(_ENTRY_HEADER, mv, off)
        off += 12
        if off + plen + blen > len(mv):
            raise ValueError(f"corrupt .glzb archive: truncated entry {k}")
        entries.append((mv[off : off + plen], mv[off + plen : off + plen + blen]))
        off += plen + blen
    return mode, shared, entries


def decompress_archive(blob: bytes, backend: str = "host", device=None) -> list[bytes]:
    """Decode every file of a .glzb archive (the inverse of
    compress_archive): each entry is rebuilt by splicing the shared codebook
    back and decoded through decompress_batch."""
    _, shared, entries = archive_entries(blob)
    shared = bytes(shared)
    cb_off = container.HEADER_SIZE
    out = [bytes(body[:cb_off]) + bytes(prefix) + shared + bytes(body[cb_off:])
           for prefix, body in entries]
    return decompress_batch(out, backend=backend, device=device)
