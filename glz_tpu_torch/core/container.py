"""The .glz container — the framework's self-describing compressed format.

The reference's containers are strictly serial: one codebook header then one
bit stream (canonical byte format .crs2: canonical_huff_encoder.cc:211-242;
normal-tree .crs: huff_tree.cc:174-187; HuffWord .crs3: Boost archive,
canonical_huffword.h:311-358).  The .glz container keeps the self-describing
codebook property — a fresh process can decode with no shared state — but
splits the payload into fixed-symbol-count streams whose bit lengths are
recorded, so decode parallelism is container-native.  Codebooks are stored
as code-length tables only (canonical reconstruction is deterministic),
which is far smaller than the reference's 257 x u32 symbol dump.

Layout (little-endian):
    0:4   magic  b"GLZ1"
    4:1   version (1; 2 when group_rows != 8 — a version-1-only reader
          would decode a wide-group container with the assumed 8-row
          geometry and emit garbage, so wide containers must be rejected
          by older readers, not misread)
    5:1   mode (0 byte, 1 huffword, 2 normal-tree)
    6:1   flags: low nibble = payload layout (LAYOUT_BITSTREAM /
          LAYOUT_LOCKSTEP); bit4 (FLAG_CHECKSUM) = trailing crc32 present
    7:1   group_rows for the lockstep layout (0 = legacy default 8): a
          group holds group_rows*128 streams; wider groups amortize the
          decode kernel's per-step overhead (ops/pallas_decode.py)
    8:8   original symbol count (u64)   [byte mode: original byte size]
    16:4  n_streams (u32)
    20:4  stream_symbols (u32)
    24:4  codebook blob size (u32)
    28:4  reserved
    32:.. codebook blob
    ..    stream table (n_streams x u32): layout 0 = bits per stream,
          layout 2 = payload words per group
    ..    payload: layout 0 = streams bit-stitched MSB-first; layout 2 =
          consumption-ordered '<u4' words (core/lockstep.py)
    ..    crc32 of the original data (u32, only with FLAG_CHECKSUM)

Byte-mode codebook blob: u8 max_len; if max_len <= 15, 128 B of packed
nibbles (symbol 2i in the high nibble), else 256 B of u8 lengths.

checksum_of and verify are the trailing crc32's two ends, each a `verify`
span: the crc is taken on the caller's buffer, with no copy.

write_container and read_container are the `container.write` and
`container.read` spans of utils/timer.py, each counting the bytes it copies
as `host_copy_bytes`.  write_container copies each section once, into the
one container it returns (the payload may be any buffer, such as the
D2H'd words' memoryview: it is not copied before), made by
utils/fill.py fresh_bytes; write_container_into writes into fresh
bytes that the caller started as soon as it knew the container's size
(container_size), so that their pages are in place by then.  read_container
copies only the codebook section (129-257 B in byte mode): GlzFile.payload
is a read-only memoryview of the caller's blob, so a parse costs
microseconds whatever the payload's size, and the GlzFile keeps the blob
alive.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from glz_tpu_torch.utils import fill, timer


MAGIC = b"GLZ1"
VERSION = 1        # baseline format
VERSION_WIDE = 2   # identical layout, group_rows != 8 (header byte 7)
HEADER_FMT = "<4sBBBBQIIII"
HEADER_SIZE = struct.calcsize(HEADER_FMT)  # 32


def encode_byte_codebook(lengths: np.ndarray) -> bytes:
    lengths = np.asarray(lengths, dtype=np.uint8)
    assert lengths.shape[0] == 256
    max_len = int(lengths.max(initial=0))
    if max_len <= 15:
        hi = lengths[0::2].astype(np.uint8)
        lo = lengths[1::2].astype(np.uint8)
        packed = ((hi << 4) | lo).astype(np.uint8)
        return bytes([max_len]) + packed.tobytes()
    return bytes([max_len]) + lengths.tobytes()


def decode_byte_codebook(blob: bytes) -> np.ndarray:
    if len(blob) < 1:
        raise ValueError("corrupt .glz container: empty byte codebook blob")
    max_len = blob[0]
    body = np.frombuffer(blob, dtype=np.uint8, offset=1)
    want = 128 if max_len <= 15 else 256
    if body.size != want:
        raise ValueError(
            f"corrupt .glz container: byte codebook blob is {body.size + 1} "
            f"bytes, expected {want + 1} for max_len={max_len}")
    if max_len <= 15:
        lengths = np.empty(256, dtype=np.int32)
        lengths[0::2] = body >> 4
        lengths[1::2] = body & 0xF
    else:
        lengths = body.astype(np.int32)
    if int(lengths.max(initial=0)) > 32:
        raise ValueError("corrupt .glz container: code length > 32")
    return lengths


# Payload layouts
LAYOUT_BITSTREAM = 0  # bit-stitched streams + per-stream bit-length table
LAYOUT_LOCKSTEP = 2   # consumption-ordered u32 words (core/lockstep.py) +
                      # per-group word-count table
FLAG_CHECKSUM = 0x10  # header flag: trailing crc32 of the original data


@dataclasses.dataclass
class GlzFile:
    mode: int
    n_symbols: int          # total input symbols (bytes for byte mode)
    stream_symbols: int
    stream_bits: np.ndarray  # layout 0: bits per stream; layout 2: words per group
    codebook_blob: bytes
    payload: bytes | memoryview  # layout 0: MSB-first bit stream; layout 2: '<u4'
                                 # words; read_container's is a view of the blob
    layout: int = LAYOUT_BITSTREAM
    checksum: int | None = None  # crc32 of the ORIGINAL data when present
    group_rows: int = 8          # lockstep group geometry (rows of 128 lanes)

    @property
    def n_streams(self) -> int:
        return int(self.stream_bits.shape[0])


def checksum_of(data, conf) -> int | None:
    """crc32 of the original data when conf.checksum is set, else None."""
    if not conf.checksum:
        return None
    with timer.span("verify"):
        return zlib.crc32(np.ascontiguousarray(data) if isinstance(data, np.ndarray) else data)


def verify(data: bytes, f: GlzFile) -> bytes:
    """`data`, after checking it against f's crc32 when f carries one."""
    if f.checksum is not None:
        with timer.span("verify"):
            if zlib.crc32(data) & 0xFFFFFFFF != f.checksum:
                raise ValueError("checksum mismatch: corrupt container or decoder bug")
    return data


def container_size(codebook_bytes: int, n_streams: int, payload_bytes: int,
                   checksum: bool) -> int:
    """The bytes of a container with these sections."""
    return HEADER_SIZE + codebook_bytes + 4 * n_streams + payload_bytes + (4 if checksum else 0)


def write_container(f: GlzFile) -> bytes:
    """f's container, in bytes whose pages are put in place from here."""
    size = container_size(len(f.codebook_blob), f.n_streams, memoryview(f.payload).nbytes,
                          f.checksum is not None)
    with fill.fresh_bytes(size) as dest:
        return write_container_into(f, dest)


def write_container_into(f: GlzFile, dest: fill.FreshBytes) -> bytes:
    """f's container, written into `dest`: the fresh bytes of its size that
    the caller started as soon as it knew the size."""
    with timer.span("container.write"):
        out = dest.fill(_sections(f))
        timer.count(timer.HOST_COPY_BYTES, len(out))
        return out


def _sections(f: GlzFile) -> tuple:
    flags = f.layout | (FLAG_CHECKSUM if f.checksum is not None else 0)
    wide = f.layout == LAYOUT_LOCKSTEP and f.group_rows != 8
    header = struct.pack(
        HEADER_FMT,
        MAGIC,
        VERSION_WIDE if wide else VERSION,
        f.mode,
        flags,
        f.group_rows if f.layout == LAYOUT_LOCKSTEP else 0,
        f.n_symbols,
        f.n_streams,
        f.stream_symbols,
        len(f.codebook_blob),
        0,
    )
    table = np.asarray(f.stream_bits, dtype=np.uint32).astype("<u4").tobytes()
    tail = struct.pack("<I", f.checksum & 0xFFFFFFFF) if f.checksum is not None else b""
    return header, f.codebook_blob, table, f.payload, tail


def is_glz(blob: bytes | memoryview) -> bool:
    """True when blob starts with the .glz magic."""
    return bytes(memoryview(blob)[:4]) == MAGIC


def peek_layout(blob: bytes | memoryview) -> int:
    """Payload layout of a .glz container without a full parse (the CLI
    decides whether to warm the device backend before decode).  This is
    the ONLY sanctioned way to look at the flags byte outside this module
    (r4 review weak #6: raw `blob[6] & 0x0F` sniffs duplicate format
    knowledge that silently breaks if the header moves)."""
    mv = memoryview(blob)
    if bytes(mv[:4]) != MAGIC:
        raise ValueError("not a .glz container (bad magic)")
    if len(mv) < HEADER_SIZE:
        raise ValueError(
            f"not a .glz container: {len(mv)} bytes, header needs {HEADER_SIZE}")
    return mv[6] & 0x0F


def read_container(blob: bytes | memoryview) -> GlzFile:
    with timer.span("container.read"):
        f = _read_container(blob)
        timer.count(timer.HOST_COPY_BYTES, len(f.codebook_blob))
        return f


def _read_container(blob: bytes | memoryview) -> GlzFile:
    blob = memoryview(blob).toreadonly()
    if len(blob) < HEADER_SIZE:
        raise ValueError(
            f"not a .glz container: {len(blob)} bytes, header needs {HEADER_SIZE}")
    (magic, version, mode, flags, _r0, n_symbols, n_streams, stream_symbols,
     cb_size, _r1) = struct.unpack_from(HEADER_FMT, blob, 0)
    if magic != MAGIC:
        raise ValueError("not a .glz container (bad magic)")
    if version not in (VERSION, VERSION_WIDE):
        raise ValueError(f"unsupported .glz version {version}")
    layout = flags & 0x0F
    if layout not in (LAYOUT_BITSTREAM, LAYOUT_LOCKSTEP):
        raise ValueError(f"corrupt .glz container: unknown payload layout {layout}")
    off = HEADER_SIZE
    end = len(blob)
    if flags & FLAG_CHECKSUM:
        if end - off < 4:
            raise ValueError("corrupt .glz container: truncated before checksum")
        (checksum,) = struct.unpack_from("<I", blob, end - 4)
        end -= 4
    else:
        checksum = None
    if off + cb_size + 4 * n_streams > end:
        raise ValueError(
            "corrupt .glz container: truncated (codebook/stream table extend "
            f"past byte {end})")
    cb_blob = bytes(blob[off : off + cb_size])
    off += cb_size
    table = np.frombuffer(blob, dtype="<u4", count=n_streams, offset=off).astype(np.uint64)
    off += 4 * n_streams
    payload = blob[off:end]
    if layout == LAYOUT_LOCKSTEP and len(payload) < 4 * int(table.sum()):
        raise ValueError(
            "corrupt .glz container: lockstep payload shorter than the "
            "group word table claims")
    if layout == LAYOUT_BITSTREAM and len(payload) * 8 < int(table.sum()):
        raise ValueError(
            "corrupt .glz container: payload shorter than the stream bit "
            "table claims")
    if layout == LAYOUT_LOCKSTEP:
        group_rows = _r0 or 8  # 0 = legacy container, default geometry
        if group_rows not in (8, 16, 32, 64):
            raise ValueError(
                f"corrupt .glz container: unsupported group_rows {group_rows}")
    else:
        group_rows = 8
    return GlzFile(
        mode=mode,
        n_symbols=n_symbols,
        stream_symbols=stream_symbols,
        stream_bits=table,
        codebook_blob=cb_blob,
        payload=payload,
        layout=layout,
        checksum=checksum,
        group_rows=group_rows,
    )
