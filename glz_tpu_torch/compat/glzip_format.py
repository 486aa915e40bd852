"""The reference codec's on-disk formats, on the host: .crs2, .crs3 and .crs.

A copy of glz_tpu/compat/glzip_format.py; each package writes the same bytes
for the same input and reads the other's files.

  * .crs2 — canonical byte format (CanonicalHuffEncoder<unsigned char>):
    big-endian u32 header {symbol_num=257, symbol_[257], min_len, max_len,
    (start_pos, first_code)[1..max_len]} then the MSB-first code stream,
    terminated by the EOF symbol (id 256) and 1-padded
    (canonical_huff_encoder.cc:211-265).  read_crs2 decodes with the host
    library (utils/native.py); read_crs2_ref is its Python reference.
  * .crs3 — HuffWord format (CanonicalHuffEncoder<std::string>): a Boost
    binary_oarchive holding both dictionaries' headers in word-first order
    (per dict: symbol_num, max_len, min_len, symbol strings, symbol_index,
    first_code[0..max], start_pos[0..max] — canonical_huffword.h:311-358),
    then the appended MSB-first token code stream alternating dictionaries,
    terminated by the "\xff" EOF pseudo-symbol of the dictionary the NEXT
    token would have used, 1-padded (canonical_huffword.h:374-433;
    encoder.h:188-197).  Boost itself is not needed: the archive preamble
    and primitive encodings are written and parsed directly (notes at the
    .crs3 section).
  * .crs — normal tree format (NormalHuffEncoder): a preorder-serialized
    Huffman tree (internal node = 0xFF,0xFF; leaf = 0x00,key), then a
    (left_bits, last_byte) slot, then the whole payload bytes; the final
    partial byte is zero-completed and stored in the slot.  Tree ties are
    broken by insertion order; read_crs walks the tree one bit at a time, as
    the reference's decoder does.

Compressed sizes match the reference tool's (total payload bits are the same
for any optimal code), though code assignments may differ where frequencies
tie (the reference's tie-breaking follows std::priority_queue internals;
ours is deterministic by symbol index).  These formats are decoded on the
host: no kernel reads them.
"""

from __future__ import annotations

import heapq
import struct

import numpy as np

from glz_tpu_torch.core import bitio
from glz_tpu_torch.core.codebook import build_codebook, histogram_bytes

EOF_SYMBOL = 256
SENTINEL = 0x7FFFFFFF  # first_code for lengths < min_len; the reference uses
                       # 1024 (cc:119-121), which breaks for min_len > 10 —
                       # any value above every code works for its decoders.


# --------------------------------------------------------------------------
# .crs2 canonical byte format
# --------------------------------------------------------------------------

def write_crs2(data: bytes) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    freqs = np.zeros(257, dtype=np.int64)
    freqs[:256] = histogram_bytes(arr)
    freqs[EOF_SYMBOL] = 1  # reference pins EOF frequency (encoder.h:123-129)
    cb = build_codebook(freqs, limit=32)

    header = np.zeros(1 + 257 + 2 + 2 * cb.max_len, dtype=">u4")
    header[0] = 257
    sym = np.full(257, 0xFFFFFFFF, dtype=np.uint64)
    sym[: cb.symbols.size] = cb.symbols.astype(np.uint64)
    header[1:258] = sym
    header[258] = cb.min_len
    header[259] = cb.max_len
    for l in range(1, cb.max_len + 1):
        sp = int(cb.start_pos[l]) if l >= cb.min_len else 0
        fc = int(cb.first_code[l]) if l >= cb.min_len else SENTINEL
        header[260 + 2 * (l - 1)] = sp
        header[260 + 2 * (l - 1) + 1] = fc

    codes = np.concatenate([cb.codewords[arr].astype(np.uint64),
                            [np.uint64(cb.codewords[EOF_SYMBOL])]])
    lens = np.concatenate([cb.lengths[arr].astype(np.uint64),
                           [np.uint64(cb.lengths[EOF_SYMBOL])]])
    words, total_bits = bitio.pack_codes_msb(codes, lens)
    return header.tobytes() + bitio.words_to_bytes(words, total_bits)


def _crs2_tables(blob: bytes):
    """Parse a .crs2 header: (payload, symbols int64[257], left-justified
    first codes u64[max_len + 2], start positions int64[max_len + 2],
    min_len, max_len)."""
    if len(blob) < 4 * 260:
        raise ValueError("not a .crs2 file: header truncated")
    head = np.frombuffer(blob, dtype=">u4", count=260)
    symbol_num = int(head[0])
    if symbol_num != 257:
        raise ValueError(
            f"not a .crs2 file: symbol count {symbol_num} != 257 "
            "(did you pass the original file instead of the .crs2?)")
    symbols = head[1:258].astype(np.int64)
    min_len = int(head[258])
    max_len = int(head[259])
    if not 0 < min_len <= max_len <= 32:
        raise ValueError(f"corrupt .crs2 header: code lengths {min_len}..{max_len}")
    if len(blob) < 4 * (260 + 2 * max_len):
        raise ValueError("corrupt .crs2 header: code tables truncated")
    pairs = np.frombuffer(blob, dtype=">u4", count=2 * max_len, offset=4 * 260)
    start_pos = np.zeros(max_len + 2, dtype=np.int64)
    first_code = np.zeros(max_len + 2, dtype=np.int64)
    start_pos[1 : max_len + 1] = pairs[0::2]
    first_code[1 : max_len + 1] = pairs[1::2]

    payload = blob[4 * (260 + 2 * max_len) :]

    # fast-decoder arithmetic (cc:422-461): left-justified first codes
    fc_lj = np.zeros(max_len + 2, dtype=np.uint64)
    for l in range(min_len, max_len + 1):
        fc_lj[l] = (first_code[l] << (32 - l)) & 0xFFFFFFFF
    return payload, symbols, fc_lj, start_pos, min_len, max_len


def read_crs2(blob: bytes) -> bytes:
    """Decode a .crs2 file with the host library.  The format stores no
    original size, so the output buffer grows until the EOF symbol ends the
    stream short of it."""
    from glz_tpu_torch.utils import native

    payload, symbols, fc_lj, start_pos, min_len, max_len = _crs2_tables(blob)
    syms_padded = np.concatenate([symbols, np.zeros(1024, np.int64)])
    # the library indexes the symbols unchecked, so every code the header's
    # tables can decode must land inside them: a window v decodes at length
    # l when fc_lj[l] <= v < fc_lj[k] for every shorter k
    upper = 1 << 32
    for l in range(min_len, max_len + 1):
        lo = int(fc_lj[l])
        if lo < upper and int(start_pos[l]) + ((upper - 1 - lo) >> (32 - l)) >= syms_padded.size:
            raise ValueError("corrupt .crs2 header: its code tables point past the symbols")
        upper = min(upper, lo)
    cap = max(4 * len(payload), 1 << 12)
    while True:
        out = native.decode_crs2(payload, fc_lj.astype(np.uint32), start_pos.astype(np.uint32),
                                 syms_padded, min_len, max_len, cap)
        if out.size < cap:
            return out.tobytes()
        cap *= 4


def read_crs2_ref(blob: bytes) -> bytes:
    """read_crs2 in Python, one code a step: the tests' plain reference for
    the host library's decoder."""
    payload, symbols, fc_lj, start_pos, min_len, max_len = _crs2_tables(blob)
    words = bitio.bytes_to_words(payload).astype(np.uint64)
    padded = np.concatenate([words, np.zeros(2, np.uint64)])
    out = bytearray()
    pos = 0
    total_bits = len(payload) * 8
    while True:
        w = pos >> 5
        phase = pos & 31
        window = (int(padded[w]) << 32) | int(padded[w + 1])
        v = (window >> (32 - phase)) & 0xFFFFFFFF
        length = min_len
        while length <= max_len and v < int(fc_lj[length]):
            length += 1
        if length > max_len or pos + length > total_bits:
            raise ValueError("corrupt .crs2 stream")
        sym = int(symbols[int(start_pos[length]) + ((v - int(fc_lj[length])) >> (32 - length))])
        if sym == EOF_SYMBOL:
            break
        out.append(sym)
        pos += length
    return bytes(out)


# --------------------------------------------------------------------------
# .crs3 HuffWord format
# --------------------------------------------------------------------------
#
# Boost binary_oarchive primitive encodings on LP64 little-endian Linux (the
# reference's platform): the preamble is the signature std::string
# "serialization::archive" (length as 8-byte size_t, then chars) followed by
# the library version; primitives are raw little-endian (unsigned int / int
# = 4 bytes, std::string = 8-byte size_t length + chars).  The library
# version field width changed across Boost releases (2-byte
# library_version_type in modern Boost, 4-byte unsigned int in pre-1.44);
# the writer emits the modern 2-byte form, the reader accepts both.  The
# format below follows the field sequence documented at
# canonical_huffword.h:311-358 and the primitive rules above; it has not
# been checked against a Boost build of the reference tool, and the tests
# pin it with a golden file and round trips.
#
# Reference quirks preserved / handled:
#   * first_code[0] is an uninitialized stack read in the reference writer
#     (do_gen_encode's local array) — we write 0 and readers must ignore it;
#   * first_code[l] = 1000000 sentinel for l < min_len
#     (canonical_huffword.h:230-232);
#   * the "\xff" EOF pseudo-symbol is ASSIGNED frequency 1 in both dicts
#     (encoder.h:193-197 clobbers any real "\xff" token's count — binary
#     inputs containing a lone 0xFF token are unrepresentable; .crs3 is a
#     text format);
#   * the end mark is written from the dictionary the NEXT token would
#     have come from; the reference picks it via its buggy word_last_
#     (tokenizer.h:127-136) — we use the true last-token class, which is
#     what its decoder's strict alternation actually requires.

_BOOST_SIGNATURE = b"serialization::archive"
_BOOST_VERSION = 17  # boost 1.7x library version; readers accept any


class _ArchiveWriter:
    def __init__(self):
        self.parts = [
            struct.pack("<Q", len(_BOOST_SIGNATURE)), _BOOST_SIGNATURE,
            struct.pack("<H", _BOOST_VERSION),
        ]

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", v & 0xFFFFFFFF))

    def i32(self, v: int):
        self.parts.append(struct.pack("<i", v))

    def string(self, s: bytes):
        self.parts.append(struct.pack("<Q", len(s)))
        self.parts.append(s)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class _ArchiveReader:
    def __init__(self, blob: bytes):
        self.blob = blob
        self.pos = 0
        if len(blob) < 8 + len(_BOOST_SIGNATURE) + 4:
            raise ValueError("not a .crs3 file (truncated archive preamble)")
        (siglen,) = struct.unpack_from("<Q", blob, 0)
        if siglen != len(_BOOST_SIGNATURE) or \
                blob[8 : 8 + siglen] != _BOOST_SIGNATURE:
            raise ValueError("not a .crs3 file (missing Boost archive signature)")
        self.pos = 8 + siglen
        # library version: modern Boost writes 2 bytes, pre-1.44 wrote 4.
        # Disambiguate by looking at what follows: the first archived field
        # is symbol_num (u32 > 0); with a 2-byte version the next 4 bytes
        # must parse as a plausible symbol_num either way, so accept the
        # 2-byte form unless it yields an impossible first dict header.
        (v2,) = struct.unpack_from("<H", blob, self.pos)
        (v4,) = struct.unpack_from("<I", blob, self.pos)
        if v4 < 256:  # whole 4-byte word is a small int -> 4-byte version
            self.pos += 4
        else:
            self.pos += 2
        self.version = v2

    def _need(self, n: int):
        if self.pos + n > len(self.blob):
            raise ValueError("corrupt .crs3 file (truncated archive)")

    def u32(self) -> int:
        self._need(4)
        (v,) = struct.unpack_from("<I", self.blob, self.pos)
        self.pos += 4
        return v

    def i32(self) -> int:
        self._need(4)
        (v,) = struct.unpack_from("<i", self.blob, self.pos)
        self.pos += 4
        return v

    def string(self) -> bytes:
        self._need(8)
        (n,) = struct.unpack_from("<Q", self.blob, self.pos)
        self.pos += 8
        self._need(n)
        s = self.blob[self.pos : self.pos + n]
        self.pos += n
        return s


_HW_EOF = b"\xff"
_HW_SENTINEL = 1000000  # canonical_huffword.h:230-232


def _hw_dicts(data: bytes):
    """Tokenize and build both dictionaries with the reference's EOF
    pseudo-symbol seeded at frequency 1 (encoder.h:188-197)."""
    from glz_tpu_torch.utils import tokenizer as tok

    starts, lengths, word_first, wv, nv, ids = tok.build_vocabs(data)
    dicts = []
    for v in (wv, nv):
        tokens = list(v.tokens)
        counts = v.counts.astype(np.int64).copy() if v.n else np.zeros(0, np.int64)
        if _HW_EOF in v.index:
            counts[v.index[_HW_EOF]] = 1  # reference clobbers (encoder.h:193-197)
            eof_id = v.index[_HW_EOF]
        else:
            tokens.append(_HW_EOF)
            counts = np.concatenate([counts, [1]])
            eof_id = len(tokens) - 1
        dicts.append((tokens, counts, eof_id))
    return starts, lengths, word_first, ids, dicts


def write_crs3(data: bytes) -> bytes:
    starts, lengths, word_first, ids, dicts = _hw_dicts(data)
    T = ids.size

    oa = _ArchiveWriter()
    cbs = []
    for tokens, counts, _eof in dicts:
        cbs.append(build_codebook(counts, limit=32))
    order = (0, 1) if word_first else (1, 0)
    for d in order:
        tokens, counts, _eof = dicts[d]
        cb = cbs[d]
        n_sym = len(tokens)
        oa.u32(n_sym)
        oa.i32(cb.max_len)
        oa.i32(cb.min_len)
        for t in tokens:
            oa.string(t)
        # symbol_index: canonical rank -> index into the token list above
        for r in range(n_sym):
            oa.u32(int(cb.symbols[r]))
        # first_code[0..max_len]: [0]=0 (reference writes stack garbage),
        # sentinel below min_len
        oa.u32(0)
        for l in range(1, cb.max_len + 1):
            oa.u32(int(cb.first_code[l]) if l >= cb.min_len else _HW_SENTINEL)
        for l in range(0, cb.max_len + 1):
            oa.u32(int(cb.start_pos[l]))
    header = oa.getvalue()

    # payload: alternate dictionaries token by token, then the end mark
    # from the dictionary the NEXT token would use
    is_word = (np.arange(T) % 2 == 0) == word_first
    codes = np.empty(T + 1, np.uint64)
    lens = np.empty(T + 1, np.uint64)
    for d, sel in ((0, is_word), (1, ~is_word)):
        codes[:T][sel] = cbs[d].codewords[ids[sel]]
        lens[:T][sel] = cbs[d].lengths[ids[sel]]
    last_is_word = bool(is_word[T - 1]) if T else (not word_first)
    end_d = 1 if last_is_word else 0
    codes[T] = cbs[end_d].codewords[dicts[end_d][2]]
    lens[T] = cbs[end_d].lengths[dicts[end_d][2]]
    words, total_bits = bitio.pack_codes_msb(codes, lens)
    return header + bitio.words_to_bytes(words, total_bits)


def read_crs3(blob: bytes) -> bytes:
    ia = _ArchiveReader(blob)
    dicts = []
    for _ in range(2):
        n_sym = ia.u32()
        max_len = ia.i32()
        min_len = ia.i32()
        if not (0 < n_sym < (1 << 28) and 0 < max_len <= 32
                and 0 < min_len <= max_len):
            raise ValueError("corrupt .crs3 dictionary header")
        tokens = [ia.string() for _ in range(n_sym)]
        symbol_index = np.asarray([ia.u32() for _ in range(n_sym)], np.int64)
        first_code = np.asarray([ia.u32() for _ in range(max_len + 1)], np.int64)
        start_pos = np.asarray([ia.u32() for _ in range(max_len + 1)], np.int64)
        first_code[0] = _HW_SENTINEL  # reference writes garbage here
        dicts.append((tokens, symbol_index, first_code, start_pos,
                      min_len, max_len))
    payload = blob[ia.pos :]

    out = bytearray()
    words = np.concatenate([bitio.bytes_to_words(payload).astype(np.uint64),
                            np.zeros(2, np.uint64)])
    pos = 0
    total_bits = len(payload) * 8
    now = 0
    while True:
        tokens, symbol_index, first_code, start_pos, min_len, max_len = dicts[now]
        w = pos >> 5
        phase = pos & 31
        window = (int(words[w]) << 32) | int(words[w + 1])
        v32 = (window >> (32 - phase)) & 0xFFFFFFFF
        length = min_len
        # reference decode_file: grow v bit by bit until v >= first_code[len]
        while length <= max_len and \
                (v32 >> (32 - length)) < int(first_code[length]):
            length += 1
        if length > max_len or pos + length > total_bits:
            raise ValueError("corrupt .crs3 stream (no code matched)")
        v = v32 >> (32 - length)
        rank = int(start_pos[length]) + v - int(first_code[length])
        if not 0 <= rank < len(tokens):
            raise ValueError("corrupt .crs3 stream (rank out of range)")
        token = tokens[int(symbol_index[rank])]
        if token == _HW_EOF:
            break
        out += token
        pos += length
        now ^= 1
    return bytes(out)


# --------------------------------------------------------------------------
# .crs normal tree format
# --------------------------------------------------------------------------

class _Node:
    __slots__ = ("key", "left", "right")

    def __init__(self, key=None, left=None, right=None):
        self.key = key
        self.left = left
        self.right = right

    @property
    def is_leaf(self):
        return self.left is None


def _build_tree(freqs: np.ndarray) -> _Node:
    heap = []
    counter = 0
    for i in range(256):
        if freqs[i]:
            heap.append((int(freqs[i]), counter, _Node(i)))
            counter += 1
    if not heap:
        heap.append((0, 0, _Node(0)))
        counter = 1
    if len(heap) == 1:
        # degenerate single-symbol tree: add a never-used sibling so both
        # sides can walk it (the reference crashes on this case)
        k = heap[0][2].key
        heap.append((0, counter, _Node((k + 1) % 256)))
        counter += 1
    heapq.heapify(heap)
    while len(heap) > 1:
        w1, _, n1 = heapq.heappop(heap)
        w2, _, n2 = heapq.heappop(heap)
        heapq.heappush(heap, (w1 + w2, counter, _Node(None, n1, n2)))
        counter += 1
    return heap[0][2]


def _serialize(node: _Node, out: bytearray) -> None:
    if node.is_leaf:
        out.append(0)
        out.append(node.key)
    else:
        out.append(255)
        out.append(255)
        _serialize(node.left, out)
        _serialize(node.right, out)


def _gen_codes(node: _Node, prefix: str, table: dict) -> None:
    if node.is_leaf:
        table[node.key] = prefix or "0"
        return
    _gen_codes(node.left, prefix + "0", table)
    _gen_codes(node.right, prefix + "1", table)


def write_crs(data: bytes) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    freqs = histogram_bytes(arr)
    root = _build_tree(freqs)
    tree = bytearray()
    _serialize(root, tree)
    table: dict[int, str] = {}
    _gen_codes(root, "", table)

    codes = np.zeros(256, dtype=np.uint64)
    lens = np.zeros(256, dtype=np.uint64)
    deep = max((len(v) for v in table.values()), default=0) > 32
    if not deep:
        for k, v in table.items():
            codes[k] = int(v, 2) if v else 0
            lens[k] = len(v)
        words, total_bits = bitio.pack_codes_msb(
            codes[arr].astype(np.uint64), lens[arr].astype(np.uint64))
        stream = bitio.words_to_bytes(words, total_bits, pad_ones=False)
    else:  # >32-bit codes: slow exact path
        w = bitio.BitWriter()
        for b in arr:
            for c in table[int(b)]:
                w.write_bits(int(c), 1)
        total_bits = w._nbits + len(w._out) * 8
        w.flush_bits(0)
        stream = w.getvalue()

    left_bits = (8 - total_bits % 8) % 8
    if left_bits:
        slot = bytes([left_bits, stream[-1]])
        body = stream[:-1]
    else:
        slot = bytes([0, 0])
        body = stream
    return bytes(tree) + slot + body


def _parse_tree(blob: bytes, pos: int = 0):
    """Parse the serialized preorder tree at `pos`; returns (root, end)."""
    first = blob[pos]
    second = blob[pos + 1]
    pos += 2
    if first == 0:
        return _Node(second), pos
    node = _Node(None, None, None)
    node.left, pos = _parse_tree(blob, pos)
    node.right, pos = _parse_tree(blob, pos)
    return node, pos


def crs_code_table(blob: bytes) -> dict[int, str]:
    """Parse only the serialized tree of a .crs payload and return the
    byte-symbol -> '0'/'1'-string code table (the reference's stats report
    walks the same in-memory tree, normal_huff_encoder.h:204-271)."""
    root, _ = _parse_tree(blob)
    table: dict[int, str] = {}
    _gen_codes(root, "", table)
    return table


def crs_tree_dot(blob: bytes) -> str:
    """Render a .crs payload's serialized Huffman tree as Graphviz DOT
    text — the reference's DEBUG2 visualizer re-imagined without the
    embedded-Python/pygraphviz machinery (huff_tree.cc:12-136 drives a
    Boost.Python interpreter; plain DOT needs no dependencies and any
    `dot` binary renders it)."""
    root, _ = _parse_tree(blob)
    lines = ["digraph hufftree {", "  node [shape=circle];"]
    counter = [0]

    def walk(node) -> int:
        nid = counter[0]
        counter[0] += 1
        if node.is_leaf:
            ch = chr(node.key) if 32 <= node.key < 127 else f"x{node.key:02x}"
            ch = {'"': '\\"', "\\": "\\\\"}.get(ch, ch)
            lines.append(
                f'  n{nid} [shape=box, label="{ch}"];')
            return nid
        lines.append(f'  n{nid} [label=""];')
        left = walk(node.left)
        lines.append(f'  n{nid} -> n{left} [label="0"];')
        right = walk(node.right)
        lines.append(f'  n{nid} -> n{right} [label="1"];')
        return nid

    walk(root)
    lines.append("}")
    return "\n".join(lines)


def read_crs(blob: bytes) -> bytes:
    root, pos = _parse_tree(blob)
    left_bits = blob[pos]
    last_byte = blob[pos + 1]
    pos += 2
    body = np.frombuffer(blob, dtype=np.uint8, offset=pos)

    out = bytearray()
    node = root
    bits = np.unpackbits(body)
    if left_bits:
        tail = np.unpackbits(np.asarray([last_byte], dtype=np.uint8))[: 8 - left_bits]
        bits = np.concatenate([bits, tail])
    for bit in bits:
        node = node.right if bit else node.left
        if node.is_leaf:
            out.append(node.key)
            node = root
    return bytes(out)
