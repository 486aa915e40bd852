"""The reference codec's .crs (normal tree) format, on the host.

A copy of the .crs half of glz_tpu/compat/glzip_format.py: a
preorder-serialized Huffman tree (internal node = 0xFF,0xFF; leaf =
0x00,key), then a (left_bits, last_byte) slot, then the whole payload
bytes; the final partial byte is zero-completed and stored in the slot.
The .crs2 and .crs3 formats and their Boost archive encodings are not
copied (the command-line interface is the only caller).

Tree ties are broken by insertion order, so the bytes equal glz_tpu's
for the same input.  read_crs walks the tree one bit at a time, as the
reference's decoder does.
"""

from __future__ import annotations

import heapq

import numpy as np

from glz_tpu_torch.core import bitio
from glz_tpu_torch.core.codebook import histogram_bytes


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
