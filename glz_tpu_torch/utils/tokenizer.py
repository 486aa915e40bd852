"""HuffWord tokenizer: the word/non-word splitter and the per-class
vocabularies, on the host (the host library, with numpy references).

A copy of glz_tpu/utils/tokenizer.py.  Token ids, vocabulary order and
token text decide the container's bytes, so every function here computes
exactly what its original computes (tests/test_torch_tokenizer.py and
tests/test_torch_native.py hold them against each other).  build_vocabs and
detokenize run in the host library (utils/native.py); their numpy
versions, build_vocabs_ref and detokenize_ref, are the tests' plain
references.

Semantics:
  * word chars are [0-9A-Za-z] (C-locale isalnum);
  * a single ' - or _ between word chars glues ("he's", "pku-online" stay
    one word); two in a row split;
  * tokens strictly alternate word / non-word, and word_first is the class
    of the first emitted token.

The vectorized formulation: wordlike[i] =
    isalnum[i] or (ishyphen[i] and isalnum[i+1] and (i == 0 or isalnum[i-1]))
then tokens are maximal runs of equal wordlike class.
"""

from __future__ import annotations

import numpy as np

from glz_tpu_torch.utils import timer

_ALNUM = np.zeros(256, dtype=bool)
for _c in range(256):
    _ALNUM[_c] = chr(_c).isascii() and chr(_c).isalnum()
_HYPHEN = np.zeros(256, dtype=bool)
for _c in b"'-_":
    _HYPHEN[_c] = True


def _as_array(data: bytes | np.ndarray) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


def wordlike_mask(data: np.ndarray) -> np.ndarray:
    """Per-byte 'belongs to a word token' mask."""
    a = _ALNUM[data]
    h = _HYPHEN[data]
    nxt = np.empty_like(a)
    nxt[:-1] = a[1:]
    nxt[-1] = False
    prv = np.empty_like(a)
    prv[1:] = a[:-1]
    prv[0] = True  # stream start counts as "ntoken empty"
    return a | (h & nxt & prv)


def tokenize(data: bytes | np.ndarray):
    """Split into alternating tokens.

    Returns (starts i64 [T], lengths i64 [T], word_first bool).
    Token i is data[starts[i] : starts[i]+lengths[i]]; classes alternate
    starting with word_first.
    """
    arr = _as_array(data)
    if arr.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), False
    w = wordlike_mask(arr)
    edges = np.flatnonzero(w[1:] != w[:-1]) + 1
    starts = np.concatenate([[0], edges]).astype(np.int64)
    ends = np.concatenate([edges, [arr.size]]).astype(np.int64)
    return starts, ends - starts, bool(w[0])


class TokenVocab:
    """Token string <-> id maps for one dictionary (word or non-word).

    Ids are (length, content) ranks, so codebook construction is
    deterministic.  `tokens`/`index` materialize lazily — the codec paths
    only need counts/offsets/blob.
    """

    def __init__(self, tokens: list[bytes], counts: np.ndarray):
        self._tokens = tokens         # sorted
        self.counts = counts          # aligned with tokens
        lens = np.fromiter((len(t) for t in tokens), dtype=np.int64, count=len(tokens))
        self.offsets = np.concatenate([[0], np.cumsum(lens)])
        self.blob = b"".join(tokens)
        self._index = None

    @classmethod
    def from_parts(cls, blob: bytes, tok_lens: np.ndarray,
                   counts: np.ndarray | None) -> "TokenVocab":
        """Construct from rank-ordered parts (token text, token lengths,
        counts) without materializing per-token bytes objects.  counts is
        None for a vocabulary read back from a container, which stores
        code lengths rather than counts."""
        v = cls.__new__(cls)
        v._tokens = None
        v.counts = counts
        v.offsets = np.concatenate([[0], np.cumsum(tok_lens)]).astype(np.int64)
        v.blob = blob
        v._index = None
        return v

    @property
    def tokens(self) -> list[bytes]:
        if self._tokens is None:
            self._tokens = [bytes(self.blob[self.offsets[i] : self.offsets[i + 1]])
                            for i in range(self.n)]
        return self._tokens

    @property
    def index(self) -> dict[bytes, int]:
        if self._index is None:
            self._index = {t: i for i, t in enumerate(self.tokens)}
        return self._index

    @property
    def n(self) -> int:
        return int(self.offsets.shape[0] - 1)


KEY_BYTES = 23  # tokens up to this length go through the vectorized path


def _class_vocab(arr: np.ndarray, starts: np.ndarray, lengths: np.ndarray):
    """Vectorized vocabulary for one token class.

    Short tokens (len <= KEY_BYTES) are deduplicated via a fixed-width
    (length byte + padded content) key matrix + np.unique; rare long tokens
    go through a dict.  Id order: short tokens by (length, content), then
    long tokens by (length, content) — deterministic either way, and the
    container stores token text in id order so any order round-trips.
    Returns (TokenVocab, ids aligned with this class's token list).
    """
    T = starts.size
    if T == 0:
        return TokenVocab([], np.zeros(0, np.int64)), np.zeros(0, np.int64)
    short = lengths <= KEY_BYTES
    ids = np.empty(T, dtype=np.int64)

    tokens: list[bytes] = []
    counts_list: list[np.ndarray] = []
    n_short_unique = 0
    if short.any():
        s_starts = starts[short]
        s_lens = lengths[short]
        Ts = s_starts.size
        keys = np.zeros((Ts, KEY_BYTES + 1), dtype=np.uint8)
        keys[:, 0] = s_lens
        # gather bytes column by column: position j of token i =
        # arr[s_starts[i] + j] if j < len.  One column at a time keeps the
        # temporaries at O(Ts) instead of one O(Ts * KEY_BYTES) 2-D index.
        limit = np.int64(arr.size - 1)
        col = np.empty(Ts, dtype=s_starts.dtype)
        for j in range(int(s_lens.max())):
            np.add(s_starts, j, out=col)
            np.minimum(col, limit, out=col)
            np.multiply(arr[col], j < s_lens, out=keys[:, j + 1])
        flat = np.ascontiguousarray(keys).view(f"V{KEY_BYTES + 1}").reshape(-1)
        uniq, inv, cnts = np.unique(flat, return_inverse=True, return_counts=True)
        ids[short] = inv
        n_short_unique = uniq.size
        ukeys = uniq.view(np.uint8).reshape(-1, KEY_BYTES + 1)
        tokens = [bytes(ukeys[i, 1 : 1 + ukeys[i, 0]]) for i in range(uniq.size)]
        counts_list.append(cnts.astype(np.int64))

    if (~short).any():
        mv = arr.tobytes()
        long_idx = np.flatnonzero(~short)
        d: dict[bytes, int] = {}
        toks = []
        for i in long_idx:
            t = mv[int(starts[i]) : int(starts[i]) + int(lengths[i])]
            toks.append(t)
            d[t] = d.get(t, 0) + 1
        lkeys = sorted(d.keys(), key=lambda t: (len(t), t))
        lindex = {t: n_short_unique + r for r, t in enumerate(lkeys)}
        for i, t in zip(long_idx, toks):
            ids[i] = lindex[t]
        tokens = tokens + lkeys
        counts_list.append(np.fromiter((d[t] for t in lkeys), dtype=np.int64,
                                       count=len(lkeys)))

    counts = np.concatenate(counts_list) if counts_list else np.zeros(0, np.int64)
    return TokenVocab(tokens, counts), ids


def build_vocabs(data: bytes | np.ndarray):
    """Tokenize and build both class vocabularies with the host library:
    the native tokenizer, then one hash pass and a (length, content) rank
    sort per class, the two classes on two threads (ctypes releases the
    GIL; they write disjoint positions of `ids`).  build_vocabs_ref is the
    numpy version, with the same ids as int64.

    Returns (starts, lengths, word_first, word_vocab, nonword_vocab,
    token_ids) where token_ids[i] (uint32) is the id of token i within its
    own class's vocab.

    A `vocab` span of utils/timer.py; each class's build on the pool is a
    `vocab` span under it.
    """
    with timer.span("vocab"):
        return _build_vocabs(data)


def _build_vocabs(data):
    import concurrent.futures

    from glz_tpu_torch.utils import native

    arr = _as_array(data)
    bounds, first_word = native.tokenize(arr)
    T = bounds.size - 1
    ids = np.empty(T, np.uint32)
    parent = timer.current()

    def one_class(c):
        if (T - c + 1) // 2 == 0:
            return TokenVocab([], np.zeros(0, np.int64))
        with timer.span("vocab", parent=parent):
            blob, tok_lens, counts = native.build_vocab(arr, bounds, T, c, ids)
            return TokenVocab.from_parts(blob, tok_lens, counts)

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        vocabs = list(ex.map(one_class, (0, 1)))
    # zero-copy reinterprets: offsets and lengths are far below 2^63
    lengths = np.subtract(bounds[1:], bounds[:-1]).view(np.int64)
    starts = bounds[:-1].view(np.int64)
    # class parity 0 is the first token's class
    wv, nv = (vocabs[0], vocabs[1]) if first_word else (vocabs[1], vocabs[0])
    return starts, lengths, bool(first_word), wv, nv, ids


def build_vocabs_ref(data: bytes | np.ndarray):
    """The numpy version of build_vocabs (ids int64): the tests' plain
    reference."""
    arr = _as_array(data)
    starts, lengths, word_first = tokenize(arr)
    T = starts.size
    is_word = (np.arange(T) % 2 == 0) == word_first

    ids = np.zeros(T, dtype=np.int64)
    vocabs = []
    for sel in (is_word, ~is_word):
        vocab, cls_ids = _class_vocab(arr, starts[sel], lengths[sel])
        ids[sel] = cls_ids
        vocabs.append(vocab)
    return starts, lengths, word_first, vocabs[0], vocabs[1], ids


def merge_vocab_parts(blobs, tok_lens_list, counts_list):
    """Union N vocab parts (token blob + per-token lengths + counts, each
    already in (length, content) order) into one TokenVocab plus per-part
    id maps (part-local id -> union id).

    Vectorized the same way _class_vocab is: tokens <= KEY_BYTES dedup
    through a fixed-width (length byte + padded content) key matrix +
    np.unique (the length-first key makes void-dtype lexicographic order ==
    (length, content) order); rare longer tokens go through a dict and sort
    after every short token."""
    parts = len(blobs)
    sizes = [int(np.asarray(t).size) for t in tok_lens_list]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    total = int(offs[-1])
    empty_maps = [np.zeros(0, np.int64) for _ in range(parts)]
    if total == 0:
        return TokenVocab([], np.zeros(0, np.int64)), empty_maps
    pool = np.concatenate([
        np.frombuffer(b, np.uint8) if isinstance(b, (bytes, bytearray, memoryview))
        else np.asarray(b, np.uint8).reshape(-1) for b in blobs])
    lens = np.concatenate([np.asarray(t, np.int64).reshape(-1)
                           for t in tok_lens_list])
    cnts = np.concatenate([np.asarray(c, np.int64).reshape(-1)
                           for c in counts_list])
    starts = np.cumsum(lens) - lens
    union_ids = np.empty(total, np.int64)

    short = lens <= KEY_BYTES
    tokens: list[bytes] = []
    counts_parts: list[np.ndarray] = []
    n_short_unique = 0
    if short.any():
        s_idx = np.flatnonzero(short)
        s_lens = lens[s_idx]
        s_starts = starts[s_idx]
        keys = np.zeros((s_idx.size, KEY_BYTES + 1), np.uint8)
        keys[:, 0] = s_lens
        limit = np.int64(pool.size - 1)
        for j in range(int(s_lens.max(initial=0))):
            col = np.minimum(s_starts + j, limit)
            keys[:, j + 1] = pool[col] * (j < s_lens)
        flat = np.ascontiguousarray(keys).view(f"V{KEY_BYTES + 1}").reshape(-1)
        uniq, inv = np.unique(flat, return_inverse=True)
        union_ids[s_idx] = inv
        n_short_unique = uniq.size
        ucnt = np.zeros(n_short_unique, np.int64)
        np.add.at(ucnt, inv, cnts[s_idx])
        ukeys = uniq.view(np.uint8).reshape(-1, KEY_BYTES + 1)
        tokens = [bytes(ukeys[i, 1 : 1 + ukeys[i, 0]])
                  for i in range(n_short_unique)]
        counts_parts.append(ucnt)

    if (~short).any():
        mv = pool.tobytes()
        long_idx = np.flatnonzero(~short)
        d: dict[bytes, int] = {}
        toks = []
        for i in long_idx:
            t = mv[int(starts[i]) : int(starts[i]) + int(lens[i])]
            toks.append(t)
            d[t] = d.get(t, 0) + int(cnts[i])
        lkeys = sorted(d.keys(), key=lambda t: (len(t), t))
        lindex = {t: n_short_unique + r for r, t in enumerate(lkeys)}
        for i, t in zip(long_idx, toks):
            union_ids[i] = lindex[t]
        tokens = tokens + lkeys
        counts_parts.append(np.fromiter((d[t] for t in lkeys), np.int64,
                                        len(lkeys)))

    counts = (np.concatenate(counts_parts) if counts_parts
              else np.zeros(0, np.int64))
    id_maps = [union_ids[offs[p] : offs[p + 1]] for p in range(parts)]
    return TokenVocab(tokens, counts), id_maps


def detokenize(ids: np.ndarray, word_first: bool,
               wv: TokenVocab, nv: TokenVocab) -> bytes:
    """ids -> original byte stream, with the host library (one memcpy a
    token; detokenize_ref is the numpy version).  A `detokenize` span."""
    if ids.size == 0:
        return b""
    from glz_tpu_torch.utils import native

    with timer.span("detokenize"):
        return native.detokenize(ids, 0 if word_first else 1, wv.offsets, wv.blob,
                                 nv.offsets, nv.blob)


def detokenize_ref(ids: np.ndarray, word_first: bool,
                   wv: TokenVocab, nv: TokenVocab) -> bytes:
    """The numpy version of detokenize (vectorized gather by token): the
    tests' plain reference.

    Both dictionary pools merge into one byte array so a single
    cumsum-of-steps yields every output byte's source index."""
    T = ids.size
    if T == 0:
        return b""
    is_word = (np.arange(T) % 2 == 0) == word_first
    wv_bytes = np.frombuffer(wv.blob, dtype=np.uint8)
    nv_bytes = np.frombuffer(nv.blob, dtype=np.uint8)
    pool = np.concatenate([wv_bytes, nv_bytes]) if nv_bytes.size else wv_bytes
    w_ids = np.minimum(ids, max(wv.n - 1, 0))
    n_ids = np.minimum(ids, max(nv.n - 1, 0))
    starts = np.where(is_word,
                      wv.offsets[:-1][w_ids] if wv.n else 0,
                      (nv.offsets[:-1][n_ids] + wv_bytes.size) if nv.n else 0)
    lens = np.where(is_word, np.diff(wv.offsets)[w_ids] if wv.n else 0,
                    np.diff(nv.offsets)[n_ids] if nv.n else 0)
    total = int(lens.sum())
    if total == 0:
        return b""
    out_off = np.cumsum(lens) - lens  # exclusive prefix sum
    # src[b] = starts[t] + (b - out_off[t]); build it as a cumsum of unit
    # steps with a jump at each nonempty token's first byte.
    nz = np.flatnonzero(lens > 0)
    step = np.ones(total, dtype=np.int64)
    jumps = np.empty(nz.size, dtype=np.int64)
    jumps[0] = starts[nz[0]]
    jumps[1:] = starts[nz[1:]] - (starts[nz[:-1]] + lens[nz[:-1]] - 1)
    step[out_off[nz]] = jumps
    src = np.cumsum(step)
    return pool[src].astype(np.uint8).tobytes()
