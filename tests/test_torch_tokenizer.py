"""glz_tpu_torch's HuffWord tokenizer against glz_tpu's.

Token ids, vocabulary order and token text decide the container's bytes,
so every output is compared exactly.  Both packages build vocabularies and
detokenize with their native C++ library; tests/test_torch_native.py also
holds the port's numpy references (build_vocabs_ref, detokenize_ref).
"""

import numpy as np
import pytest

from glz_tpu.utils import tokenizer as tpu_tok

from glz_tpu_torch.utils import tokenizer as port_tok
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _inputs(name, text_1mb, realtext, rng):
    if name == "text_1mb":
        return text_1mb
    if name == "realtext":
        return realtext
    if name == "binaryish":
        p = rng.dirichlet(np.ones(256) * 0.03)
        return rng.choice(256, size=60_000, p=p).astype(np.uint8).tobytes()
    if name == "nonword_first":
        return b"  ...  " + text_1mb[:30_000]
    if name == "long_tokens":
        # words past KEY_BYTES = 23 go through the dict path, some repeated
        longs = [b"x" * n + bytes([97 + n % 26]) * 3 for n in range(20, 60, 3)]
        picks = rng.choice(len(longs), size=3_000)
        return b" ".join(longs[i] if i % 3 else b"ab" for i in picks)
    if name == "glued":
        return (b"he's pku-online snake_case a--b c__d 'x- -y _z_ e'f-g_h "
                b"it''s -- ' _ -lead trail- x'y'z " * 500)
    if name == "empty":
        return b""
    if name == "one_byte":
        return b"q"
    raise KeyError(name)


CASES = ["text_1mb", "realtext", "binaryish", "nonword_first", "long_tokens",
         "glued", "empty", "one_byte"]


@pytest.fixture(params=CASES)
def data(request, text_1mb, realtext):
    return _inputs(request.param, text_1mb, realtext, np.random.default_rng(0x70C))


def _same_vocab(got, want):
    assert got.n == want.n
    assert got.blob == want.blob
    assert np.array_equal(got.offsets, want.offsets)
    assert np.array_equal(np.asarray(got.counts, np.int64), np.asarray(want.counts, np.int64))


def test_build_vocabs_matches_reference(data):
    got = port_tok.build_vocabs(data)
    want = tpu_tok.build_vocabs(data)
    for k in (0, 1):  # starts, lengths
        assert np.array_equal(np.asarray(got[k], np.int64), np.asarray(want[k], np.int64))
    assert got[2] == want[2]  # word_first
    _same_vocab(got[3], want[3])
    _same_vocab(got[4], want[4])
    assert np.array_equal(got[5].astype(np.int64), np.asarray(want[5]).astype(np.int64))


def test_tokenize_matches_reference(data):
    arr = np.frombuffer(data, np.uint8)
    if arr.size:
        assert np.array_equal(port_tok.wordlike_mask(arr), tpu_tok.wordlike_mask(arr))
    got, want = port_tok.tokenize(data), tpu_tok.tokenize(data)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_detokenize_matches_reference(data):
    _, _, word_first, wv, nv, ids = port_tok.build_vocabs(data)
    out = port_tok.detokenize(ids, word_first, wv, nv)
    assert out == data
    assert out == tpu_tok.detokenize(ids, word_first, wv, nv)


def test_merge_vocab_parts_matches_reference(text_1mb, realtext):
    """Three files' vocabularies (text, real text, long tokens) merged into
    one union, per class."""
    rng = np.random.default_rng(0x70D)
    files = [text_1mb[:200_000], realtext[:300_000],
             _inputs("long_tokens", text_1mb, realtext, rng), b""]
    per = [port_tok.build_vocabs(d) for d in files]
    for cls in (3, 4):
        blobs = [np.frombuffer(p[cls].blob, np.uint8) for p in per]
        lens = [np.diff(p[cls].offsets) for p in per]
        counts = [p[cls].counts for p in per]
        got, got_maps = port_tok.merge_vocab_parts(blobs, lens, counts)
        want, want_maps = tpu_tok.merge_vocab_parts(blobs, lens, counts)
        _same_vocab(got, want)
        assert got.tokens == want.tokens
        assert all(np.array_equal(a, b) for a, b in zip(got_maps, want_maps))
    empty, maps = port_tok.merge_vocab_parts([b"", b""], [[], []], [[], []])
    assert empty.n == 0 and all(m.size == 0 for m in maps)


def test_token_vocab_from_parts():
    v = port_tok.TokenVocab.from_parts(b"abcde", np.array([2, 3]), None)
    assert v.n == 2 and v.tokens == [b"ab", b"cde"] and v.index == {b"ab": 0, b"cde": 1}
