"""glz_tpu_torch's host library (utils/native.py) against glz_tpu's and
against the port's numpy references.

Each bound entry runs on seeded inputs through the port's library, through
glz_tpu.utils.native (the same C++ source, built by glz_tpu) and through the
plain version the port keeps (np.bincount, tokenizer.tokenize,
build_vocabs_ref, detokenize_ref, read_crs2_ref); all outputs must be equal.
Then the build: one build and load when two threads ask at once, concurrent
builds that never expose a half-written library, and a failing compiler
that raises instead of falling back to numpy.

Inputs stay under 1 MiB (one histogram thread) but for the four-thread
histogram case.
"""

import subprocess
import threading
import time

import numpy as np
import pytest

from glz_tpu.utils import native as tpu_native

from glz_tpu_torch.compat import glzip_format as port_gz
from glz_tpu_torch.core.codebook import NATIVE_HISTOGRAM_BYTES, histogram_bytes
from glz_tpu_torch.utils import native, tokenizer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def tpu_lib():
    if tpu_native.lib() is None:
        pytest.skip("glz_tpu's native library unavailable (no g++?)")
    return tpu_native


def _text(name: str, text_100kb: bytes, realtext: bytes) -> bytes:
    rng = np.random.default_rng(0x7A7)
    if name == "text":
        return text_100kb[:30_000]
    if name == "realtext":
        return realtext[:200_000]
    if name == "nonword_first":
        return b"  ...  " + text_100kb[:20_000]
    if name == "long_tokens":  # past tokenizer.KEY_BYTES: the dict path of the reference
        longs = [b"x" * n + bytes([97 + n % 26]) * 3 for n in range(20, 60, 3)]
        return b" ".join(longs[i] if i % 3 else b"ab" for i in rng.choice(len(longs), 3_000))
    if name == "big_vocab":  # more than 2^16 distinct words: u32 ids
        words = [f"w{i:05d}".encode() for i in range(70_000)]
        return b" ".join(words[int(i)] for i in rng.permutation(70_000))
    if name == "binaryish":
        p = rng.dirichlet(np.ones(256) * 0.03)
        return rng.choice(256, size=60_000, p=p).astype(np.uint8).tobytes()
    if name == "one_byte":
        return b"q"
    if name == "empty":
        return b""
    raise KeyError(name)


TEXTS = ["text", "realtext", "nonword_first", "long_tokens", "big_vocab", "binaryish",
         "one_byte", "empty"]


@pytest.fixture(params=TEXTS)
def text(request, text_100kb, realtext):
    return _text(request.param, text_100kb, realtext)


# ---- the entries -------------------------------------------------------------------

@pytest.mark.parametrize("threads", [1, 4, None])
def test_histogram(tpu_lib, threads):
    rng = np.random.default_rng(0x415)
    arr = rng.choice(256, size=NATIVE_HISTOGRAM_BYTES, p=rng.dirichlet(np.ones(256) * 0.1))
    arr = arr.astype(np.uint8)
    want = np.bincount(arr, minlength=256).astype(np.int64)
    got = native.histogram(arr, threads=threads)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(tpu_lib.histogram(arr, threads=threads), want)
    assert np.array_equal(histogram_bytes(arr), want)          # the size dispatch
    assert np.array_equal(histogram_bytes(arr[:1000]), np.bincount(arr[:1000], minlength=256))


def test_tokenize(tpu_lib, text):
    arr = np.frombuffer(text, np.uint8)
    bounds, first = native.tokenize(arr)
    tpu_bounds, tpu_first = tpu_lib.tokenize(arr)
    assert np.array_equal(bounds, tpu_bounds) and first == tpu_first
    starts, lengths, word_first = tokenizer.tokenize(arr)
    assert np.array_equal(bounds[:-1].astype(np.int64), starts)
    assert np.array_equal(np.diff(bounds.astype(np.int64)), lengths)
    assert first == word_first


def _same_vocab(got, want):
    assert got.n == want.n
    assert got.blob == want.blob
    assert np.array_equal(got.offsets, want.offsets)
    assert np.array_equal(np.asarray(got.counts, np.int64), np.asarray(want.counts, np.int64))


def test_build_vocabs(tpu_lib, text):
    """The port's native build_vocabs against glz_tpu's (native) and the
    port's numpy build_vocabs_ref: token bounds, word_first, both
    vocabularies (text, token lengths, counts) and the ids."""
    from glz_tpu.utils import tokenizer as tpu_tok

    got = tokenizer.build_vocabs(text)
    for want in (tpu_tok.build_vocabs(text), tokenizer.build_vocabs_ref(text)):
        for k in (0, 1):
            assert np.array_equal(np.asarray(got[k], np.int64), np.asarray(want[k], np.int64))
        assert got[2] == want[2]
        _same_vocab(got[3], want[3])
        _same_vocab(got[4], want[4])
        assert np.array_equal(got[5].astype(np.int64), np.asarray(want[5]).astype(np.int64))
    assert got[5].dtype == np.uint32
    if got[3].n > 0xFFFF:  # the big vocabulary: ids past u16
        assert int(got[5].max()) > 0xFFFF


def test_detokenize(tpu_lib, text):
    _, _, word_first, wv, nv, ids = tokenizer.build_vocabs(text)
    out = tokenizer.detokenize(ids, word_first, wv, nv)
    assert out == text
    assert out == tokenizer.detokenize_ref(ids.astype(np.int64), word_first, wv, nv)
    if ids.size:
        assert out == tpu_lib.detokenize(ids, 0 if word_first else 1, wv.offsets, wv.blob,
                                         nv.offsets, nv.blob)


def test_detokenize_two_halves(tpu_lib):
    """2^20 tokens and more are detokenized in two halves on two threads;
    an odd token count checks the split keeps each token's dictionary."""
    rng = np.random.default_rng(0xD37)
    T = (1 << 20) + 3
    wv = tokenizer.TokenVocab([b"a", b"bb", b"ccc", b"dddd"], np.ones(4, np.int64))
    nv = tokenizer.TokenVocab([b" ", b", ", b".\n"], np.ones(3, np.int64))
    ids = np.empty(T, np.uint32)
    ids[0::2] = rng.integers(0, 4, size=ids[0::2].size)
    ids[1::2] = rng.integers(0, 3, size=ids[1::2].size)
    want = tokenizer.detokenize_ref(ids, True, wv, nv)
    assert tokenizer.detokenize(ids, True, wv, nv) == want
    assert tpu_lib.detokenize(ids, 0, wv.offsets, wv.blob, nv.offsets, nv.blob) == want


def test_detokenize_rejects_ids_past_their_dictionary():
    """An id past its own dictionary (a corrupt container) raises instead
    of reaching the library, which indexes the offsets unchecked."""
    wv = tokenizer.TokenVocab([b"a", b"bb", b"ccc"], np.ones(3, np.int64))
    nv = tokenizer.TokenVocab([b" "], np.ones(1, np.int64))
    assert tokenizer.detokenize(np.array([2, 0, 1], np.uint32), True, wv, nv) == b"ccc bb"
    for ids in ([3, 0, 1], [2, 1, 1]):
        with pytest.raises(ValueError, match="past its dictionary"):
            tokenizer.detokenize(np.array(ids, np.uint32), True, wv, nv)
    assert tokenizer.detokenize(np.array([0, 2], np.uint32), False, wv, nv) == b" ccc"
    with pytest.raises(ValueError, match="past its dictionary"):
        tokenizer.detokenize(np.array([2, 0], np.uint32), False, wv, nv)


@pytest.mark.parametrize("name", ["text", "binaryish", "one_byte", "empty", "runs"])
def test_decode_crs2(tpu_lib, text_100kb, realtext, name):
    """read_crs2 (the host library's decoder, its output grown until the EOF
    symbol) against read_crs2_ref and glz_tpu's decoder on the same tables;
    "runs" decodes to more than four times its payload, past the first
    output buffer."""
    data = b"a" * 200_000 + b"b" if name == "runs" else _text(name, text_100kb, realtext)
    blob = port_gz.write_crs2(data)
    assert port_gz.read_crs2(blob) == data
    assert port_gz.read_crs2_ref(blob) == data
    payload, symbols, fc_lj, start_pos, min_len, max_len = port_gz._crs2_tables(blob)
    syms = np.concatenate([symbols, np.zeros(1024, np.int64)])
    args = (payload, fc_lj.astype(np.uint32), start_pos.astype(np.uint32), syms, min_len,
            max_len)
    cap = len(data) + 1
    got = native.decode_crs2(*args, cap)
    assert got.tobytes() == data
    assert np.array_equal(tpu_lib.decode_crs2(*args, cap), got)
    if name == "runs":  # a short buffer fills up: the caller grows it
        assert native.decode_crs2(*args, 1000).tobytes() == data[:1000]
        assert len(payload) * 4 < len(data)


# ---- the build -----------------------------------------------------------------------

def test_library_builds_once_under_two_threads(monkeypatch, tmp_path):
    """Two threads asking for the library at once (the pipelined batch's
    first files) build and load it once and get the same handle."""
    builds, loads = [], []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return tmp_path / "libfake.so"

    class FakeLib:
        def __init__(self, path):
            loads.append(path)
            for name in native._SIGNATURES:
                setattr(self, name, type("Fn", (), {})())

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "build", slow_build)
    monkeypatch.setattr(native.ctypes, "CDLL", FakeLib)
    start = threading.Barrier(2)
    got = []

    def ask():
        start.wait(timeout=10)
        got.append(native.library())

    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 2 and got[0] is got[1]
    assert got[0].glz_build_vocab.argtypes == native._SIGNATURES["glz_build_vocab"][1]


def test_concurrent_builds_never_expose_a_partial_file(monkeypatch, tmp_path):
    """Six builds at once (six test workers, each with its own lock)
    with a stubbed compiler that writes its output slowly: each compiles in
    a temporary directory and moves the result into place, so the library's
    path holds nothing or the whole file, and no temporary is left."""
    whole = b"\x7fELF" + bytes(range(256)) * 64
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")

    def slow_compile(flags, out):
        with open(out, "wb") as f:
            for k in range(0, len(whole), 4096):
                f.write(whole[k : k + 4096])
                f.flush()
                time.sleep(0.005)
        return subprocess.CompletedProcess(["g++"], 0, "", "")

    monkeypatch.setattr(native, "_compile", slow_compile)
    path = native.library_path()
    seen, done = set(), threading.Event()

    def watch():
        while not done.is_set():
            if path.exists():
                seen.add(path.read_bytes())

    watcher = threading.Thread(target=watch)
    watcher.start()
    start = threading.Barrier(6)
    paths = []

    def build_one():
        start.wait(timeout=10)
        paths.append(native.build())

    builds = [threading.Thread(target=build_one) for _ in range(6)]
    for t in builds:
        t.start()
    for t in builds:
        t.join(timeout=30)
        assert not t.is_alive()
    done.set()
    watcher.join(timeout=10)
    assert not watcher.is_alive()
    assert paths == [path] * 6
    assert path.read_bytes() == whole and seen <= {whole}
    assert [p.name for p in (tmp_path / "build").iterdir()] == [path.name]


def test_failing_compiler_raises(monkeypatch, tmp_path):
    """A source g++ refuses: both attempts (with -march=native, then
    without) fail and build() raises with the compiler's stderr."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    calls = []
    real = native._compile
    monkeypatch.setattr(native, "_compile", lambda flags, out: calls.append(flags)
                        or real(flags, out))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on bad.cpp") as e:
        native.build()
    assert "error" in str(e.value)
    assert len(calls) == 2 and native.NATIVE_ARCH in calls[0] and native.NATIVE_ARCH not in calls[1]
    assert not native.library_path().exists()


def test_no_numpy_fallback(monkeypatch):
    """With no library, the native entries and their callers raise: the
    numpy bodies are references, not a fallback."""
    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "build", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tokenizer.build_vocabs(b"some words here")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        histogram_bytes(np.zeros(NATIVE_HISTOGRAM_BYTES, np.uint8))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port_gz.read_crs2(port_gz.write_crs2(b"abc"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tokenizer.detokenize(np.zeros(2, np.uint32), True,
                             tokenizer.TokenVocab([b"a"], np.ones(1, np.int64)),
                             tokenizer.TokenVocab([b" "], np.ones(1, np.int64)))
