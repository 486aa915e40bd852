"""The generator: the traffic files' laws, repeated for a seed and changed
with it."""

import numpy as np
import pytest

from glzbench import traffic

NAMES = ("and3-100MB", "words-10MB", "silesia-sizes", "silesia-sizes-batch", "enwik9")


@pytest.mark.parametrize("name", NAMES)
def test_files_repeat_for_a_seed_and_change_with_it(name):
    spec = traffic.load(name)
    a = traffic.make_files(spec, 2**31 + 11, scale=1e-3)
    assert a == traffic.make_files(spec, 2**31 + 11, scale=1e-3)
    b = traffic.make_files(spec, 2**31 + 12, scale=1e-3)
    assert [n for n, _ in a] == [n for n, _ in b] == [f["name"] for f in spec["files"]]
    assert all(x != y for (_, x), (_, y) in zip(a, b))
    assert [len(d) for _, d in a] == [int(f["bytes"] * 1e-3) for f in spec["files"]]


def test_any_whole_number_seeds():
    spec = traffic.load("and3-100MB")
    for seed in (0, -1, 2**31 + 3, 2**63 + 5):
        assert len(traffic.make_files(spec, seed, scale=1e-5)[0][1]) == 1000


def test_a_file_is_one_generator_unless_it_names_blocks():
    """A file without block_bytes is one generator's draw, as it always was;
    one with it is drawn block by block, each block its own generator's,
    whatever the threads."""
    spec = traffic.load("and3-100MB")
    law = spec["laws"]["and3"]
    data = traffic.make_files(spec, 2**31 + 5, scale=1e-3)[0][1]
    assert data == traffic._and(traffic._rng(2**31 + 5, 0), 100_000, law).tobytes()
    blocked = dict(spec, files=[dict(spec["files"][0], block_bytes=30_000)])
    data = traffic.make_files(blocked, 2**31 + 5, scale=1e-3)[0][1]
    blocks = [traffic._and(np.random.default_rng(np.random.SeedSequence([2**31 + 5, 0, b])),
                           min(30_000, 100_000 - 30_000 * b), law).tobytes() for b in range(4)]
    assert data == b"".join(blocks)
    assert traffic.load("enwik9")["files"][0]["block_bytes"] == 1 << 24


def test_the_and_law_sets_each_bit_one_time_in_eight():
    data = np.frombuffer(traffic.make_files(traffic.load("and3-100MB"), 7, scale=1e-3)[0][1],
                         np.uint8)
    ones = np.unpackbits(data).reshape(-1, 8).mean(axis=0)
    assert np.allclose(ones, 1 / 8, atol=0.01)


def test_the_word_law_writes_words_and_separators():
    text = traffic.make_files(traffic.load("words-10MB"), 7, scale=1e-2)[0][1]
    tokens = text.replace(b". ", b" ").replace(b", ", b" ").replace(b"\n", b" ").split(b" ")
    words = [t for t in tokens[1:-1]]
    assert words and all(t.startswith(b"w") and int(t[1:], 16) < 20000 for t in words)
    counts = np.bincount([int(t[1:], 16) for t in words])
    assert counts[0] > counts[1] > counts[9]  # Zipf: the first words are the most common


def test_a_dirichlet_law_is_fixed_by_its_law_seed():
    spec = traffic.load("silesia-sizes")
    k = [f["name"] for f in spec["files"]].index("mozilla")
    one = np.frombuffer(traffic.make_files(spec, 1, scale=0.02)[k][1], np.uint8)
    two = np.frombuffer(traffic.make_files(spec, 2, scale=0.02)[k][1], np.uint8)
    h1, h2 = np.bincount(one, minlength=256), np.bincount(two, minlength=256)
    assert (one != two).any()
    assert np.abs(h1 / one.size - h2 / two.size).max() < 0.01


def test_a_traffic_file_naming_no_law_is_refused(tmp_path):
    (tmp_path / "bad.json").write_text('{"entry": "file", "laws": {}, '
                                       '"files": [{"name": "x", "bytes": 1, "law": "y"}]}')
    with pytest.raises(ValueError):
        traffic.load("bad", tmp_path)
    with pytest.raises(FileNotFoundError):
        traffic.load("none", tmp_path)
