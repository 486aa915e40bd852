"""The one generator of the benchmark's inputs.

A traffic mix is a JSON file in `glzbench/traffic/`: the files a client
sends, each with its size and the name of a byte law, the laws themselves,
and how the client calls the library (`entry`: "file", one compress and one
decompress call per file in turn, or "batch", one call for all the files).
A law is fixed in its file (its alphabet, its probabilities, the seed its
byte distribution is drawn from), so ratio and speed do not wander between
seeds; only the draws come from `--seed`.

Laws (`kind`):
  and        the AND of `draws` uniform bytes: bit i is 1 with probability
             2^-draws, about 4.4 bits a byte for 3 draws (bench_torch.py's
             stand-in for enwik8).
  dirichlet  i.i.d. bytes from one distribution over 256 values, drawn once
             from Dirichlet(`alpha`) with numpy's generator at `law_seed`.
  words      English-like text: words drawn Zipf(`zipf`) from `words`
             distinct words named by `word_format`, each followed by one of
             `separators` drawn uniformly.
Laws over more than two values draw through a table of 2^24 slots, so
each probability is rounded to a multiple of 2^-24.

Everything is vectorised with numpy, so that making a few hundred MB costs
a second or two of set-up.
"""

from __future__ import annotations

import concurrent.futures
import json
import pathlib

import numpy as np

TRAFFIC_DIR = pathlib.Path(__file__).resolve().parent / "traffic"


def load(name: str, traffic_dir: pathlib.Path = TRAFFIC_DIR) -> dict:
    """The traffic file `<name>.json`."""
    path = traffic_dir / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    spec = json.loads(path.read_text())
    if spec.get("entry") not in ("file", "batch"):
        raise ValueError(f"traffic {name!r}: entry must be 'file' or 'batch'")
    for f in spec["files"]:
        if f["law"] not in spec["laws"]:
            raise ValueError(f"traffic {name!r}: file {f['name']!r} names no law of the file")
    return spec


def _rng(seed: int, k: int) -> np.random.Generator:
    """File k's generator: any whole number is a seed, negative ones too."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), k]))


def _and(rng: np.random.Generator, n: int, law: dict) -> np.ndarray:
    out = rng.integers(0, 256, size=n, dtype=np.uint8)
    for _ in range(law["draws"] - 1):
        out &= rng.integers(0, 256, size=n, dtype=np.uint8)
    return out


TABLE_BITS = 24  # draws resolve each law to 2^-24


def _draw(rng: np.random.Generator, p: np.ndarray, n: int, dtype) -> np.ndarray:
    """n i.i.d. draws of indices into p (one uniform 24-bit integer each,
    mapped through a table in which index i fills a share p[i] of 2^24
    slots, rounded)."""
    edges = np.rint(np.cumsum(p) / p.sum() * (1 << TABLE_BITS)).astype(np.int64)
    table = np.repeat(np.arange(p.size, dtype=dtype), np.diff(edges, prepend=0))
    return table[rng.integers(0, 1 << TABLE_BITS, size=n, dtype=np.uint32)]


def _dirichlet(rng: np.random.Generator, n: int, law: dict) -> np.ndarray:
    p = np.random.default_rng(law["law_seed"]).dirichlet(np.full(256, law["alpha"]))
    return _draw(rng, p, n, np.uint8)


def _pool(tokens: list[bytes]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(bytes, offsets, lengths) of a list of tokens laid end to end."""
    lens = np.array([len(t) for t in tokens], np.int64)
    return np.frombuffer(b"".join(tokens), np.uint8), np.cumsum(lens) - lens, lens


def _words(rng: np.random.Generator, n: int, law: dict) -> np.ndarray:
    wpool, woff, wlen = _pool([law["word_format"].format(i).encode()
                               for i in range(law["words"])])
    spool, soff, slen = _pool([s.encode() for s in law["separators"]])
    pool = np.concatenate([wpool, spool])
    soff = soff + wpool.size
    p = (1.0 / np.arange(1, law["words"] + 1)) ** law["zipf"]
    p /= p.sum()
    pair = float(p @ wlen + slen.mean())
    parts, have = [], 0
    while have < n:
        k = int((n - have) / pair * 1.01) + 256
        wi = _draw(rng, p, k, np.int32)
        si = rng.integers(0, slen.size, size=k, dtype=np.int32)
        lens = np.stack([wlen[wi], slen[si]], axis=1).ravel()
        starts = np.stack([woff[wi], soff[si]], axis=1).ravel()
        # byte b of the output is pool[start of its token + b - the token's offset]
        src = np.repeat(starts - (np.cumsum(lens) - lens), lens)
        src += np.arange(src.size)
        parts.append(pool[src])
        have += src.size
    return np.concatenate(parts)[:n]


LAWS = {"and": _and, "dirichlet": _dirichlet, "words": _words}


def make_files(spec: dict, seed: int, scale: float = 1.0) -> list[tuple[str, bytes]]:
    """The traffic's files as (name, bytes), in the file's order, from
    `seed`, made on four threads (each file has a generator of its own, so
    the bytes do not depend on the threads).  A file with `block_bytes` is
    drawn in blocks of that many bytes, block b from a generator of its own,
    so that the threads make one large file together.  `scale` shrinks every
    size (the tests' CPU runs); 1 is the benchmark."""
    jobs = []  # (file, block or None, bytes)
    for k, f in enumerate(spec["files"]):
        n = max(1, int(f["bytes"] * scale))
        step = f.get("block_bytes")
        jobs += ([(k, None, n)] if step is None else
                 [(k, b, min(step, n - b * step)) for b in range(-(-n // step))])

    def one(job: tuple) -> np.ndarray:
        k, b, n = job
        law = spec["laws"][spec["files"][k]["law"]]
        rng = _rng(seed, k) if b is None else np.random.default_rng(
            np.random.SeedSequence([seed % (1 << 64), k, b]))
        return LAWS[law["kind"]](rng, n, law)

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        parts = list(ex.map(one, jobs))
    return [(f["name"], b"".join(p for (j, _, _), p in zip(jobs, parts) if j == k))
            for k, f in enumerate(spec["files"])]
