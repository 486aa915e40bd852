"""The bytes a call returns (utils/fill.py fresh_bytes), on the CPU:
made at their final size, their pages put in place in slices on a pool of
threads (one write a page), then filled by the call's one copy.  The result
is the bytes that tobytes or b"".join would give, at every size and from
any buffers; the population is always joined, also after an exception;
`populated_bytes` counts the results it engaged for, and `host_copy_bytes`
is what it was."""

import concurrent.futures
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import glz_tpu_torch as gt
from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import container
from glz_tpu_torch.models import transfer
from glz_tpu_torch.utils import fill, timer
from tests.torch_threads import one_torch_thread  # noqa: F401

PAGE = fill.PAGE
FLOOR = fill.BULK_FLOOR
SIZES = [0, 1, PAGE - 1, PAGE, PAGE + 1, FLOOR - 1, FLOOR, FLOOR + 1,
         3 * fill.SLICE_BYTES + 12345]


@pytest.fixture
def small_slices(monkeypatch):
    """The mechanism from 0 bytes, in slices of a few pages and an odd
    remainder, so that small results cut into several slices."""
    monkeypatch.setattr(fill, "BULK_FLOOR", 0)
    monkeypatch.setattr(fill, "SLICE_BYTES", 3 * PAGE + 5)


def _data(n: int, seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _parts(n: int, kind: str) -> list:
    """n bytes as one array (host_bytes' part) or as five read-only
    memoryviews that start at odd offsets of their buffers (a container's
    header, codebook, table, payload and tail)."""
    data = _data(n)
    if kind == "array":
        return [data]
    cuts = sorted({0, n, min(n, 32), min(n, 161), max(0, n - 4), n // 2})
    raw = b"\xa5" + data.tobytes()
    return [memoryview(raw)[1 + a : 1 + b].toreadonly() for a, b in zip(cuts, cuts[1:])]


@pytest.mark.parametrize("slices", ["as-set", "small"])
@pytest.mark.parametrize("kind", ["array", "views"])
@pytest.mark.parametrize("n", SIZES)
def test_fill_gives_the_plain_bytes(request, n, kind, slices):
    if slices == "small":
        request.getfixturevalue("small_slices")
    parts = _parts(n, kind)
    want = parts[0].tobytes() if kind == "array" else b"".join(parts)
    with fill.fresh_bytes(n) as dest:
        got = dest.fill(parts)
    assert type(got) is bytes and got == want and len(got) == n


def _address(b: bytes) -> int:
    return fill._bytes_address(b)


@pytest.mark.parametrize("n", [FLOOR, 2 * fill.SLICE_BYTES + 3])
def test_results_are_bytes_that_never_alias(n):
    a, b = _data(n, 1), _data(n, 2)
    with fill.fresh_bytes(n) as d1, fill.fresh_bytes(n) as d2:
        x, y = d1.fill((a,)), d2.fill((b,))
    assert type(x) is bytes and type(y) is bytes and x is not y
    assert _address(x) != _address(y)
    assert x == a.tobytes() and y == b.tobytes()
    with pytest.raises(ValueError):  # filled once: the object is handed out once
        d1.fill((a,))


def test_slices_follow_the_size_and_the_cores(monkeypatch):
    """One copy slice per SLICE_BYTES, up to the cores and MAX_SLICES; the
    population in as many slices, up to MAX_POPULATE."""
    monkeypatch.setattr(fill, "_populate", lambda *args: None)
    monkeypatch.setattr(fill, "BULK_FLOOR", 0)
    one = fill.SLICE_BYTES
    for cores, n, copy, populate in [(8, 100_000_000, 4, 2), (2, 100_000_000, 2, 2),
                                     (8, 3 * one + 1, 3, 2), (8, one, 1, 1),
                                     (8, 2 * one - 1, 1, 1), (1, 50_000_000, 1, 1)]:
        monkeypatch.setattr(fill.os, "sched_getaffinity", lambda pid, c=cores: set(range(c)))
        with fill.fresh_bytes(n) as dest:
            assert (dest._k, len(dest._jobs)) == (copy, populate)


def test_population_writes_each_page_once_and_the_bytes_are_the_same(monkeypatch,
                                                                      small_slices):
    """Each population slice is a run of whole pages inside the result, the
    slices do not overlap, and the fill over them gives the plain bytes."""
    touched = []
    real_populate = fill._populate

    def recorded(obj, view, lo, hi):
        touched.append((lo, hi, view.ctypes.data))
        real_populate(obj, view, lo, hi)

    monkeypatch.setattr(fill, "_populate", recorded)
    monkeypatch.setattr(fill.os, "sched_getaffinity", lambda pid: set(range(8)))
    n = 20 * PAGE + 77
    parts = _parts(n, "views")
    with fill.fresh_bytes(n) as dest:
        got = dest.fill(parts)
    assert got == b"".join(parts)
    assert len(touched) == fill.MAX_POPULATE
    spans = sorted((lo, hi) for lo, hi, _ in touched)
    assert all(0 <= lo < hi <= n for lo, hi in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert all((base + lo) % PAGE == 0 and (hi - lo) % PAGE == 0 for lo, hi, base in touched)


def test_an_exception_before_the_fill_leaves_no_population_running(monkeypatch):
    started = threading.Event()
    real_populate = fill._populate

    def slow(obj, view, lo, hi):
        started.set()
        time.sleep(0.2)
        real_populate(obj, view, lo, hi)

    monkeypatch.setattr(fill, "_populate", slow)
    with pytest.raises(RuntimeError, match="between start and fill"):
        with fill.fresh_bytes(2 * fill.SLICE_BYTES) as dest:
            jobs = list(dest._jobs)
            assert started.wait(5)
            raise RuntimeError("between start and fill")
    assert jobs and all(job.done() for job in jobs)
    assert all(job.exception() is None for job in jobs)


@pytest.mark.parametrize("n", [FLOOR - 1, FLOOR, 2 * FLOOR + 1])
def test_populated_bytes_counts_the_results_above_the_floor(n):
    """On `serialize` (host_bytes) and `container.write`: the result's size
    from the floor up, nothing below it; `host_copy_bytes` the same either
    way."""
    data = _data(n)
    f = container.GlzFile(mode=cfg.MODE_BYTE, n_symbols=n, stream_symbols=64,
                          stream_bits=np.zeros(3, np.uint64), codebook_blob=b"\x00" * 129,
                          payload=memoryview(data.tobytes())[1:], checksum=5)
    with timer.recording() as spans:
        with fill.fresh_bytes(n) as dest:
            out = transfer.host_bytes(torch.from_numpy(data), dest)
        blob = container.write_container(f)
    assert out == data.tobytes()
    assert container.read_container(blob).payload == f.payload
    counts = {r.name: r.counts for r in spans if r.name in ("serialize", "container.write")}
    bulk = n >= FLOOR
    assert counts["serialize"] == {timer.HOST_COPY_BYTES: n,
                                   **({timer.POPULATED_BYTES: n} if bulk else {})}
    big = len(blob) >= FLOOR
    assert counts["container.write"] == {timer.HOST_COPY_BYTES: len(blob),
                                         **({timer.POPULATED_BYTES: len(blob)} if big else {})}


LOCKSTEP = cfg.GlzConfig(stream_symbols=64, layout=cfg.LAYOUT_LOCKSTEP, group_rows=8)


def _span_counts(conf, data: bytes, backend: str = "host") -> tuple[bytes, dict]:
    with timer.recording() as spans:
        blob = gt.compress(data, conf=conf, backend=backend, device="cpu")
        assert gt.decompress(blob, device="cpu") == data
    counts: dict = {}
    for r in spans:
        for k, v in r.counts.items():
            key = (r.name, k)
            counts[key] = counts.get(key, 0) + v
    return blob, counts


@pytest.mark.parametrize("conf,backend", [(LOCKSTEP, "host"), (cfg.DEFAULT, "host"),
                                          (cfg.DEFAULT, "device")],
                         ids=["lockstep", "bitstream-host", "bitstream-device"])
def test_round_trips_count_host_copies_as_before(monkeypatch, conf, backend):
    """A CPU round trip through fresh pages (from 0 bytes, in small slices)
    writes the container of the plain copies and counts `host_copy_bytes`
    span for span as they do; `populated_bytes` is the container on
    `container.write` and the output on `serialize`."""
    data = (_data(70001, 3) & _data(70001, 4)).tobytes()
    monkeypatch.setattr(fill, "BULK_FLOOR", 1 << 62)
    plain_blob, plain = _span_counts(conf, data, backend)
    monkeypatch.setattr(fill, "BULK_FLOOR", 0)
    monkeypatch.setattr(fill, "SLICE_BYTES", 3 * PAGE + 5)
    blob, fresh = _span_counts(conf, data, backend)
    assert blob == plain_blob
    populated = {k: fresh.pop(k) for k in list(fresh) if k[1] == timer.POPULATED_BYTES}
    assert fresh == plain
    assert populated == {("container.write", timer.POPULATED_BYTES): len(blob),
                         ("serialize", timer.POPULATED_BYTES): len(data)}
    assert plain[("serialize", timer.HOST_COPY_BYTES)] >= len(data)
    assert plain[("container.write", timer.HOST_COPY_BYTES)] == len(blob)


def test_the_pool_is_idle_after_every_call(small_slices):
    """No slice outlives its call: after a round trip the pool runs none."""
    data = _data(50_000).tobytes()
    blob = gt.compress(data, conf=LOCKSTEP, device="cpu")
    assert gt.decompress(blob, device="cpu") == data
    pool = fill._executor()
    probe = pool.submit(lambda: None)
    concurrent.futures.wait([probe], timeout=5)
    assert probe.done() and pool._work_queue.qsize() == 0



@pytest.mark.filterwarnings("ignore:This process .* is multi-threaded")
def test_a_forked_child_makes_its_own_pool():
    """A child forked after the pool has run fills with threads of its own
    (the parent's are not in it)."""
    n = 2 * fill.SLICE_BYTES + 1
    with fill.fresh_bytes(n) as dest:
        dest.fill((_data(n),))
    want = _data(n, 9)
    pid = os.fork()
    if pid == 0:
        ok = False
        try:
            with fill.fresh_bytes(n) as dest:
                ok = dest.fill((want,)) == want.tobytes()
        finally:
            os._exit(0 if ok else 1)
    deadline = time.monotonic() + 60
    while (done := os.waitpid(pid, os.WNOHANG))[0] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    if done[0] == 0:
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)
        pytest.fail("the forked child did not fill within 60 s")
    assert os.waitstatus_to_exitcode(done[1]) == 0
