"""The model layer's payload-sized copies from the device
(models/transfer.py host_array), on the CPU: every such copy of each
path goes through host_array, and on a CPU tensor host_array is `.cpu()`:
the tensor's own storage, no copy and nothing counted (`d2h_bytes`,
`d2h_pinned_bytes` and `host_copy_bytes` count only what the card sends).
The page-locked staging itself runs on the card (tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

import glz_tpu_torch as gt
from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import container
from glz_tpu_torch.models import transfer
from glz_tpu_torch.utils import timer
from tests.torch_threads import one_torch_thread  # noqa: F401

LOCKSTEP = cfg.GlzConfig(stream_symbols=64, layout=cfg.LAYOUT_LOCKSTEP, group_rows=8)
COUNTERS = (timer.D2H_BYTES, timer.D2H_PINNED_BYTES, timer.HOST_COPY_BYTES)
# name: (mode, conf, backend)
PATHS = {
    "byte-lockstep": (cfg.MODE_BYTE, LOCKSTEP, "host"),
    "byte-bitstream-host": (cfg.MODE_BYTE, cfg.DEFAULT, "host"),
    "byte-bitstream-device": (cfg.MODE_BYTE, cfg.DEFAULT, "device"),
    "huffword-lockstep": (cfg.MODE_HUFFWORD, LOCKSTEP, "host"),
    "huffword-bitstream": (cfg.MODE_HUFFWORD, cfg.DEFAULT, "host"),
}


def corpus(mode: int, n: int = 70001) -> bytes:
    if mode == cfg.MODE_HUFFWORD:
        return (b"the cat-sat on its mat, a dog by the door. " * (n // 43 + 1))[:n]
    rng = np.random.default_rng(11)
    return (rng.integers(0, 256, n, dtype=np.uint8) & rng.integers(0, 256, n, dtype=np.uint8)
            ).tobytes()


@pytest.mark.parametrize("make", [
    lambda: torch.arange(1000, dtype=torch.uint8),
    lambda: torch.arange(-500, 500, dtype=torch.int16),
    lambda: torch.arange(1 << 16, dtype=torch.int32),
    lambda: torch.arange(4096, dtype=torch.int32)[100:3000],
], ids=["uint8", "int16", "int32", "int32-slice"])
def test_host_array_on_the_cpu_is_cpus_own_storage(make):
    t = make()
    before = timer.totals()
    with timer.recording() as spans, timer.span("d2h"):
        got = transfer.host_array(t)
    want = t.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.__array_interface__["data"] == want.__array_interface__["data"]
    assert np.array_equal(got, want)
    assert [r.counts for r in spans] == [{}]
    assert {k: timer.totals().get(k, 0) for k in COUNTERS} == {
        k: before.get(k, 0) for k in COUNTERS}


@pytest.fixture
def d2h_calls(monkeypatch):
    """Every host_array call of the model layer, as (dtype, bytes): one
    patch of the transfer module sees them all."""
    calls = []
    real = transfer.host_array

    def recorded(t):
        calls.append((t.dtype, t.numel() * t.element_size()))
        return real(t)

    monkeypatch.setattr(transfer, "host_array", recorded)
    return calls


@pytest.mark.parametrize("path", list(PATHS))
def test_each_payload_sized_copy_goes_through_host_array(path, d2h_calls):
    mode, conf, backend = PATHS[path]
    data = corpus(mode)
    blob = gt.compress(data, mode=mode, conf=conf, backend=backend, device="cpu")
    compressed = list(d2h_calls)
    d2h_calls.clear()
    assert gt.decompress(blob, device="cpu") == data
    f = container.read_container(blob)
    # compress: the payload's words, once (a single dispatch)
    assert [n for _, n in compressed] == [-(-len(f.payload) // 4) * 4]
    if mode == cfg.MODE_BYTE:  # decompress: the output
        assert d2h_calls == [(torch.uint8, len(data))]
    else:  # decompress: the token ids, as u16
        assert d2h_calls == [(torch.int16, 2 * f.n_symbols)]


@pytest.mark.parametrize("path", list(PATHS))
def test_a_cpu_round_trip_counts_no_d2h(path):
    mode, conf, backend = PATHS[path]
    data = corpus(mode)
    before = timer.totals()
    with timer.recording() as spans:
        blob = gt.compress(data, mode=mode, conf=conf, backend=backend, device="cpu")
        assert gt.decompress(blob, device="cpu") == data
    d2h = [r for r in spans if r.name == "d2h"]
    assert len(d2h) == 2 and all(r.counts == {} for r in d2h)
    assert not [r for r in spans if {timer.D2H_BYTES, timer.D2H_PINNED_BYTES} & set(r.counts)]
    after = timer.totals()
    assert after.get(timer.D2H_BYTES, 0) == before.get(timer.D2H_BYTES, 0)
    assert after.get(timer.D2H_PINNED_BYTES, 0) == before.get(timer.D2H_PINNED_BYTES, 0)
