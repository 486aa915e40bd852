"""Every reader of GlzFile.payload on a parsed container, whose payload is a
read-only view of the caller's blob (core/container.py), on the CPU: each
path round-trips with its input and its container given as bytes,
bytearray or memoryview, and writes the same container whatever the
input's type.  The byte containers have a 129-byte codebook, so their
payload starts at an offset that is not a multiple of 4."""

import struct

import numpy as np
import pytest

import glz_tpu_torch as gt
from glz_tpu_torch import cli
from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import api, container
from glz_tpu_torch.parallel import multihost
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOCKSTEP = cfg.GlzConfig(stream_symbols=64, layout=cfg.LAYOUT_LOCKSTEP, group_rows=8)
KINDS = {"bytes": bytes, "bytearray": bytearray, "memoryview": lambda b: memoryview(bytes(b))}


def corpus(n: int, seed: int = 5) -> bytes:
    """The sum of two uniform draws from 0-63: codes of at most 15 bits, so a
    byte container's codebook is 129 bytes."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, n, dtype=np.uint8) + rng.integers(0, 64, n, dtype=np.uint8)
            ).tobytes()


TEXT = b"the cat-sat on its mat; a dog ran. " * 2000
BYTES = corpus(2 * 8 * 128 * 64 + 4321)  # three lockstep groups, the last one short
SMALL = corpus(6000, seed=9)


def api_case(data, **kw):
    return data, lambda d: gt.compress(d, device="cpu", **kw), \
        lambda b: gt.decompress(b, device="cpu")


def archive_case():
    datas = [BYTES[:70000], BYTES[70000:]]
    return datas, lambda ds: api.compress_archive(ds, conf=LOCKSTEP, device="cpu"), \
        lambda b: api.decompress_archive(b, device="cpu")


def multihost_case(mode):
    """One process: the multi-process entry points' own parse and split."""
    if mode == cfg.MODE_BYTE:
        return BYTES, lambda d: multihost.compress_bytes_multihost(d, conf=LOCKSTEP,
                                                                   device="cpu"), \
            lambda b: multihost.decompress_bytes_multihost(b, device="cpu")[0]
    return TEXT, lambda d: multihost.compress_huffword_multihost(d, conf=LOCKSTEP,
                                                                 device="cpu"), \
        lambda b: multihost.decompress_huffword_multihost(b, device="cpu")[0]


CASES = {
    "byte-lockstep": lambda: api_case(BYTES, conf=LOCKSTEP),
    "byte-bitstream-host": lambda: api_case(BYTES, backend="host"),
    "byte-bitstream-device": lambda: api_case(BYTES, backend="device"),
    "huffword-lockstep": lambda: api_case(TEXT, mode=cfg.MODE_HUFFWORD, conf=LOCKSTEP),
    "huffword-bitstream": lambda: api_case(TEXT, mode=cfg.MODE_HUFFWORD),
    "normal-tree": lambda: api_case(SMALL, mode=cfg.MODE_NORMAL_TREE),
    "archive": archive_case,
    "multihost-byte": lambda: multihost_case(cfg.MODE_BYTE),
    "multihost-huffword": lambda: multihost_case(cfg.MODE_HUFFWORD),
}


def typed(kind, data):
    return [kind(d) for d in data] if isinstance(data, list) else kind(data)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("case", list(CASES))
def test_each_reader_round_trips_a_view_payload(case, kind):
    data, compress, decompress = CASES[case]()
    blob = compress(typed(KINDS[kind], data))
    assert isinstance(blob, bytes) and blob == compress(typed(bytes, data))
    assert decompress(KINDS[kind](blob)) == data
    if case.startswith("byte-") or case == "multihost-byte":
        n_streams, _, cb_size = struct.unpack_from("<III", blob, 16)
        assert cb_size == 129
        f = container.read_container(KINDS[kind](blob))
        assert len(blob) - len(f.payload) == container.HEADER_SIZE + cb_size + 4 * n_streams
        assert (container.HEADER_SIZE + cb_size) % 4  # the payload lies unaligned


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("case", ["byte-lockstep", "huffword-lockstep", "normal-tree"])
def test_cli_info_reads_a_view_payload(case, kind, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("GLZ_PLATFORM", "cpu")
    data, compress, _ = CASES[case]()
    blob = compress(data)
    path = tmp_path / "f.glz"
    path.write_bytes(blob)
    argv = ["info", str(path), "--stats"]
    if case == "normal-tree":
        argv += ["--dot", str(tmp_path / "f.dot")]
    assert cli.main(argv) == 0
    want = capsys.readouterr().out
    monkeypatch.setattr(cli, "_read", lambda p: KINDS[kind](open(p, "rb").read()))
    assert cli.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want and f"payload={len(container.read_container(blob).payload)}B" in got
