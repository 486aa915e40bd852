"""glz_tpu_torch.parallel.mesh against glz_tpu.parallel.mesh:
tests/test_sharding.py's nine cases, exactly (integer data, tolerance 0).

The port runs each case in 4 gloo ranks (a 2 x 2 mesh for the 2-axis
cases), spawned once for the module (_rank_cases); glz_tpu runs the same
inputs in this process on make_mesh(4) / (2, 2) of the 8 virtual CPU
devices.  Also: the dry run on 4 CPU ranks against __graft_entry__.py's
numbers, and the plain histogram against glz_tpu's two device histograms.

This file is also the ranks' module: keep its top-level imports free of
glz_tpu (JAX), which the ranks do not need.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

from glz_tpu_torch.core.codebook import build_codebook
from glz_tpu_torch.models.canonical_byte import decode_tables, entry_table
from glz_tpu_torch.models.transfer import i32_tensor
from glz_tpu_torch.ops import histogram as hist_ops
from glz_tpu_torch.ops import lockstep_encode as ke
from glz_tpu_torch.parallel import dryrun, mesh as pmesh, multihost, ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_DEV = 4
CPU = torch.device("cpu")


def _setup(n, seed=0):
    """tests/test_sharding.py's inputs: 6-bit symbols and their codebook."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 64, size=n, dtype=np.uint8)
    return data, build_codebook(np.bincount(data, minlength=256).astype(np.int64))


def _stride_bound_setup():
    rng = np.random.default_rng(0x5B)
    data = rng.integers(0, 64, size=8 * 1024 * 64, dtype=np.uint8)
    return data, build_codebook(np.bincount(data, minlength=256).astype(np.int64), 26)


# case -> (S, seed, axes) of the lockstep mesh cases (rows 8: one group a rank)
LOCKSTEP = {"lockstep_1d": (64, 5, 1), "lockstep_2d": (64, 6, 2), "lockstep_single": (64, 7, 1)}
# case -> (S, seed, axes) of the codec steps
CODEC = {"codec_1d": (256, 1, 1), "codec_2d": (128, 2, 2)}


def _shard(mesh, data: np.ndarray) -> torch.Tensor:
    n = data.size // N_DEV
    i = pmesh._flat_device_index(mesh)
    return torch.from_numpy(data[i * n : (i + 1) * n].copy())


def _np(*ts):
    return tuple(t.numpy() if isinstance(t, torch.Tensor) else t for t in ts)


def _rank_cases() -> dict:
    """Every case on this rank (run by ranks.run in N_DEV gloo processes)."""
    meshes = {1: pmesh.make_mesh(N_DEV, device="cpu"),
              2: pmesh.make_mesh(N_DEV, axis_names=("data", "stream"), shape=(2, 2),
                                 device="cpu")}
    res = {}
    data, _ = _setup(8 * 4096)
    res["histogram"] = pmesh.sharded_histogram(meshes[1], _shard(meshes[1], data)).numpy()
    for name, (S, seed, axes) in CODEC.items():
        data, cb = _setup(N_DEV * 2 * S, seed)
        mesh = meshes[axes]
        res[name] = _np(*pmesh.codec_step(
            mesh, _shard(mesh, data), data.size, i32_tensor(cb.left_justified_codes(), CPU),
            i32_tensor(cb.lengths, CPU), *decode_tables(cb, CPU), cb.min_len, cb.max_len, S))
    data, cb = _setup(N_DEV * 2 * 512, seed=3)
    res["encode"] = _np(*pmesh.sharded_encode(
        meshes[1], _shard(meshes[1], data), data.size,
        i32_tensor(cb.left_justified_codes(), CPU), i32_tensor(cb.lengths, CPU), 512))
    for name, (S, seed, axes) in LOCKSTEP.items():
        data, cb = _setup(N_DEV * 1024 * S, seed)
        mesh = meshes[axes]
        res[name] = _np(*pmesh.lockstep_codec_step(
            mesh, _shard(mesh, data), data.size - 1234, entry_table(cb, CPU),
            *decode_tables(cb, CPU), S, cb.min_len, cb.max_len))
    data, cb = _stride_bound_setup()
    args = (meshes[1], _shard(meshes[1], data), data.size, entry_table(cb, CPU),
            *decode_tables(cb, CPU), 64, cb.min_len, cb.max_len)
    res["stride_12"] = _np(*pmesh.lockstep_codec_step(*args, max_bits_per_symbol=12))
    try:
        pmesh.lockstep_codec_step(*args, max_bits_per_symbol=1)
        res["stride_1"] = None
    except ValueError as e:
        res["stride_1"] = str(e)
    return res


def _reference() -> dict:
    """glz_tpu on 4 of the 8 virtual devices, the same inputs."""
    import jax.numpy as jnp

    from glz_tpu.ops import pallas_decode as pd
    from glz_tpu.parallel import mesh as tmesh

    meshes = {1: tmesh.make_mesh(N_DEV),
              2: tmesh.make_mesh(N_DEV, axis_names=("data", "stream"), shape=(2, 2))}
    ref = {}
    data, _ = _setup(8 * 4096)
    ref["histogram"] = np.asarray(tmesh.sharded_histogram(meshes[1], jnp.asarray(data)))
    for name, (S, seed, axes) in CODEC.items():
        data, cb = _setup(N_DEV * 2 * S, seed)
        luts = tuple(jnp.asarray(x.astype(np.uint32)) for x in cb.decode_luts(12))
        words, total, sbits, out = tmesh.codec_step(
            meshes[axes], jnp.asarray(data), jnp.int32(data.size),
            jnp.asarray(cb.codewords, dtype=jnp.uint32), jnp.asarray(cb.lengths, jnp.int32),
            luts, stream_symbols=S, table_bits=12)
        out = np.asarray(out)
        ref[name] = (np.asarray(words), np.asarray(total), np.asarray(sbits),
                     np.concatenate([out[d].T.reshape(-1) for d in range(N_DEV)]))
    data, cb = _setup(N_DEV * 2 * 512, seed=3)
    ref["encode"] = tuple(np.asarray(x) for x in tmesh.sharded_encode(
        meshes[1], jnp.asarray(data), jnp.int32(data.size),
        jnp.asarray(cb.codewords, dtype=jnp.uint32), jnp.asarray(cb.lengths, jnp.int32), 512))

    def lockstep(mesh, data, n_valid, cb, S, **kw):
        entry = jnp.asarray(cb.left_justified_codes() | cb.lengths.astype(np.uint32))
        symtab = np.zeros(256, np.uint32)
        symtab[: cb.symbols.size] = cb.symbols
        payload, gw_all, out = tmesh.lockstep_codec_step(
            mesh, jnp.asarray(data), n_valid, entry,
            jnp.asarray(cb.first_code_left_justified()), jnp.asarray(cb.decode_offsets()),
            jnp.asarray(symtab), S, cb.min_len, cb.max_len, **kw)
        return (np.asarray(payload).reshape(-1), np.asarray(gw_all),
                np.asarray(pd.unpack_symbols(out, S))[:n_valid])

    for name, (S, seed, axes) in LOCKSTEP.items():
        data, cb = _setup(N_DEV * 1024 * S, seed)
        ref[name] = lockstep(meshes[axes], data, data.size - 1234, cb, S)
    data, cb = _stride_bound_setup()
    ref["stride_12"] = lockstep(meshes[1], data, data.size, cb, 64, max_bits_per_symbol=12)
    return ref


@pytest.fixture(scope="module")
def results():
    """(port: one dict a rank, glz_tpu's dict); the ranks run while glz_tpu
    computes."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        port = ex.submit(ranks.run, f"{__file__}:_rank_cases", N_DEV, timeout=400, threads=1)
        ref = _reference()
        return port.result(), ref


def _segments(payload: np.ndarray, gw: np.ndarray) -> list[np.ndarray]:
    """Each group's first gw words of a fixed-stride payload."""
    stride = payload.size // gw.size
    return [payload[g * stride : g * stride + int(gw[g])].view(np.uint32)
            for g in range(gw.size)]


def test_sharded_histogram(results):
    port, ref = results
    data, _ = _setup(8 * 4096)
    want = np.bincount(data, minlength=256)
    for r in port:
        assert r["histogram"].dtype == np.int64
        assert np.array_equal(r["histogram"], want)
    assert np.array_equal(ref["histogram"], want)


def _check_codec_step(port, ref, name):
    S, seed, _ = CODEC[name]
    data, _ = _setup(N_DEV * 2 * S, seed)
    assert np.array_equal(np.concatenate([r[name][3] for r in port]), data)
    assert np.array_equal(ref[name][3], data)
    words, total, sbits, _ = ref[name]
    for d, r in enumerate(port):
        assert r[name][1] == int(total[d])
        assert np.array_equal(r[name][2], sbits[d].astype(np.int64))
        assert np.array_equal(r[name][0].view(np.uint32), words[d][: -(-int(total[d]) // 32)])


def test_sharded_codec_step_roundtrip(results):
    _check_codec_step(*results, "codec_1d")


def test_sharded_codec_step_2d_mesh(results):
    _check_codec_step(*results, "codec_2d")


def test_sharded_encode_matches_single_device(results):
    """The shards' stream tables are the host encoder's over the whole
    input; their words are glz_tpu's, trimmed to the shards' bits."""
    from glz_tpu.core.codebook import build_codebook as tpu_build_codebook
    from glz_tpu.core.host_codec import encode_streams

    port, ref = results
    data, _ = _setup(N_DEV * 2 * 512, seed=3)
    _, h_total, h_bits = encode_streams(
        data, tpu_build_codebook(np.bincount(data, minlength=256).astype(np.int64)), 512)
    assert np.array_equal(np.concatenate([r["encode"][2] for r in port]),
                          h_bits.astype(np.int64))
    assert sum(r["encode"][1] for r in port) == h_total
    words, total, _ = ref["encode"]
    for d, r in enumerate(port):
        assert np.array_equal(r["encode"][0].view(np.uint32),
                              words[d][: -(-int(total[d]) // 32)])


def _check_lockstep(port, ref, name, data, n_valid):
    p_gw = port[0][name][1]
    for r in port:
        assert np.array_equal(r[name][1], p_gw)  # every rank holds the whole table
    assert np.array_equal(p_gw, ref[name][1])
    assert int(p_gw.sum()) > 0 and p_gw.size == data.size // (1024 * 64)
    local = p_gw.size // N_DEV
    got = [seg for d, r in enumerate(port)
           for seg in _segments(r[name][0], p_gw[d * local : (d + 1) * local])]
    want = _segments(ref[name][0], ref[name][1])
    assert len(got) == len(want) == p_gw.size
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(np.concatenate([r[name][2] for r in port]), data[:n_valid])
    assert np.array_equal(ref[name][2], data[:n_valid])


def test_lockstep_mesh_roundtrip(results):
    """The lockstep kernels on the mesh: groups sharded across 4 ranks, the
    codebook on every rank, the group word counts gathered."""
    data, _ = _setup(N_DEV * 1024 * 64, 5)
    _check_lockstep(*results, "lockstep_1d", data, data.size - 1234)


def test_lockstep_mesh_2d(results):
    data, _ = _setup(N_DEV * 1024 * 64, 6)
    _check_lockstep(*results, "lockstep_2d", data, data.size - 1234)


def test_lockstep_mesh_matches_single_device(results):
    """The mesh's group words equal one call's on the whole input, in the
    port (plain versions) and in glz_tpu (Pallas interpret mode)."""
    import jax.numpy as jnp

    from glz_tpu.ops import pallas_encode as pe

    port, ref = results
    data, cb = _setup(N_DEV * 1024 * 64, 7)
    n_valid = data.size - 1234
    _check_lockstep(port, ref, "lockstep_single", data, n_valid)
    gw = port[0]["lockstep_single"][1]
    mesh_words = np.concatenate([seg for d, r in enumerate(port)
                                 for seg in _segments(r["lockstep_single"][0], gw[d : d + 1])])
    single, padded = ke.encode_payload_from_symbols(torch.from_numpy(data), n_valid,
                                                    entry_table(cb, CPU), 64, 8)
    starts = np.cumsum(padded) - padded
    sp = single.numpy().view(np.uint32)
    assert np.array_equal(mesh_words, np.concatenate(
        [sp[starts[g] : starts[g] + gw[g]] for g in range(gw.size)]))
    tpu_pay, tpu_padded = pe.encode_payload_from_symbols(
        jnp.asarray(data), jnp.int32(n_valid),
        jnp.asarray(cb.left_justified_codes() | cb.lengths.astype(np.uint32)), 64,
        interpret=True)
    assert np.array_equal(np.asarray(tpu_padded), padded)
    assert np.array_equal(np.asarray(tpu_pay)[: sp.size], sp)


def test_multihost_single_process_path():
    """One process: compress_bytes_multihost is compress, glz_tpu's bytes."""
    from glz_tpu import decompress as tpu_decompress
    from glz_tpu.parallel import multihost as tpu_multihost

    import glz_tpu_torch as gt

    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, size=10_000, dtype=np.uint8).tobytes()
    blob = multihost.compress_bytes_multihost(data, device="cpu")
    assert blob == tpu_multihost.compress_bytes_multihost(data)
    assert gt.decompress(blob, device="cpu") == data
    assert tpu_decompress(blob) == data


def test_lockstep_codec_step_stride_bound(results):
    """max_bits_per_symbol shrinks the stride: a sufficient bound round-trips
    with glz_tpu's group table, an absurdly tight one raises on every rank."""
    port, ref = results
    data, _ = _stride_bound_setup()
    for r in port:
        assert np.array_equal(r["stride_12"][1], ref["stride_12"][1])
        assert r["stride_1"] is not None and "too tight" in r["stride_1"]
    assert np.array_equal(np.concatenate([r["stride_12"][2] for r in port]), data)
    assert np.array_equal(ref["stride_12"][2], data)
    payload, gw = port[0]["stride_12"][0], port[0]["stride_12"][1]
    # 12 bits a symbol: a stride of ceil((65536*12/32 + 2048)/128) + 16 rows
    assert payload.size == 2 * (-(-(65536 * 12 // 32 + 2048) // 128) + 16) * 128
    assert gw.size == 8


def test_dryrun_multichip_cpu(capsys):
    """The dry run on 4 gloo ranks prints __graft_entry__.py's numbers."""
    got = dryrun.dryrun_multichip(N_DEV, device="cpu", timeout=300)
    out = capsys.readouterr().out
    assert len(got) == N_DEV
    assert "12186 payload bits across 8 streams" in out
    assert "56399 payload words across 4 wide groups (8192 lockstep streams, rows=16)" in out
    fn, args = dryrun.entry(device="cpu")
    words, total_bits, stream_bits = fn(*args)
    assert total_bits == 8 * (8192 - 100) and words.numel() == -(-total_bits // 32)


def test_mesh_needs_the_whole_group():
    """A mesh is one rank per device over the whole process group."""
    got = ranks.run(f"{__file__}:_bad_mesh", 2, timeout=120, threads=1)
    assert all("needs 3 ranks" in msg for msg in got)


def _bad_mesh() -> str:
    try:
        pmesh.make_mesh(3, device="cpu")
    except ValueError as e:
        return str(e)
    return ""


@pytest.mark.parametrize("n", [0, 1, 15, 17, 4099, (1 << 19) + 3])
def test_histogram_ref_matches_reference(n):
    """The plain histogram (and the wrapper on a CPU tensor, from an odd
    offset) against glz_tpu's scatter histogram and its one-hot matmul on
    the input padded to whole chunks, less the pad."""
    import jax.numpy as jnp

    from glz_tpu.ops import histogram as tpu_hist

    rng = np.random.default_rng(n)
    data = (rng.integers(0, 256, n + 3, dtype=np.uint8) & rng.integers(0, 256, n + 3,
                                                                        dtype=np.uint8))
    t = torch.from_numpy(data)[3:]
    got = hist_ops.histogram_ref(t)
    assert got.dtype == torch.int64 and got.shape == (256,)
    assert torch.equal(hist_ops.histogram(t), got)
    want = np.bincount(data[3:], minlength=256)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(np.asarray(tpu_hist.histogram_scatter(jnp.asarray(data[3:]))), want)
    chunk = 1 << 12
    pad = -n % chunk or (chunk if n == 0 else 0)
    mm = np.array(tpu_hist.histogram_matmul(
        jnp.asarray(np.concatenate([data[3:], np.zeros(pad, np.uint8)])), chunk=chunk))
    mm[0] -= pad
    assert np.array_equal(mm, want)
