"""The plain bitstream reference reads the containers the program writes
under the DEFAULT preset on its plain CPU path (device="cpu"), and finds
what is broken in them, a code that is not optimal for the exact byte
counts among them."""

import dataclasses
import json
import struct

import numpy as np
import pytest

import glz_tpu_torch
from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import codebook
from glz_tpu_torch.models import canonical_byte
from glzbench import harness, traffic
from glzbench.reference import glz_bitstream as ref

SMALL_S = 4096  # many streams a file at these sizes
CASES = ("byte-default", "byte-default.S4096")


def config(name):
    conf = json.loads((harness.HERE / "configs" / "byte-default.json").read_text())
    if name.endswith(".S4096"):
        conf = dict(conf, conf=dict(conf["conf"], stream_symbols=SMALL_S))
    return conf


def container(conf, data):
    return glz_tpu_torch.compress(data, mode=conf["mode"],
                                  conf=glz_tpu_torch.GlzConfig(**conf["conf"]), device="cpu")


def payload_start(blob):
    n_streams, _, cb_size = struct.unpack_from("<III", blob, 16)
    return 32 + cb_size + 4 * n_streams


@pytest.fixture(scope="module")
def made():
    files = traffic.make_files(traffic.load("silesia-sizes"), 2**31 + 99, 2e-3)
    files = [files[0], files[1], files[4], ("empty", b"")]  # text, two byte laws, empty
    return {name: [(config(name), data, container(config(name), data)) for _, data in files]
            for name in CASES}


def test_the_configuration_is_the_default_preset():
    conf = json.loads((harness.HERE / "configs" / "byte-default.json").read_text())
    assert conf["conf"] == dataclasses.asdict(cfg.DEFAULT)
    assert conf["mode"] == cfg.MODE_BYTE and conf["reference"] == "glz_bitstream"


@pytest.mark.parametrize("case", CASES)
def test_the_reference_reads_the_programs_containers(made, case):
    streams = []
    for conf, data, blob in made[case]:
        assert ref.check(blob, data, conf, "cpu") == (0, [])
        streams.append(struct.unpack_from("<I", blob, 16)[0])
    assert streams[-1] == 1  # the empty input's one stream of 0 bits
    if case.endswith(".S4096"):
        assert min(streams[:-1]) >= 3


def test_some_payload_ends_inside_a_byte(made):
    ends = [len(blob) - payload_start(blob) for _, data, blob in made["byte-default"] if data]
    bits = [int(np.frombuffer(blob, "<u4", 1, payload_start(blob) - 4)[0])
            for _, data, blob in made["byte-default"] if data]
    assert [(b + 7) // 8 for b in bits] == ends and any(b % 8 for b in bits)


def test_canonical_codes_are_the_programs():
    lengths = codebook.code_lengths(np.arange(256) ** 4 + 1, 32)
    assert np.array_equal(ref.canonical_codes(lengths),
                          codebook.canonical_codebook(lengths).codewords)


@pytest.mark.parametrize("limit", [32, 9, 8])
def test_least_cost_is_the_programs_optimal_length_limited_code(limit):
    rng = np.random.default_rng(limit)
    counts = np.where(rng.random(256) < 0.3, 0, rng.zipf(1.3, 256).clip(max=10**7))
    lengths = codebook.code_lengths(counts, limit)
    assert lengths.max() <= limit
    assert ref.least_cost(counts, limit) == int((counts * lengths).sum())
    assert ref.least_cost(counts, 7) is None  # 256 bytes or so need 8 bits
    assert ref.least_cost(np.array([0, 5, 0]), 32) == 5  # a lone byte takes one bit


def test_a_flipped_payload_bit_is_found(made):
    for conf, data, blob in made["byte-default.S4096"][:3]:
        start = payload_start(blob)
        for at in (start, start + 40, (start + len(blob)) // 2, len(blob) - 2):
            b = bytearray(blob)
            b[at] ^= 0x04
            wrong, faults = ref.check(bytes(b), data, conf, "cpu")
            assert wrong or faults, at


def test_a_truncated_stream_table_is_found(made):
    conf, data, blob = made["byte-default.S4096"][1]
    end = payload_start(blob)
    wrong, faults = ref.check(blob[: end - 4] + blob[end:], data, conf, "cpu")
    assert wrong == len(data) and faults
    b = bytearray(blob)
    struct.pack_into("<I", b, 16, struct.unpack_from("<I", blob, 16)[0] - 1)
    assert ref.check(bytes(b), data, conf, "cpu")[1]


@pytest.mark.parametrize("case", CASES)
def test_a_wrong_stream_size_is_found(made, case):
    conf, data, blob = made[case][1]
    b = bytearray(blob)
    struct.pack_into("<I", b, 20, 2 * struct.unpack_from("<I", blob, 20)[0])
    wrong, faults = ref.check(bytes(b), data, conf, "cpu")
    assert any("bytes a stream" in f for f in faults)


def test_a_cleared_pad_is_found(made):
    hit = 0
    for conf, data, blob in made["byte-default"]:
        bits = int(np.frombuffer(blob, "<u4", 1, payload_start(blob) - 4)[0])
        if bits % 8:
            b = bytearray(blob)
            b[-1] &= 0xFF ^ ((1 << (8 - bits % 8)) - 1)
            assert ref.check(bytes(b), data, conf, "cpu") == (
                0, ["the last byte's pad bits are not 1s"])
            hit += 1
    assert hit


@pytest.mark.parametrize("case", CASES)
def test_a_sampled_histograms_code_is_found(made, case):
    """The host encoder's container under a code built from a sampled
    histogram (histogram_budget set): valid, decodable, not optimal."""
    conf, data, blob = made[case][1]
    arr = np.frombuffer(data, np.uint8)
    sampled = codebook.build_codebook(codebook.sampled_histogram(arr, 4096), 32)
    other = canonical_byte.compress_bytes_host(
        data, glz_tpu_torch.GlzConfig(**dict(conf["conf"], histogram_budget=4096)),
        codebook=sampled, device="cpu")
    assert glz_tpu_torch.decompress(other, device="cpu") == data and other != blob
    wrong, faults = ref.check(other, data, conf, "cpu")
    assert wrong == 0 and len(faults) == 1 and "not optimal" in faults[0]


def test_a_wrong_input_or_header_is_found(made):
    conf, data, blob = made["byte-default"][0]
    other = bytearray(data)
    other[7] ^= 1
    wrong, faults = ref.check(blob, bytes(other), conf, "cpu")
    assert wrong == 1 or faults
    assert ref.check(blob[:-1], data, conf, "cpu")[1]
    assert ref.check(blob + b"\xff", data, conf, "cpu")[1]
    assert "bad magic" in ref.check(data, data, conf, "cpu")[1]
    lockstep = container(json.loads((harness.HERE / "configs" / "byte-throughput.json")
                                    .read_text()), data)
    assert ref.check(lockstep, data, conf, "cpu")[1]
    b = bytearray(blob)
    b[32 + 1] = 0x11  # byte 0's and byte 1's code lengths: no longer a prefix code
    assert ref.check(bytes(b), data, conf, "cpu")[1]
