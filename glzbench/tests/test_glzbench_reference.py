"""The plain reference reads the containers the program writes on its
plain CPU path (device="cpu"), and finds what is broken in them."""

import json
import struct

import numpy as np
import pytest

import glz_tpu_torch
from glz_tpu_torch.core import codebook
from glzbench import harness, traffic
from glzbench.reference import glz_lockstep as ref

CASES = (("byte-throughput", "and3-100MB", 4e-3), ("huffword-lockstep", "words-10MB", 2e-2),
         ("byte-throughput", "silesia-sizes", 4e-3))


def config(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())


def container(conf, data):
    return glz_tpu_torch.compress(data, mode=conf["mode"],
                                  conf=glz_tpu_torch.GlzConfig(**conf["conf"]), device="cpu")


@pytest.fixture(scope="module")
def made():
    out = {}
    for cname, tname, scale in CASES:
        conf = config(cname)
        files = traffic.make_files(traffic.load(tname), 2**31 + 99, scale)[:2]
        out[cname, tname] = [(conf, data, container(conf, data)) for _, data in files]
    return out


@pytest.mark.parametrize("case", [c[:2] for c in CASES])
def test_the_reference_reads_the_programs_containers(made, case):
    for conf, data, blob in made[case]:
        assert len(data) <= 1 << 20
        assert ref.check(blob, data, conf, "cpu") == (0, [])


def test_canonical_codes_are_a_prefix_code():
    lengths = codebook.code_lengths(np.arange(97) ** 3, 12)
    codes = ref.canonical_codes(lengths)
    words = {format(int(c), f"0{int(l)}b") for c, l in zip(codes, lengths) if l}
    assert len(words) == int((lengths > 0).sum())
    assert not any(a != b and b.startswith(a) for a in words for b in words)
    assert np.array_equal(codes, codebook.canonical_codebook(lengths).codewords)


def payload_start(blob):
    n_groups, _, cb_size = struct.unpack_from("<III", blob, 16)
    return 32 + cb_size + 4 * n_groups


@pytest.mark.parametrize("case", [c[:2] for c in CASES[:2]])
def test_a_flipped_payload_bit_is_found(made, case):
    conf, data, blob = made[case][0]
    start = payload_start(blob)
    for at in (start, start + 40, (start + len(blob)) // 2):
        b = bytearray(blob)
        b[at] ^= 0x04
        wrong, faults = ref.check(bytes(b), data, conf, "cpu")
        assert wrong or faults


def test_a_wrong_input_or_header_is_found(made):
    conf, data, blob = made["byte-throughput", "and3-100MB"][0]
    other = bytearray(data)
    other[7] ^= 1
    assert ref.check(blob, bytes(other), conf, "cpu")[0] == 1
    assert ref.check(blob[:-4], data, conf, "cpu")[1]
    assert ref.check(blob + b"\0" * 4, data, conf, "cpu")[1]
    assert "bad magic" in ref.check(data, data, conf, "cpu")[1]
    rows16 = dict(conf, conf=dict(conf["conf"], group_rows=16))
    assert ref.check(blob, data, rows16, "cpu")[1]
    b = bytearray(blob)
    b[32 + 1] = 0x11  # byte 0's and byte 1's code lengths: no longer a prefix code
    assert ref.check(bytes(b), data, conf, "cpu")[1]


def test_a_truncated_huffword_codebook_is_found(made):
    conf, data, blob = made["huffword-lockstep", "words-10MB"][0]
    b = bytearray(blob)
    struct.pack_into("<I", b, 24, 9)  # a codebook of 9 bytes
    assert ref.check(bytes(b), data, conf, "cpu")[1]
