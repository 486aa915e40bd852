"""`correct` comes out false under the control and under each fault a cell
can have, and true under the program: the rest of a run, on the program's
plain CPU path (device="cpu") at a small size, past the look for a card."""

import pytest

from glzbench import control, faults, harness, traffic

CELLS = {"byte-throughput.and3-100MB": 5e-4, "huffword-lockstep.words-10MB": 2e-3,
         "byte-throughput.silesia-sizes-batch": 2e-5}


@pytest.fixture(scope="module")
def cells():
    out = {}
    for name, scale in CELLS.items():
        cell = harness.load_cell(name)
        out[name] = cell, traffic.make_files(cell.traffic, 2**31 + 21, scale)
    return out


@pytest.mark.parametrize("name", CELLS)
def test_the_program_reads_correct(cells, name):
    cell, files = cells[name]
    correct, checks = control.readings(cell, harness.Entry(cell.config, "cpu"), files, 0.01,
                                       "cpu")
    assert correct, checks
    assert all(v == 0 for v, _ in checks.values())


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_reads_not_correct(cells, name, fault):
    cell, files = cells[name]
    correct, checks = control.readings(cell, faults.FAULTS[fault](cell.config, "cpu"), files,
                                       0.01, "cpu")
    assert not correct
    assert any(v > limit for v, limit in checks.values())
