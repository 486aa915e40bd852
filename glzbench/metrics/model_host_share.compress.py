"""The model layer's host steps' share of the compress calls' wall time (%):
the union of the program's own spans of those steps (codebook, pad,
tables, serialize, container.read / container.write, verify; see
glzbench/program.py) inside the calls, over their summed wall time.
Nothing where the program records no such span."""
from glzbench import program

program.begin_for_window()
DIRECTION = "compress"


def read(run):
    share = program.host_share(run, DIRECTION)
    return None if share is None else 100 * share
