"""The bytes the host copies per byte of data in the compress calls (B/B): the
program's `host_copy_bytes` counter, summed over its spans inside the calls
(the pad, serialize, container and verify steps, which count the bytes
they write into a new host buffer by copying; see glzbench/program.py),
over the bytes the calls took or returned.  Nothing where the program
counts none."""
from glzbench import program

program.begin_for_window()
DIRECTION = "compress"


def read(run):
    return program.copy_bytes(run, DIRECTION)
