"""Files in flight in the decompress batch calls (files): the program's
`batch.file` spans (each file's call on the front door's two-deep pipeline;
see glzbench/program.py) summed inside the batch calls, over those calls'
wall time: 1 is no overlap, 2 the pipeline's depth.  Nothing where no call
holds a batch.file span."""
from glzbench import program

program.begin_for_window()
DIRECTION = "decompress"


def read(run):
    return program.overlap_files(run, DIRECTION)
