"""`bitio_share.compress`'s reading over the decompress calls (%): the union
of the program's `bitio.*` spans inside them, over their summed wall time.
Nothing where the program records no such span."""
from glzbench import harness, program

program.begin_for_window()
_share = harness.metric_reader("bitio_share.compress").share


def read(run):
    return _share(run, "decompress")
