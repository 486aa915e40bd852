"""The rate of the copies inside the compress calls (GB/s): their bytes, from
the trace's copy events, over the copies' summed device time."""
from glzbench import timeline

DIRECTION = "compress"


def read(run):
    if run.device_events is None:
        return None
    nbytes, busy = timeline.copies(run, DIRECTION)
    return nbytes / busy / 1e9 if busy > 0 and nbytes else None
