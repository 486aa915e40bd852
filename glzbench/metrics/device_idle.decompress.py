"""The device's idle share over the decompress calls (%): 1 - the union of
kernel, copy and memset intervals over their summed wall time."""
from glzbench import timeline

DIRECTION = "decompress"


def read(run):
    busy = timeline.device_busy_share(run, DIRECTION)
    return None if busy is None else 100 * (1 - busy)
