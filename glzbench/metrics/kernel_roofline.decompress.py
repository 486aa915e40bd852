"""The kernels' share of the bandwidth roofline over the decompress calls
(%): the least time the card's memory could move the work in (the
containers' payload bytes read once plus the output bytes written once,
at the card's peak bandwidth, peaks.json), over the summed kernel time
inside those calls. It counts the work the direction needs, whatever
kernels do it. Nothing without a trace, a kernel or the card's peak."""
from glzbench import timeline

DIRECTION = "decompress"


def read(run):
    if run.device_events is None or not run.peaks:
        return None
    kernel_s = timeline.kernel_seconds(run, DIRECTION)
    calls = timeline.calls_of(run.calls, DIRECTION)
    work = sum(c.data_bytes + c.payload_bytes for c in calls)
    if kernel_s <= 0 or not work:
        return None
    return 100 * work / run.peaks["hbm_bytes_per_s"] / kernel_s
