"""The nearest-rank 95th percentile of the wall time of every decompress
call in the window (ms); nothing where fewer than 20 calls leave no call
beyond it."""
from glzbench import timeline

MIN_CALLS = 20


def read(run):
    calls = timeline.calls_of(run.calls, "decompress")
    if len(calls) < MIN_CALLS:
        return None
    return timeline.percentile([c.seconds * 1e3 for c in calls], 95)
