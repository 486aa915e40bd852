"""Input bytes of every compress call in the window over the summed wall
time of those calls (GB/s, 10^9 B/s)."""
from glzbench import timeline


def read(run):
    calls = timeline.calls_of(run.calls, "compress")
    wall = timeline.call_time(calls)
    return sum(c.data_bytes for c in calls) / wall if wall else None
