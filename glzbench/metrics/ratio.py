"""Container bytes of every compress call in the window over their input
bytes."""
from glzbench import timeline


def read(run):
    calls = timeline.calls_of(run.calls, "compress")
    data = sum(c.data_bytes for c in calls)
    return sum(c.container_bytes for c in calls) / data if data else None
