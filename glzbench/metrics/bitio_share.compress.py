"""The bit streams' byte and word conversions' share of the compress calls'
wall time (%): the union of the program's `bitio.*` spans
(glz_tpu_torch/core/bitio.py's words_to_bytes and bytes_to_words, inside
`serialize`) inside the calls, over their summed wall time.  Nothing where
the program records no such span: the lockstep layout calls neither, and a
program before the spans records none."""
from glzbench import program, timeline

program.begin_for_window()
DIRECTION = "compress"
BITIO = ("bitio.words_to_bytes", "bitio.bytes_to_words")


def share(run, direction: str) -> float | None:
    spans = program.records()
    calls = timeline.calls_of(run.calls, direction)
    mine = program.within(spans, calls) if spans and calls else []
    steps = timeline.union((r.start_ns, r.end_ns) for r in mine if r.name in BITIO)
    wall = timeline.call_time(calls)
    if not steps or not wall:
        return None
    return 100 * timeline.overlap(steps, timeline.window_of(calls)) / wall


def read(run):
    return share(run, DIRECTION)
