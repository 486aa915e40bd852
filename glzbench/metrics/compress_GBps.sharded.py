"""`compress_GBps` in the cell of several processes (byte-sharded.enwik9),
where the compress rate, host work of four ranks on one shared host,
spreads too widely from run to run to hold a bound: the same reading,
under a name of its own."""
from glzbench import harness

_BASE = harness.metric_reader("compress_GBps")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
