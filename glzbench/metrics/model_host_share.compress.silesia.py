"""`model_host_share.compress` in the cells whose compress rate spreads too widely from run
to run to hold a bound (byte-throughput.silesia-sizes): the same reading,
under a name of its own that moves the compress tail, compress_p95_ms,
there."""
from glzbench import harness

_BASE = harness.metric_reader("model_host_share.compress")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
