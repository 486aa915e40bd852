"""`kernel_roofline.compress` in the cells of the bitstream layout
(byte-default.silesia-sizes), where it is the share of the byte lookup and
the bit pack in their roofline: the same reading, under a name of its own
that moves the compress tail, compress_p95_ms, there."""
from glzbench import harness

_BASE = harness.metric_reader("kernel_roofline.compress")
SPANS = getattr(_BASE, "SPANS", {})
read = _BASE.read
