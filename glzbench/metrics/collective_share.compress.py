"""The exchange's share of the compress calls' wall time in a cell of
several processes (%): the union of the calls into the program's
collectives that SPANS names (multihost._allgather: the shard sizes and
the byte histograms; _gather_ragged: the payloads and the group tables),
which rank 0 wraps in spans in the traced run, over the summed wall time
of rank 0's compress calls.  A collective's span includes its wait for
the slowest rank; process 0's stitch is what is left of the call after
it.  Nothing where an entry point is missing or none ran (one process
runs none)."""
from glzbench import timeline

SPANS = {"glz_tpu_torch.parallel.multihost": ("_allgather", "_gather_ragged")}


def read(run):
    share = timeline.span_share(run, "compress", SPANS)
    return None if share is None else 100 * share
