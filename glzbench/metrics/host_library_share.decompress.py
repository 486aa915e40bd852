"""The host library's share of the decompress calls' wall time (%): the
union of the calls into the entry points of glz_tpu_torch.utils.native
that SPANS names (detokenize), which the harness wraps in spans in the
traced run, over the summed wall time of the decompress calls. Nothing
where an entry point is missing or none ran."""
from glzbench import timeline

SPANS = {"glz_tpu_torch.utils.native": ("detokenize",)}


def read(run):
    share = timeline.span_share(run, "decompress", SPANS)
    return None if share is None else 100 * share
