"""The host library's share of the compress calls' wall time (%): the union
of the calls into the entry points of glz_tpu_torch.utils.native that
SPANS names (the byte histogram, the tokenizer and the vocabulary
build), which the harness wraps in spans in the traced run, over the
summed wall time of the compress calls. Nothing where an entry point is
missing or none ran."""
from glzbench import timeline

SPANS = {"glz_tpu_torch.utils.native": ("histogram", "tokenize", "build_vocab")}


def read(run):
    share = timeline.span_share(run, "compress", SPANS)
    return None if share is None else 100 * share
