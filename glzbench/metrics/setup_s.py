"""Seconds from the start of the process to the start of the measured
window: imports, the card's context, the inputs made from the seed, the
program's builds where a checkout has none yet, and the warm-up calls."""


def read(run):
    return run.setup_s
