"""The engine's start per fit (``engine.start``: a random draw on the
host's generator and its copy to the card, or the warm start)."""

from tbench.metrics._program import per_fit_ms


def read(run):
    return per_fit_ms(run, "engine.start")
