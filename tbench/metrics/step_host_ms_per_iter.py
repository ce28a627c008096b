"""Host milliseconds per iteration inside the fit loops' update call
(``loop.step``: enqueueing one sweep of block phases)."""

from tbench.metrics._program import per_iter_ms


def read(run):
    return per_iter_ms(run, "loop.step")
