"""Share of the traced window with no operation on the device."""

from tbench.trace import busy_us


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - busy_us(run.trace) / (hi - lo))
