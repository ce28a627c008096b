"""K4's share of its roofline: the frozen bound of one block phase's
smoother (n / blocks trajectories of T steps, size d) over the device time
per launch of ``fused_smoother_kernel``."""

from tbench.metrics._shape import shape
from tbench.roofline import counts, peaks
from tbench.trace import named


def read(run):
    if run.trace is None:
        return None
    launches, us = named(run.trace, ("fused_smoother_kernel",))
    if not launches or us <= 0:
        return None
    n, T, d, blocks = shape(run)
    bound = peaks.bound_s(*counts.k4(n // blocks, T, d))
    return 100.0 * launches * bound / (us * 1e-6)
