"""K1's share of its roofline: the frozen bound of one block phase's solve
(B = n / blocks x T systems of size d, with the inverse) over the device
time per launch of ``spd_solve_inv_kernel``."""

from tbench.metrics._shape import shape
from tbench.roofline import counts, peaks
from tbench.trace import named


def read(run):
    if run.trace is None:
        return None
    launches, us = named(run.trace, ("spd_solve_inv_kernel",))
    if not launches or us <= 0:
        return None
    n, T, d, blocks = shape(run)
    bound = peaks.bound_s(*counts.k1(n // blocks * T, d))
    return 100.0 * launches * bound / (us * 1e-6)
