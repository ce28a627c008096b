"""K2's share of its roofline: the frozen bound of the entropy's n x T
log-determinants over the device time per launch of ``logdet_spd_kernel``
or ``logdet_thread_kernel``."""

from tbench.metrics._shape import shape
from tbench.roofline import counts, peaks
from tbench.trace import named


def read(run):
    if run.trace is None:
        return None
    launches, us = named(run.trace, ("logdet_spd_kernel",
                                     "logdet_thread_kernel"))
    if not launches or us <= 0:
        return None
    n, T, d, _ = shape(run)
    bound = peaks.bound_s(*counts.k2(n * T, d))
    return 100.0 * launches * bound / (us * 1e-6)
