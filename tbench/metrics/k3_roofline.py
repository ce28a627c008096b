"""K3's share of its roofline: the frozen bound of each traced fit (its own
iterations) over the device time of ``fused_fit_kernel``, one launch a
fit."""

from tbench.metrics._shape import shape
from tbench.roofline import counts, peaks
from tbench.trace import named


def read(run):
    if run.trace is None:
        return None
    launches, us = named(run.trace, ("fused_fit_kernel",))
    if not launches or us <= 0 or launches != len(run.fits):
        return None
    n, T, d, blocks = shape(run)
    max_iter = run.cell.config["fit"]["max_iter"]
    bound = sum(peaks.bound_s(*counts.k3(n, T, d, blocks, f.n_iter,
                                         max_iter)) for f in run.fits)
    return 100.0 * bound / (us * 1e-6)
