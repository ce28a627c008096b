"""Kernels launched per iteration (copies and fills by the copy engines
left out), over the traced fits."""

from tbench.trace import kernels


def read(run):
    iters = sum(f.n_iter for f in run.fits)
    if run.trace is None or not iters:
        return None
    return len(kernels(run.trace)) / iters
