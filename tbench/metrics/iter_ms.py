"""Milliseconds per iteration: the window's wall time over all iterations
of all its fits."""


def read(run):
    iters = sum(f.n_iter for f in run.fits)
    return run.window_s * 1e3 / iters if iters else None
