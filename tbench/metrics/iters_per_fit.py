"""Iterations per fit (the fit loop's stopping rule), over the traced
fits."""


def read(run):
    if run.trace is None or not run.fits:
        return None
    return sum(f.n_iter for f in run.fits) / len(run.fits)
