"""Seconds per fit: the window's wall time over the whole fits it holds."""


def read(run):
    return run.window_s / len(run.fits) if run.fits else None
