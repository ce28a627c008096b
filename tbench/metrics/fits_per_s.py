"""Fits completed per second by one caller: the whole fits the window
holds over its wall time."""


def read(run):
    return len(run.fits) / run.window_s if run.fits and run.window_s > 0 \
        else None
