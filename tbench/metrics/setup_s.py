"""Set-up: from the start of the process to the window's start (imports,
the kernels' build or load, the networks' draw, the warm-up fits)."""


def read(run):
    return run.setup_s
