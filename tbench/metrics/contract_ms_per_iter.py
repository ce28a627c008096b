"""Device milliseconds per iteration in matrix products (the eta
contraction, the diagnostics' dyadic means, the Grams) and in copy
kernels (the contraction's permutes), by kernel name."""

from tbench.trace import kernels

GEMM = ("gemm", "gemv", "cutlass", "xmma", "splitk", "dot_kernel")


def read(run):
    iters = sum(f.n_iter for f in run.fits)
    if run.trace is None or not iters:
        return None
    us = sum(o.end - o.start for o in kernels(run.trace)
             if any(k in o.name.lower() for k in GEMM + ("copy",)))
    return us * 1e-3 / iters if us > 0 else None
