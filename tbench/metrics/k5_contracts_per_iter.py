"""Masked contractions through K5 per iteration: the program's
``k5_contracts`` count (one a packed stripe; each unit a record made
while the profiler ran) over the traced window's iterations.  A program
without that counter (no ``profiling.K5_CONTRACTS``) reads None."""

from tbench.metrics._program import iterations, records


def read(run):
    try:
        from tame_torch.utils.profiling import K5_CONTRACTS
    except ImportError:
        return None
    recs, iters = records(run), iterations(run)
    if recs is None or not iters:
        return None
    return sum(r.name == K5_CONTRACTS for r in recs) / iters
