"""Contractions of the time-major dyad weights through K7 per iteration:
the program's ``k7_contracts`` count (one a launch of K7 or its twin;
each unit a record made while the profiler ran) over the traced window's
iterations.  A program without that counter (no
``profiling.K7_CONTRACTS``) reads None."""

from tbench.metrics._program import iterations, records


def read(run):
    try:
        from tame_torch.utils.profiling import K7_CONTRACTS
    except ImportError:
        return None
    recs, iters = records(run), iterations(run)
    if recs is None or not iters:
        return None
    return sum(r.name == K7_CONTRACTS for r in recs) / iters
