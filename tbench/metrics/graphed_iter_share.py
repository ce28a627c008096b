"""Share of the traced window's fit-loop iterations that ran as CUDA graph
replays, in %: the program's ``graphed_iters`` count (each unit a record
made while the profiler ran) over the window's iterations.  A program
without that counter (no ``profiling.GRAPHED_ITERS``) reads None."""

from tbench.metrics._program import iterations, records


def read(run):
    try:
        from tame_torch.utils.profiling import GRAPHED_ITERS
    except ImportError:
        return None
    recs, iters = records(run), iterations(run)
    if recs is None or not iters:
        return None
    return 100.0 * sum(r.name == GRAPHED_ITERS for r in recs) / iters
