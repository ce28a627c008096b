"""The host's syncs with the card per iteration: the program's ``syncs``
count over the traced window (each unit a record made while the profiler
ran), over the window's iterations."""

from tbench.metrics._program import iterations, records


def read(run):
    recs, iters = records(run), iterations(run)
    if recs is None or not iters:
        return None
    return sum(r.name == "syncs" for r in recs) / iters
