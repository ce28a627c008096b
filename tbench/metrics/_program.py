"""The program's own records (``tame_torch.utils.profiling``: spans, and
counts made while the profiler ran) inside a traced run's window.  They
are timed on ``time.time_ns()``, the profiler's clock, so nanoseconds over
1,000 are the trace's microseconds."""

from typing import List, NamedTuple, Optional


class Record(NamedTuple):
    name: str
    start: float    # microseconds
    end: float


def records(run) -> Optional[List[Record]]:
    """The program's closed records inside the window, by start; None for
    an untraced run or a program that records none there."""
    if run.trace is None:
        return None
    try:
        from tame_torch.utils.profiling import spans

        raw = spans()
    except (ImportError, AttributeError):
        return None
    lo, hi = run.trace.window
    out = [Record(r.name, r.start_ns * 1e-3, r.end_ns * 1e-3) for r in raw
           if r.end_ns >= r.start_ns]
    out = [r for r in out if lo <= r.start and r.end <= hi]
    return sorted(out, key=lambda r: r.start) or None


def total_us(recs: List[Record], name: str) -> Optional[float]:
    """Microseconds in the spans named ``name``; None where there is none."""
    hits = [r.end - r.start for r in recs if r.name == name]
    return sum(hits) if hits else None


def iterations(run) -> int:
    return sum(f.n_iter for f in run.fits)


def per_iter_ms(run, name: str) -> Optional[float]:
    """Milliseconds an iteration in the spans named ``name``."""
    recs, iters = records(run), iterations(run)
    us = None if recs is None else total_us(recs, name)
    return None if us is None or not iters else us * 1e-3 / iters


def per_fit_ms(run, name: str) -> Optional[float]:
    """Milliseconds a fit in the spans named ``name``."""
    recs = records(run)
    us = None if recs is None else total_us(recs, name)
    return None if us is None or not run.fits else us * 1e-3 / len(run.fits)
