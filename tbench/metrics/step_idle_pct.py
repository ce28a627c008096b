"""Share of the traced window in which the device is idle while the host
is inside a fit loop's update call (``loop.step``): the window's idle gaps
cut by the program's step spans, both on the profiler's clock."""

from tbench.metrics._program import records
from tbench.trace import idle_gaps


def read(run):
    recs = records(run)
    steps = [(r.start, r.end) for r in recs or () if r.name == "loop.step"]
    if not steps:
        return None
    lo, hi = run.trace.window
    gaps, k, us = idle_gaps(run.trace), 0, 0.0
    for s, e in steps:
        while k < len(gaps) and gaps[k][1] <= s:
            k += 1
        j = k
        while j < len(gaps) and gaps[j][0] < e:
            us += min(e, gaps[j][1]) - max(s, gaps[j][0])
            j += 1
    return 100.0 * us / (hi - lo)
