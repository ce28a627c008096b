"""The engines' own host time per fit: the spans around building the
engine and its ``fit`` call, less the span around the program's fit
function inside it."""


def read(run):
    if run.trace is None or not run.fits:
        return None
    total = {}
    for s in run.trace.spans:
        total[s.name] = total.get(s.name, 0.0) + (s.end - s.start)
    if "tbench.fit_fn" not in total:
        return None
    us = (total.get("tbench.engine_init", 0.0)
          + total.get("tbench.engine_fit", 0.0) - total["tbench.fit_fn"])
    return us * 1e-3 / len(run.fits)
