"""The engines' own host time per fit from the program's spans: building
the engine (``engine.build``) and its ``fit`` (``engine.fit``), less the
fit function inside (``fit.run``)."""

from tbench.metrics._program import records, total_us


def read(run):
    recs = records(run)
    if recs is None or not run.fits:
        return None
    build, fit = total_us(recs, "engine.build"), total_us(recs, "engine.fit")
    if build is None or fit is None:
        return None
    us = build + fit - (total_us(recs, "fit.run") or 0.0)
    return us * 1e-3 / len(run.fits)
