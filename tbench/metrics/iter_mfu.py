"""The whole iteration's share of the card's peak: each traced fit's
least time by the frozen count of its iterations' work (bytes and float32
operations, whatever implements them) over the fits' wall time."""

from tbench import spec
from tbench.metrics._shape import shape
from tbench.roofline import counts, peaks


def read(run):
    if run.trace is None or not run.fits:
        return None
    n, T, d, blocks = shape(run)
    kind = spec.reference_kind(run.cell.traffic["kind"])
    per_iter, once, flops = counts.iteration(
        n, T, d, kind.iteration_flops(n, T, d, blocks),
        run.cell.traffic["mask_frac"] > 0)
    least = sum(peaks.bound_s(once + f.n_iter * per_iter, f.n_iter * flops)
                for f in run.fits)
    wall = sum(f.seconds for f in run.fits)
    return 100.0 * least / wall if wall > 0 else None
