"""K7's share of its roofline: the frozen bound of each launch of
``eta_contract_kernel`` over its device time.  The launches of an
iteration (``tbench.roofline.eta_contract.iteration_launches``, from the
cell's ``fit`` settings: two a block, one more under the stats
diagnostics) set the mean bound of a launch."""

from tbench.metrics._shape import shape
from tbench.roofline import eta_contract
from tbench.trace import named


def read(run):
    if run.trace is None:
        return None
    launches, us = named(run.trace, ("eta_contract_kernel",))
    if not launches or us <= 0:
        return None
    n, T, d, _ = shape(run)
    fit = run.cell.config["fit"]
    r = (d - 2) // 2
    bound = (eta_contract.iteration_bound_s(n, T, r, fit)
             / len(eta_contract.iteration_launches(n, T, r, fit)))
    return 100.0 * launches * bound / (us * 1e-6)
