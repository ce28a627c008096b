"""K5's share of its roofline: the frozen bound of each launch of
``masked_contract_kernel`` (a block's stripe of n / blocks rows against
one of the iteration's two panels, which take equal shares of the
launches) over its device time."""

from tbench.metrics._shape import shape
from tbench.roofline import masked_contract
from tbench.trace import named


def read(run):
    if run.trace is None:
        return None
    launches, us = named(run.trace, ("masked_contract_kernel",))
    if not launches or us <= 0:
        return None
    n, T, d, blocks = shape(run)
    widths = masked_contract.panel_widths((d - 2) // 2)
    bound = sum(masked_contract.bound_s(n // blocks, n, T, K)
                for K in widths) / len(widths)
    return 100.0 * launches * bound / (us * 1e-6)
