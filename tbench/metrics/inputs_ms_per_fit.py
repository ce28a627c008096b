"""The fit's loop-invariant inputs per fit (``fit.inputs``: the dyad
weights, bf16 under mixed precision, the stats diagnostics' constants and
the mask as the contractions read it, packed for K5 or bf16)."""

from tbench.metrics._program import per_fit_ms


def read(run):
    return per_fit_ms(run, "fit.inputs")
