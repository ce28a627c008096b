"""Variational inference engines (counterpart of :mod:`tame.inference`;
the samplers and the non-Gaussian families are not ported yet)."""

from tame_torch.inference import cavi
from tame_torch.inference.cavi import (
    CaviState,
    FitResult,
    cavi_step_jacobi,
    cavi_step_seq,
    compute_elbo,
    fit_cavi,
    init_state,
)
from tame_torch.inference.em import EMResult, em_update_params, fit_em
from tame_torch.inference.engine import (
    BaseTemporalVariationalInference,
    BaseVariationalInference,
    TemporalAMECaviVI,
    TemporalAMENaiveMFVI,
    TemporalAMEStructuredMFVI,
)
from tame_torch.inference.evidence import exact_elbo
from tame_torch.inference.smoothed import (
    TemporalAMESmoothedVI,
    fit_cavi_smoothed,
    warm_init_smoothed_state,
)

__all__ = [
    "cavi",
    "CaviState",
    "FitResult",
    "cavi_step_jacobi",
    "cavi_step_seq",
    "compute_elbo",
    "fit_cavi",
    "init_state",
    "BaseVariationalInference",
    "BaseTemporalVariationalInference",
    "TemporalAMECaviVI",
    "TemporalAMENaiveMFVI",
    "TemporalAMEStructuredMFVI",
    "TemporalAMESmoothedVI",
    "fit_cavi_smoothed",
    "warm_init_smoothed_state",
    "fit_em",
    "em_update_params",
    "EMResult",
    "exact_elbo",
]
