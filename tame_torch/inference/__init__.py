"""Variational inference engines (counterpart of :mod:`tame.inference`;
the samplers are not ported yet)."""

from tame_torch.inference import cavi
from tame_torch.inference.binary_cavi import (
    TemporalAMEBernoulliVI,
    fit_cavi_bernoulli,
)
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
from tame_torch.inference.family_smoothed import (
    SmoothedFamilyResult,
    fit_smoothed_family,
    warm_init_smoothed_family,
)
from tame_torch.inference.poisson_cavi import (
    TemporalAMEPoissonVI,
    fit_cavi_poisson,
)
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
    "TemporalAMEBernoulliVI",
    "TemporalAMEPoissonVI",
    "TemporalAMESmoothedVI",
    "fit_cavi_bernoulli",
    "fit_cavi_poisson",
    "fit_cavi_smoothed",
    "warm_init_smoothed_state",
    "fit_em",
    "em_update_params",
    "EMResult",
    "SmoothedFamilyResult",
    "fit_smoothed_family",
    "warm_init_smoothed_family",
    "exact_elbo",
]
