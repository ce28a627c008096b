"""Variational inference engines and posterior samplers (counterpart of
:mod:`tame.inference`)."""

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
from tame_torch.inference.hmc import TemporalAMEHMC, run_hmc
from tame_torch.inference.logprob import (
    log_joint,
    log_likelihood,
    log_prior,
    make_logdensity_fn,
)
from tame_torch.inference.nuts import TemporalAMENUTS, nuts_kernel, run_nuts
from tame_torch.inference.smc import TemporalAMESMC, run_smc
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
    "TemporalAMEHMC",
    "TemporalAMENUTS",
    "TemporalAMESMC",
    "run_hmc",
    "run_nuts",
    "run_smc",
    "nuts_kernel",
    "log_joint",
    "log_likelihood",
    "log_prior",
    "make_logdensity_fn",
]
