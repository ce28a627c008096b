"""Variational inference engines (counterpart of :mod:`tame.inference`)."""

from tame_torch.inference import cavi
from tame_torch.inference.em import EMResult, em_update_params, fit_em
from tame_torch.inference.engine import (
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
