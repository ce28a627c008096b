"""AME generative models, static and temporal, and the dyadic likelihood
families (counterpart of :mod:`tame.models`)."""

from tame_torch.models.base import BaseAMEModel
from tame_torch.models.likelihoods import (
    BernoulliDyadic,
    GaussianDyadic,
    NegativeBinomialDyadic,
    PoissonDyadic,
    get_family,
)
from tame_torch.models.params import (
    AMEParams,
    block_diagonal,
    build_params,
    correlation_matrix,
    params_from_numpy,
)
from tame_torch.models.static_ame import StaticAMEModel, sample_static
from tame_torch.models.temporal_ame import (
    TemporalAMEModel,
    random_dyad_mask,
    sample,
    sample_latents,
    sample_observations,
)

__all__ = [
    "BaseAMEModel",
    "StaticAMEModel",
    "TemporalAMEModel",
    "AMEParams",
    "BernoulliDyadic",
    "GaussianDyadic",
    "NegativeBinomialDyadic",
    "PoissonDyadic",
    "get_family",
    "build_params",
    "block_diagonal",
    "correlation_matrix",
    "params_from_numpy",
    "random_dyad_mask",
    "sample",
    "sample_latents",
    "sample_observations",
    "sample_static",
]
