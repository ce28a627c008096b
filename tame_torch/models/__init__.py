"""AME generative models, static and temporal (counterpart of
:mod:`tame.models`; the non-Gaussian likelihoods are not ported yet)."""

from tame_torch.models.base import BaseAMEModel
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
