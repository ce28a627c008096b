"""Abstract base class for AME network models (counterpart of
:mod:`tame.models.base`)."""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch

from tame_torch.models.params import block_diagonal, correlation_matrix


class BaseAMEModel(ABC):
    """Abstract AME model: dyadic Gaussian observations with additive
    (sender/receiver) and multiplicative (latent-position) effects.

        Y_ij = [y_ij, y_ji]' ~ N(mu_ij, R)
        mu_ij = [a_i + b_j + U_i . V_j,  a_j + b_i + U_j . V_i]'
    """

    n: int
    r: int

    @abstractmethod
    def generate_data(self, **kwargs):
        """Sample a synthetic network from the model."""

    @abstractmethod
    def compute_mean(self, *args, **kwargs):
        """Expected network structure given parameters."""

    @staticmethod
    def _generate_covariance_matrix(dim: int, correlation: float = 0.5,
                                    variance: float = 1.0) -> torch.Tensor:
        return correlation_matrix(dim, correlation, variance)

    @staticmethod
    def _block_diagonal_covariance(block_sizes, correlations,
                                   variances=None) -> torch.Tensor:
        if variances is None:
            variances = [1.0] * len(block_sizes)
        blocks = [correlation_matrix(size, corr, var)
                  for size, corr, var in zip(block_sizes, correlations,
                                             variances)]
        return block_diagonal(blocks)
