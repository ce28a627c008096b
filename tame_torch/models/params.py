"""Model parameter construction for the temporal AME family.

Plain functions building the covariance and dynamics matrices from a
:class:`tame_torch.config.ModelConfig`, plus :func:`params_from_numpy`,
which carries the JAX package's ``AMEParams`` over as numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tame_torch.config import ModelConfig


class AMEParams(NamedTuple):
    """Bundle of all fixed model matrices.

    Sigma (2, 2), Psi (2r, 2r), R (2, 2), R_inv (2, 2), Phi (d, d),
    Q (d, d), Sigma0 (d, d) = blockdiag(Sigma, Psi).
    """

    Sigma: torch.Tensor
    Psi: torch.Tensor
    R: torch.Tensor
    R_inv: torch.Tensor
    Phi: torch.Tensor
    Q: torch.Tensor
    Sigma0: torch.Tensor

    @property
    def d(self) -> int:
        return self.Phi.shape[0]

    @property
    def r(self) -> int:
        return (self.Phi.shape[0] - 2) // 2

    def to(self, device=None, dtype=None) -> "AMEParams":
        return AMEParams(*(t.to(device=device, dtype=dtype) for t in self))


def correlation_matrix(dim: int, correlation: float, variance: float = 1.0,
                       dtype=torch.float32) -> torch.Tensor:
    """Equicorrelation covariance: ``variance`` on the diagonal,
    ``correlation * variance`` off it."""
    m = torch.full((dim, dim), correlation * variance, dtype=dtype)
    m.fill_diagonal_(variance)
    return m


def block_diagonal(blocks: list[torch.Tensor]) -> torch.Tensor:
    """Assemble a block-diagonal matrix."""
    return torch.block_diag(*blocks)


def build_params(cfg: ModelConfig, dtype=torch.float32) -> AMEParams:
    """Construct all model matrices from a config (same semantics as
    :func:`tame.models.params.build_params`)."""
    r = cfg.latent_dim
    Sigma = correlation_matrix(2, cfg.rho_additive, 1.0, dtype)
    psi_block = correlation_matrix(r, cfg.rho_multiplicative, 1.0, dtype)
    Psi = block_diagonal([psi_block, psi_block])
    R = correlation_matrix(2, cfg.rho_dyadic, cfg.dyadic_variance, dtype)
    R_inv = torch.linalg.inv(R)

    d = cfg.d
    Sigma0 = block_diagonal([Sigma, Psi])
    Phi = torch.eye(d, dtype=dtype) * cfg.ar_coefficient
    Q = (1.0 - cfg.ar_coefficient ** 2) * Sigma0 * cfg.process_noise_scale
    return AMEParams(Sigma=Sigma, Psi=Psi, R=R, R_inv=R_inv, Phi=Phi, Q=Q,
                     Sigma0=Sigma0)


def _fields_as_tensors(p, names, device, dtype):
    get = p.__getitem__ if isinstance(p, dict) else (lambda k: getattr(p, k))
    return {k: torch.tensor(np.asarray(get(k)), dtype=dtype, device=device)
            for k in names}


def params_from_numpy(p, device=None, dtype=torch.float32) -> AMEParams:
    """Port's :class:`AMEParams` from any object (or dict) holding the
    fields of the JAX ``AMEParams`` as arrays."""
    return AMEParams(**_fields_as_tensors(p, AMEParams._fields, device,
                                          dtype))
