"""Static (single-snapshot) AME model (counterpart of
:mod:`tame.models.static_ame`): the T = 1 member of the family, sampled in
one batched draw of (A, M) through the prior Cholesky factors plus one
symmetrized dyad sample.

Randomness comes from an explicit ``torch.Generator`` on the model's
device (the card by default; pass ``device="cpu"`` to sample on the CPU).
The JAX and torch streams differ, so the two packages draw different data
from the same seed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tame_torch.config import ModelConfig
from tame_torch.models.base import BaseAMEModel
from tame_torch.models.params import AMEParams, build_params
from tame_torch.ops import dyad as dyad_ops


def sample_static(params: AMEParams, generator: torch.Generator, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample (Y (n, n, 2), A (n, 2), M (n, 2r)) on the generator's
    device."""
    r = params.r
    dev = generator.device
    params = params.to(dev)
    LA = torch.linalg.cholesky(params.Sigma)
    LM = torch.linalg.cholesky(params.Psi)
    LR = torch.linalg.cholesky(params.R)
    A = torch.randn(n, 2, generator=generator, device=dev) @ LA.T
    M = torch.randn(n, 2 * r, generator=generator, device=dev) @ LM.T
    mu = dyad_ops.dyadic_mean_static(A, M, r)
    noise = torch.randn(n, n, 2, generator=generator, device=dev) @ LR.T
    return dyad_ops.symmetrize_dyads(mu + noise), A, M


class StaticAMEModel(BaseAMEModel):
    """Static AME model: the constructor keywords and attributes of
    :class:`tame.models.StaticAMEModel`, plus ``device``, where the model's
    generator (and so its data) lives.  ``"cuda"``, the default, raises
    without a CUDA device."""

    def __init__(
        self,
        n_nodes: int,
        latent_dim: int = 2,
        rho_additive: float = 0.5,
        rho_multiplicative: float = 0.3,
        rho_dyadic: float = 0.5,
        seed: int = 42,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "StaticAMEModel(device='cuda') needs a CUDA device; pass "
                "device='cpu' to sample on the CPU")
        self.config = ModelConfig(
            n_nodes=n_nodes,
            n_time=1,
            latent_dim=latent_dim,
            rho_additive=rho_additive,
            rho_multiplicative=rho_multiplicative,
            rho_dyadic=rho_dyadic,
            seed=seed,
        )
        self.params = build_params(self.config)
        self.n = n_nodes
        self.r = latent_dim
        self.rho_additive = rho_additive
        self.rho_multiplicative = rho_multiplicative
        self.rho_dyadic = rho_dyadic
        self.seed = seed
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed)

        self.A: Optional[torch.Tensor] = None
        self.M: Optional[torch.Tensor] = None
        self.Y: Optional[torch.Tensor] = None

    @property
    def Sigma(self) -> torch.Tensor:
        return self.params.Sigma

    @property
    def Psi(self) -> torch.Tensor:
        return self.params.Psi

    @property
    def R(self) -> torch.Tensor:
        return self.params.R

    @property
    def R_inv(self) -> torch.Tensor:
        return self.params.R_inv

    def generate_data(self, return_latents: bool = False,
                      generator: Optional[torch.Generator] = None,
                      device=None):
        """Sample (and store) a network with ``generator`` (default: the
        model's own, so consecutive calls give fresh data), then move it to
        ``device`` (default: the generator's device)."""
        gen = self._generator if generator is None else generator
        Y, A, M = sample_static(self.params, gen, self.n)
        if device is not None:
            Y, A, M = Y.to(device), A.to(device), M.to(device)
        self.Y, self.A, self.M = Y, A, M
        if return_latents:
            return Y, A, M
        return Y

    def compute_mean(self, A, M) -> torch.Tensor:
        """Mean structure (n, n, 2) from A (n, 2) and M (n, 2r)."""
        return dyad_ops.dyadic_mean_static(torch.as_tensor(A),
                                           torch.as_tensor(M), self.r)

    def compute_reconstruction_error(self, A_est, M_est) -> float:
        """Off-diagonal MSE at estimated parameters (per-dyad
        normalization n(n-1))."""
        if self.Y is None:
            raise ValueError("No data generated yet. Call generate_data() first.")
        mu = self.compute_mean(torch.as_tensor(A_est, device=self.Y.device),
                               torch.as_tensor(M_est, device=self.Y.device))
        return float(dyad_ops.masked_sq_error_static(self.Y, mu))

    def compute_additive_contribution(self, A) -> float:
        return float(dyad_ops.additive_contribution(torch.as_tensor(A)))

    def compute_multiplicative_contribution(self, M) -> float:
        return float(dyad_ops.multiplicative_contribution(
            torch.as_tensor(M)))
