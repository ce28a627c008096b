"""Temporal AME model: sampling core + reference-compatible class
(counterpart of :mod:`tame.models.temporal_ame`).

    X_i^0 ~ N(0, Sigma0),  X_i^t = Phi X_i^{t-1} + eps_t,  eps_t ~ N(0, Q)
    Y_ij^t = mu_ij^t + e,  e ~ N(0, R),  sampled once per unordered dyad.

Randomness comes from an explicit ``torch.Generator``; sampling runs on
the generator's device.  The JAX and torch streams differ, so the two
packages draw different data from the same seed.  The model's own
generator lives on the card by default (``device="cuda"``); pass
``device="cpu"`` to sample on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tame_torch.config import ModelConfig
from tame_torch.models.base import BaseAMEModel
from tame_torch.models.params import AMEParams, build_params
from tame_torch.ops import dyad as dyad_ops


def sample_latents(params: AMEParams, generator: torch.Generator, n: int,
                   T: int) -> torch.Tensor:
    """Ancestral sampling of the AR(1) latent chain: X (n, T, d)."""
    d = params.d
    dev = generator.device
    params = params.to(dev)
    L0 = torch.linalg.cholesky(params.Sigma0)
    LQ = torch.linalg.cholesky(params.Q)
    x = torch.randn(n, d, generator=generator, device=dev) @ L0.T
    eps = torch.randn(max(T - 1, 0), n, d, generator=generator,
                      device=dev) @ LQ.T
    xs = [x]
    for t in range(T - 1):
        x = x @ params.Phi.T + eps[t]
        xs.append(x)
    return torch.stack(xs, dim=1)


def sample_observations(params: AMEParams, generator: torch.Generator,
                        X: torch.Tensor) -> torch.Tensor:
    """Gaussian dyadic observations given latents: one correlated draw per
    ordered (i, j, t) slot, mirrored to enforce reciprocity.

    Returns Y (n, n, T, 2) with zero diagonal and Y[i,j,t,1] == Y[j,i,t,0].
    """
    n, T, _ = X.shape
    LR = torch.linalg.cholesky(params.R.to(X.device))
    mu = dyad_ops.dyadic_mean_temporal(X, params.r)
    noise = torch.randn(n, n, T, 2, generator=generator,
                        device=X.device) @ LR.T
    return dyad_ops.symmetrize_dyads(mu + noise)


def sample(params: AMEParams, generator: torch.Generator, n: int,
           T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample (Y, X) from the temporal AME model."""
    X = sample_latents(params, generator, n, T)
    Y = sample_observations(params, generator, X)
    return Y, X


def random_dyad_mask(generator: torch.Generator, n: int, T: int,
                     missing_frac: float) -> torch.Tensor:
    """Random missing-at-random dyad observation mask, drawn on the
    generator's device.

    Each unordered dyad (i, j) at each time t is observed with probability
    ``1 - missing_frac``; the mask is symmetric (both directions of a dyad
    live in one ``Y[i, j, t]`` entry and are observed together) with zero
    diagonal.  Returns a float32 ``(n, n, T)`` tensor of {0, 1}.
    """
    dev = generator.device
    u = torch.rand(n, n, T, generator=generator, device=dev)
    upper = torch.triu(torch.ones(n, n, device=dev), diagonal=1)[:, :, None]
    keep = (u > missing_frac).float() * upper
    return keep + keep.transpose(0, 1)


class TemporalAMEModel(BaseAMEModel):
    """Temporal AME model with AR(1) dynamics: the constructor keywords and
    attributes of :class:`tame.models.TemporalAMEModel`, plus ``device``,
    where the model's generator (and so its data) lives.  ``"cuda"``, the
    default, raises without a CUDA device."""

    def __init__(
        self,
        n_nodes: int,
        n_time: int,
        latent_dim: int = 2,
        ar_coefficient: float = 0.8,
        rho_additive: float = 0.5,
        rho_multiplicative: float = 0.3,
        rho_dyadic: float = 0.5,
        process_noise_scale: float = 0.1,
        seed: int = 42,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TemporalAMEModel(device='cuda') needs a CUDA device; pass "
                "device='cpu' to sample on the CPU")
        self.config = ModelConfig(
            n_nodes=n_nodes,
            n_time=n_time,
            latent_dim=latent_dim,
            ar_coefficient=ar_coefficient,
            rho_additive=rho_additive,
            rho_multiplicative=rho_multiplicative,
            rho_dyadic=rho_dyadic,
            process_noise_scale=process_noise_scale,
            seed=seed,
        )
        self.params = build_params(self.config)
        self.n = n_nodes
        self.T = n_time
        self.r = latent_dim
        self.d = self.config.d
        self.ar_coefficient = ar_coefficient
        self.process_noise_scale = process_noise_scale
        self.rho_additive = rho_additive
        self.rho_multiplicative = rho_multiplicative
        self.rho_dyadic = rho_dyadic
        self.seed = seed
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed)

        self.X: Optional[torch.Tensor] = None
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

    @property
    def Phi(self) -> torch.Tensor:
        return self.params.Phi

    @property
    def Q(self) -> torch.Tensor:
        return self.params.Q

    def generate_data(self, return_latents: bool = False,
                      generator: Optional[torch.Generator] = None,
                      device=None):
        """Generate (and store) a synthetic dataset.

        Samples with ``generator`` (default: the model's own generator,
        seeded from ``seed`` on the model's device, so consecutive calls
        give fresh data) on that generator's device, then moves the result
        to ``device`` (default: the generator's device).
        """
        gen = self._generator if generator is None else generator
        Y, X = sample(self.params, gen, self.n, self.T)
        if device is not None:
            Y, X = Y.to(device), X.to(device)
        self.Y, self.X = Y, X
        if return_latents:
            return Y, X
        return Y

    def compute_mean(self, A: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
        """Snapshot mean structure (n, n, 2) from additive effects A (n, 2)
        and multiplicative effects M (n, 2r)."""
        return dyad_ops.dyadic_mean_static(A, M, self.r)

    def compute_temporal_reconstruction_error(self, X_est) -> float:
        """Model-level reconstruction MSE (per-dyad normalization
        n(n-1)T)."""
        if self.Y is None:
            raise ValueError("No data generated yet. Call generate_data() first.")
        X_est = torch.as_tensor(X_est, device=self.Y.device)
        mu = dyad_ops.dyadic_mean_temporal(X_est, self.r)
        return float(dyad_ops.masked_sq_error_temporal(self.Y, mu))
