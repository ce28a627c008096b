"""The temporal AME model's fixed matrices, the initial states the engines
start from, and the precisions the reference computes in.

Everything is written out from the model's definition (Hoff 2021 family,
AR(1) latents), in plain PyTorch, from the numbers of a configuration file:

    X_i^0 ~ N(0, Sigma0),  Sigma0 = blockdiag(Sigma, Psi, Psi)
    X_i^t = Phi X_i^{t-1} + eps,  eps ~ N(0, Q),  Phi = phi I,
    Q = (1 - phi^2) Sigma0 * process_noise_scale
    (y_ij^t, y_ji^t) ~ N(mu, R),  mu_ij^t = a_i + b_j + U_i . V_j

with Sigma, Psi and R equicorrelation matrices.  A state is ``(n, T, d)``
with ``d = 2 + 2 r`` laid out ``[a, b, U_1..U_r, V_1..V_r]``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

LOG2PI = math.log(2.0 * math.pi)


class Precision(NamedTuple):
    """How the reference computes: a float type, and whether every matrix
    product takes its operands rounded to TF32 (10 mantissa bits, round to
    nearest, ties away from zero, as the tensor cores' conversion does),
    summed in float32: the precision just below float32."""

    name: str
    dtype: torch.dtype
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` (batched by broadcasting) in this precision."""
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return torch.matmul(a, b)


PRECISIONS = {
    "f64": Precision("f64", torch.float64),
    "f32": Precision("f32", torch.float32),
    "tf32": Precision("tf32", torch.float32, tf32=True),
}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32's 10-bit mantissa."""
    if x.dtype != torch.float32:
        raise TypeError(f"TF32 rounding takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32).view(x.shape)


def equicorrelation(dim: int, rho: float, variance: float,
                    dtype=torch.float64) -> torch.Tensor:
    m = torch.full((dim, dim), rho * variance, dtype=dtype)
    m.fill_diagonal_(variance)
    return m


class Params(NamedTuple):
    Sigma0: torch.Tensor   # (d, d)
    Q: torch.Tensor        # (d, d)
    Phi: torch.Tensor      # (d, d)
    R: torch.Tensor        # (2, 2)
    R_inv: torch.Tensor    # (2, 2)

    @property
    def d(self) -> int:
        return self.Phi.shape[0]

    def to(self, dtype=None, device=None) -> "Params":
        return Params(*(t.to(dtype=dtype, device=device) for t in self))


def build_params(model: dict, dtype=torch.float64, device="cpu") -> Params:
    """The fixed matrices from a configuration's ``model`` group, built in
    float64 and cast to ``dtype``."""
    r = model["latent_dim"]
    d = 2 + 2 * r
    sigma = equicorrelation(2, model["rho_additive"], 1.0)
    psi = equicorrelation(r, model["rho_multiplicative"], 1.0)
    sigma0 = torch.block_diag(sigma, psi, psi)
    R = equicorrelation(2, model["rho_dyadic"], model["dyadic_variance"])
    phi = model["ar_coefficient"]
    Q = (1.0 - phi * phi) * sigma0 * model["process_noise_scale"]
    p = Params(Sigma0=sigma0, Q=Q, Phi=torch.eye(d, dtype=torch.float64) * phi,
               R=R, R_inv=torch.linalg.inv(R))
    return p.to(dtype=dtype, device=device)


def random_init(seed: int, n: int, T: int, d: int, init_scale: float,
                cov_init_scale: float):
    """The Good-SMF engines' random start from ``seed``: means
    ``N(0, init_scale^2)`` and covariances ``(cov_init_scale + 0.1) I``
    plus a symmetric ``N(0, 0.01^2)`` perturbation, drawn in float32 from
    a CPU generator seeded ``seed`` (means first)."""
    g = torch.Generator().manual_seed(seed)
    mean = torch.randn(n, T, d, generator=g) * init_scale
    noise = torch.randn(n, T, d, d, generator=g) * 0.01
    noise = 0.5 * (noise + noise.transpose(-1, -2))
    eye = torch.eye(d)
    return mean, eye * cov_init_scale + noise + eye * 0.1


def warm_init_mean(Y0: torch.Tensor, r: int, prec: Precision,
                   power_iters: int = 4) -> torch.Tensor:
    """The smoothed engine's data-driven start (no mask): the two-way fit of
    the time-averaged network for (a, b), and its residual's top-r
    singular pairs by subspace iteration from a standard-normal (n, r)
    probe (float32, CPU generator seeded 0) for ``U = u sqrt(s)``,
    ``V = v sqrt(s)``, constant over time.  ``Y0`` is (n, n, T)."""
    n, _, T = Y0.shape
    w = 1.0 - torch.eye(n, dtype=Y0.dtype, device=Y0.device)
    M = Y0.mean(-1) * w
    a = M.sum(1) / w.sum(1)
    b = M.sum(0) / w.sum(0)
    grand = M.sum() / w.sum()
    a, b = a - grand / 2.0, b - grand / 2.0
    resid = (M - a[:, None] - b[None, :]) * w
    probe = torch.randn(n, r, generator=torch.Generator().manual_seed(0))
    Z = prec.mm(resid, probe.to(resid))
    for _ in range(power_iters):
        Z, _ = torch.linalg.qr(prec.mm(resid, prec.mm(resid.T, Z)))
    u, s, vt = torch.linalg.svd(prec.mm(Z.T, resid), full_matrices=False)
    scale = torch.sqrt(torch.clamp(s, min=1e-12))
    U = prec.mm(Z, u) * scale
    V = vt.T * scale
    centroid = torch.cat([a[:, None], b[:, None], U, V], -1)
    return centroid[:, None, :].expand(n, T, 2 + 2 * r).clone()
