"""Identifiability alignment: Procrustes rotation + sign flips
(counterpart of :mod:`tame.utils.alignment`).

Latent-space AME models are identified only up to rotation and sign of the
latent positions; these functions align estimates with a ground truth
before errors are computed.  The orthogonal Procrustes rotation comes from
``torch.linalg.svd`` of the cross-covariance ``X_est' X_true`` with the
reflection fixed so ``det R = +1``; sign flips are one masked ``where``.
The per-time alignment is one batched SVD over T.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _rotation(X_est: torch.Tensor, X_true: torch.Tensor) -> torch.Tensor:
    """Proper rotation R (..., k, k) minimizing ``||X_true - X_est R||``
    for (..., n, k) inputs (batched over leading axes)."""
    M = X_est.transpose(-1, -2) @ X_true
    U, _, Vt = torch.linalg.svd(M, full_matrices=False)
    flip = torch.where(torch.linalg.det(U @ Vt) < 0, -1.0, 1.0)
    Vt = torch.cat([Vt[..., :-1, :], Vt[..., -1:, :] * flip[..., None, None]],
                   -2)
    return U @ Vt


def procrustes_alignment(X_est, X_true, scaling: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orthogonal Procrustes: ``(X_est R, R)`` with R the proper rotation
    minimizing ``||X_true - X_est R||`` (Schonemann 1966: the SVD of
    ``X_est' X_true``, as the JAX package, not the reference's transposed
    one); ``scaling`` also applies the optimal scale."""
    X_est, X_true = torch.as_tensor(X_est), torch.as_tensor(X_true)
    R = _rotation(X_est, X_true)
    X_aligned = X_est @ R
    if scaling:
        num = torch.trace(X_true.T @ X_aligned)
        den = torch.trace(X_aligned.T @ X_aligned)
        s = torch.where(den > 1e-10, num / torch.clamp(den, min=1e-10),
                        torch.ones_like(den))
        X_aligned = X_aligned * s
    return X_aligned, R


def align_signs(X_est, X_true, dim: int = -1) -> torch.Tensor:
    """Flip the sign of each slice along ``dim`` where that brings it
    closer to the target (``||x - t||^2 - ||-x - t||^2 = -4 <x, t>``).
    ``dim=-1`` (or the last axis) flips whole rows of the leading axis, as
    the reference does."""
    X_est, X_true = torch.as_tensor(X_est), torch.as_tensor(X_true)
    if dim == -1 or dim == X_est.ndim - 1:
        axes = tuple(range(1, X_est.ndim))
    else:
        axes = tuple(a for a in range(X_est.ndim) if a != dim)
    dots = torch.sum(X_est * X_true, dim=axes, keepdim=True)
    return torch.where(dots < 0, -X_est, X_est)


def _flip_rows(X: torch.Tensor, X_true: torch.Tensor) -> torch.Tensor:
    """Per-row sign alignment over the last axis (``align_signs(dim=1)``
    of each (n, k) slice), batched over leading axes."""
    dots = torch.sum(X * X_true, -1, keepdim=True)
    return torch.where(dots < 0, -X, X)


def _align_multiplicative(M_est: torch.Tensor, M_true: torch.Tensor,
                          r: int) -> torch.Tensor:
    """Procrustes on U and V separately, then per-row signs; (..., n, 2r)."""
    parts = []
    for sl in (slice(0, r), slice(r, 2 * r)):
        E, Tr = M_est[..., sl], M_true[..., sl]
        parts.append(_flip_rows(E @ _rotation(E, Tr), Tr))
    return torch.cat(parts, -1)


def align_latent_positions(M_est, M_true, latent_dim: int) -> torch.Tensor:
    """Align multiplicative effects ``M = [U, V]`` (n, 2r): Procrustes on
    U and V separately, then per-row sign alignment."""
    return _align_multiplicative(torch.as_tensor(M_est),
                                 torch.as_tensor(M_true), latent_dim)


def align_temporal_states(X_est, X_true, latent_dim: int,
                          align_each_time: bool = True) -> torch.Tensor:
    """Align state trajectories (n, T, d) with the truth.
    ``align_each_time=True`` aligns every time step on its own (signs for
    the additive effects, Procrustes + signs for U and V; one batched SVD
    over T); ``False`` takes one rotation of the whole multiplicative
    block from the time-averaged states and applies it at every step."""
    X_est, X_true = torch.as_tensor(X_est), torch.as_tensor(X_true)
    Xe, Xt = X_est.transpose(0, 1), X_true.transpose(0, 1)   # (T, n, d)
    A = _flip_rows(Xe[..., :2], Xt[..., :2])
    if align_each_time:
        M = _align_multiplicative(Xe[..., 2:], Xt[..., 2:], latent_dim)
    else:
        R_M = _rotation(X_est.mean(1)[:, 2:], X_true.mean(1)[:, 2:])
        M = _flip_rows(Xe[..., 2:] @ R_M, Xt[..., 2:])
    return torch.cat([A, M], -1).transpose(0, 1)


def compute_alignment_error(X_est, X_true, latent_dim: Optional[int] = None,
                            align: bool = True
                            ) -> Tuple[float, torch.Tensor]:
    """MSE after optimal alignment: ``(error, X_aligned)``."""
    X_est, X_true = torch.as_tensor(X_est), torch.as_tensor(X_true)
    X_aligned = X_est
    if align and X_est.ndim == 3:
        if latent_dim is None:
            raise ValueError(
                "latent_dim must be provided for temporal alignment")
        X_aligned = align_temporal_states(X_est, X_true, latent_dim)
    elif align and X_est.ndim == 2:
        if latent_dim is not None:
            X_aligned = torch.cat([
                align_signs(X_est[:, :2], X_true[:, :2], dim=1),
                align_latent_positions(X_est[:, 2:], X_true[:, 2:],
                                       latent_dim)], 1)
        else:
            X_aligned = align_signs(X_est, X_true, dim=1)
    return float(torch.mean((X_aligned - X_true) ** 2)), X_aligned


def _pearson(x: torch.Tensor, y: torch.Tensor) -> float:
    xc, yc = x - x.mean(), y - y.mean()
    den = torch.sqrt(torch.sum(xc ** 2) * torch.sum(yc ** 2))
    if float(den) < 1e-10:
        return 0.0
    return float(torch.sum(xc * yc) / den)


def compute_correlation_after_alignment(X_est, X_true,
                                        latent_dim: Optional[int] = None
                                        ) -> float:
    """Pearson correlation between aligned estimates and the truth."""
    _, X_aligned = compute_alignment_error(X_est, X_true, latent_dim)
    return _pearson(X_aligned.reshape(-1),
                    torch.as_tensor(X_true).reshape(-1))
