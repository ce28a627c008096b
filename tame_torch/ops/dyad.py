"""Vectorized dyadic-tensor operations (counterpart of :mod:`tame.ops.dyad`).

Conventions
-----------
* Latent state ``X``: shape ``(n, T, d)`` with layout
  ``[a, b, U_1..U_r, V_1..V_r]``.
* Observations ``Y``: shape ``(n, n, T, 2)`` with
  ``Y[i, j, t] = [y_ij^t, y_ji^t]``, zero diagonal and reciprocity
  ``Y[i, j, t, 1] == Y[j, i, t, 0]``.
"""

from __future__ import annotations

import torch


def split_state(X: torch.Tensor, r: int):
    """Split a state tensor ``(..., d)`` into (a, b, U, V) views."""
    return X[..., 0], X[..., 1], X[..., 2:2 + r], X[..., 2 + r:]


def dyadic_mean_static(A: torch.Tensor, M: torch.Tensor,
                       r: int) -> torch.Tensor:
    """Mean structure of one snapshot: A (n, 2), M (n, 2r) -> (n, n, 2) with
    ``mu[i, j] = [a_i + b_j + U_i.V_j,  a_j + b_i + U_j.V_i]``."""
    fwd = A[:, 0, None] + A[None, :, 1] + M[:, :r] @ M[:, r:].T
    return torch.stack([fwd, fwd.T], dim=-1)


def dyadic_fwd_temporal(X: torch.Tensor, r: int) -> torch.Tensor:
    """Forward half of the dyadic mean: ``fwd[i,j,t] = a_i + b_j + U_i.V_j``
    of shape (n, n, T)."""
    a, b, U, V = split_state(X, r)
    additive = a[:, None, :] + b[None, :, :]
    mult = torch.einsum("itr,jtr->ijt", U, V)
    return additive + mult


def dyadic_mean_temporal(X: torch.Tensor, r: int) -> torch.Tensor:
    """Mean structure for all time steps: (n, n, T, 2) with
    ``mu[i, j, t] = [a_i+b_j+U_i.V_j, a_j+b_i+U_j.V_i]``."""
    fwd = dyadic_fwd_temporal(X, r)
    return torch.stack([fwd, fwd.transpose(0, 1)], dim=-1)


def offdiag_mask(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(n, n) mask that zeroes the diagonal."""
    return 1.0 - torch.eye(n, dtype=dtype, device=device)


def residual_stats_from_fwd(Y: torch.Tensor, fwd: torch.Tensor):
    """``(sq, cross)`` of the off-diagonal residuals ``e0 = Y[..., 0] - fwd``:

        sq    = sum_{i != j, t} e0[i,j,t]^2
        cross = sum_{i != j, t} e0[i,j,t] * e0[j,i,t]
    """
    n = Y.shape[0]
    e0 = (Y[..., 0] - fwd) * offdiag_mask(n, Y.dtype, Y.device)[:, :, None]
    sq = torch.sum(e0 * e0)
    cross = torch.sum(e0 * e0.transpose(0, 1))
    return sq, cross


def symmetrize_dyads(D: torch.Tensor) -> torch.Tensor:
    """Impose the reciprocity layout on a raw upper-triangle dyad tensor:
    ``Y[i,j] = D[i,j]`` for i<j, ``Y[j,i] = D[i,j][::-1]``, zero diagonal."""
    n = D.shape[0]
    i = torch.arange(n, device=D.device)
    shape = (n, n) + (1,) * (D.ndim - 2)
    upper = (i[:, None] < i[None, :]).reshape(shape)
    lower = (i[:, None] > i[None, :]).reshape(shape)
    swapped = D.transpose(0, 1).flip(-1)
    zero = torch.zeros((), dtype=D.dtype, device=D.device)
    return torch.where(upper, D, torch.where(lower, swapped, zero))


def masked_sq_error_temporal(Y: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """``sum_{i != j, t} ||Y[i,j,t] - mu[i,j,t]||^2 / (n (n-1) T)``."""
    n, _, T, _ = Y.shape
    mask = offdiag_mask(n, Y.dtype, Y.device)[:, :, None, None]
    return torch.sum(((Y - mu) ** 2) * mask) / (n * (n - 1) * T)
