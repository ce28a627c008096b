"""Block-tridiagonal Gaussian solves: exact AR(1) forward-backward
smoothing (counterpart of :mod:`tame.ops.tridiag`).

The exact conditional posterior of one node's whole trajectory given the
other nodes is a Gaussian whose precision is block tridiagonal:

    D_t = P_obs[t] + prior_diag[t]          (d x d diagonal blocks)
    O   = -Phi' Q^-1                         (constant super-diagonal block)

solved by block Thomas elimination and an RTS-style backward pass:

    forward:   S_0 = D_0,    S_t = D_t - O' S_{t-1}^-1 O
               c_0 = b_0,    c_t = b_t - O' S_{t-1}^-1 c_{t-1}
    backward:  mu_{T-1} = S_{T-1}^-1 c_{T-1},  Sig_{T-1} = S_{T-1}^-1
               mu_t  = S_t^-1 (c_t - O mu_{t+1})
               Sig_t = S_t^-1 + G_t Sig_{t+1} G_t',   G_t = S_t^-1 O
               C_{t,t+1} = -G_t Sig_{t+1}
    logdet = sum_t log det S_t

The JAX module ``vmap``s one trajectory; here the node dimension is written
out and every step is one batched op over all nodes, a Python loop over T.
:func:`block_tridiag_smoother` is also the plain twin of the K4 kernel
(:mod:`tame_torch.ops.fused_smoother`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tame_torch.ops.cholesky import _cholesky_nan


class SmootherResult(NamedTuple):
    mean: torch.Tensor        # (n, T, d)
    cov: torch.Tensor         # (n, T, d, d)    marginal covariances
    cross_cov: torch.Tensor   # (n, T-1, d, d)  Cov(X_t, X_{t+1})
    logdet: torch.Tensor      # (n,) log det of each node's T d precision


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def block_tridiag_smoother(D: torch.Tensor, O: torch.Tensor,
                           b: torch.Tensor) -> SmootherResult:
    """Solve n independent block-tridiagonal Gaussian systems.

    D (n, T, d, d) SPD diagonal precision blocks, O (d, d) the constant
    (t, t+1) coupling block, b (n, T, d) natural parameters.  A pivot S_t
    that is not positive definite gives NaN for that node, not an
    exception, so a blown-up fit halts as ``diverged``.
    """
    n, T, d, _ = D.shape
    eye = torch.eye(d, dtype=D.dtype, device=D.device).expand(n, d, d)
    S_inv = torch.empty_like(D)
    c = torch.empty_like(b)
    logdet = D.new_zeros(n)

    def invert(S_t, t):
        nonlocal logdet
        L = _cholesky_nan(S_t)
        S_inv[:, t] = torch.cholesky_solve(eye, L)
        logdet = logdet + 2.0 * torch.log(
            torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)

    # -- forward elimination ----------------------------------------------
    c[:, 0] = b[:, 0]
    invert(D[:, 0], 0)
    for t in range(1, T):
        OtS = O.T @ S_inv[:, t - 1]                      # O' S_{t-1}^-1
        c[:, t] = b[:, t] - _mv(OtS, c[:, t - 1])
        invert(D[:, t] - OtS @ O, t)

    # -- backward substitution --------------------------------------------
    G = S_inv @ O                                        # G_{T-1} unused
    mean = torch.empty_like(b)
    cov = torch.empty_like(D)
    cross = D.new_empty((n, max(T - 1, 0), d, d))
    mean[:, T - 1] = _mv(S_inv[:, T - 1], c[:, T - 1])
    cov[:, T - 1] = S_inv[:, T - 1]
    for t in range(T - 2, -1, -1):
        mean[:, t] = _mv(S_inv[:, t], c[:, t] - _mv(O, mean[:, t + 1]))
        GS = G[:, t] @ cov[:, t + 1]
        cov[:, t] = S_inv[:, t] + GS @ G[:, t].transpose(-1, -2)
        cross[:, t] = -GS
    return SmootherResult(mean=mean, cov=cov, cross_cov=cross, logdet=logdet)


def dense_precision(D: torch.Tensor, O: torch.Tensor) -> torch.Tensor:
    """Materialize one trajectory's full (T d, T d) precision from D
    (T, d, d) (testing / tiny T only)."""
    T, d, _ = D.shape
    P = D.new_zeros((T * d, T * d))
    for t in range(T):
        P[t * d:(t + 1) * d, t * d:(t + 1) * d] = D[t]
        if t + 1 < T:
            P[t * d:(t + 1) * d, (t + 1) * d:(t + 2) * d] = O
            P[(t + 1) * d:(t + 2) * d, t * d:(t + 1) * d] = O.T
    return P
