"""Time-parallel exact AR(1) smoothing by associative scans (counterpart of
:mod:`tame.ops.ptridiag`).

:func:`tame_torch.ops.tridiag.block_tridiag_smoother` (and K4 on the card)
solves each node's block-tridiagonal trajectory system with a chain of T
dependent forward and T - 1 backward steps.  This module gives the same
solution in O(log T) depth with the conditional-Gaussian elements of the
parallel Kalman filter and smoother (Särkkä & García-Fernández, "Temporal
Parallelization of Bayesian Smoothers", IEEE TAC 2021): each time step
becomes an element of an associative scan, and the smoothed marginals come
out of its prefix and suffix products.  Every combine works with
covariance-form conditional Gaussians (PSD matrices and solves against
``I + C J``, whose eigenvalues are >= 1), so the products stay bounded at
any T.

Inputs are the model quantities, not the precision blocks: per-time
observation information ``J_t = Pobs[t]`` (PSD) and information vector
``eta_t``, and the AR(1) prior ``(Phi, Q, Sigma0)``.  The implied joint
precision is the sequential solver's system

    D_t = J_t + [t=0] Sigma0^-1 + [t>0] Q^-1 + [t<T-1] Phi' Q^-1 Phi
    O   = -Phi' Q^-1

The filter element of step k >= 1 carries ``(A, b, C, eta, J)`` with
``p(x_k | x_{k-1}, y_k) = N(A x_{k-1} + b, C)`` and the back-propagated
likelihood ``p(y_k | x_{k-1}) ~ exp(eta'x - x'Jx/2)``:

    Lam = Q^-1 + J_k            A = Lam^-1 Q^-1 Phi     C = Lam^-1
    b = Lam^-1 eta_k            eta = A' eta_k
    J = Phi'Q^-1 Phi - (Q^-1 Phi)' Lam^-1 (Q^-1 Phi)

The smoother element carries the affine backward map ``(G_t, g_t, L_t)``
with ``m_t|T = G_t m_{t+1|T} + g_t`` and ``P_t|T = G_t P_{t+1|T} G_t' +
L_t``; the lag-1 cross-covariances are ``G_t P_{t+1|T}`` and the joint
precision's log determinant is ``-(logdet P_T|T + sum_t logdet L_t)``.

The JAX module ``vmap``s one trajectory; here a leading node axis is
written out (``Pobs`` (n, T, d, d), ``eta`` (n, T, d), one log determinant
per node) and every combine is one batched op over nodes and time pairs.
torch has no ``associative_scan``: :func:`associative_scan` is a copy of
JAX's odd/even recursion, so the combine tree, and with it the float32
rounding, is the JAX package's.  The solves use ``solve_ex`` /
``cholesky_ex`` / ``inv_ex``, which read no error flag back to the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tame_torch.ops.cholesky import _cholesky_nan
from tame_torch.ops.tridiag import SmootherResult


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


def _t(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + _t(M))


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, B)[0]


def _inv(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(A)[0]


class _FilterElem(NamedTuple):
    A: torch.Tensor    # (..., d, d)
    b: torch.Tensor    # (..., d)
    C: torch.Tensor    # (..., d, d)
    eta: torch.Tensor  # (..., d)
    J: torch.Tensor    # (..., d, d)


def _filter_combine(e1: _FilterElem, e2: _FilterElem) -> _FilterElem:
    """Associative combine of conditional-Gaussian filter elements
    (Särkkä & García-Fernández 2021, Lemma 8).  The three solves against
    ``M`` share one factorization (one right-hand side of 2d + 1 columns),
    as do the two against ``M'``."""
    d = e1.A.shape[-1]
    M = torch.eye(d, dtype=e1.A.dtype, device=e1.A.device) + e1.C @ e2.J
    bc = e1.b + _mv(e1.C, e2.eta)
    X = _solve(M, torch.cat([e1.A, e1.C, bc[..., None]], -1))
    Minv_A1, Minv_C1, Minv_bc = X[..., :d], X[..., d:2 * d], X[..., 2 * d]
    A = e2.A @ Minv_A1
    b = _mv(e2.A, Minv_bc) + e2.b
    C = _sym(e2.A @ Minv_C1 @ _t(e2.A) + e2.C)
    # (I + J2 C1) = M' for symmetric C and J
    rhs_eta = e2.eta - _mv(e2.J, e1.b)
    Y = _solve(_t(M), torch.cat([rhs_eta[..., None], e2.J @ e1.A], -1))
    eta = _mv(_t(e1.A), Y[..., 0]) + e1.eta
    J = _sym(_t(e1.A) @ Y[..., 1:] + e1.J)
    return _FilterElem(A=A, b=b, C=C, eta=eta, J=J)


class _SmoothElem(NamedTuple):
    E: torch.Tensor  # (..., d, d)
    g: torch.Tensor  # (..., d)
    L: torch.Tensor  # (..., d, d)


def _smooth_combine(e1: _SmoothElem, e2: _SmoothElem) -> _SmoothElem:
    """Associative combine of affine backward maps, oriented for
    ``associative_scan(..., reverse=True)``: the scan hands the combined
    later suffix as ``e1`` and the element closer to t as ``e2``, and the
    composed map applies e2 after e1's suffix."""
    return _SmoothElem(E=e2.E @ e1.E, g=_mv(e2.E, e1.g) + e2.g,
                       L=_sym(e2.E @ e1.L @ _t(e2.E) + e2.L))


def associative_scan(fn: Callable, elems: tuple, reverse: bool = False,
                     dim: int = 1) -> tuple:
    """Inclusive scan of ``elems`` (a tuple of tensors of one length along
    ``dim``) under the associative ``fn(a, b)``, in O(log length) depth:
    JAX's ``lax.associative_scan`` recursion (combine adjacent pairs, scan
    the half-length result, fill in the even positions), so the same
    combines happen in the same order.  ``reverse=True`` scans from the
    end: element k is the combination of elements k..last, the later ones
    passed as ``fn``'s first argument."""
    kind = type(elems)
    rebuild = ((lambda es: kind(*es)) if hasattr(kind, "_fields")
               else kind)

    def sl(e, start, stop=None, step=1):
        idx = [slice(None)] * e.dim()
        idx[dim] = slice(start, stop, step)
        return e[tuple(idx)]

    def combine(a, b):
        return tuple(fn(rebuild(a), rebuild(b)))

    def interleave(a, b):
        """a at the even positions, b at the odd ones; len(a) is len(b)
        or len(b) + 1."""
        shape = list(a.shape)
        shape[dim] = a.shape[dim] + b.shape[dim]
        out = a.new_empty(shape)
        sl(out, 0, None, 2).copy_(a)
        sl(out, 1, None, 2).copy_(b)
        return out

    def scan(es):
        num = es[0].shape[dim]
        if num < 2:
            return es
        reduced = combine([sl(e, 0, num - 1, 2) for e in es],
                          [sl(e, 1, None, 2) for e in es])
        odd = scan(reduced)
        if num % 2 == 0:
            even = combine([sl(e, 0, -1) for e in odd],
                           [sl(e, 2, None, 2) for e in es])
        else:
            even = combine(odd, [sl(e, 2, None, 2) for e in es])
        even = [torch.cat([sl(e, 0, 1), r], dim) for e, r in zip(es, even)]
        return tuple(interleave(a, b) for a, b in zip(even, odd))

    flat = tuple(elems)
    if reverse:
        flat = tuple(e.flip(dim) for e in flat)
    out = scan(flat)
    if reverse:
        out = tuple(e.flip(dim) for e in out)
    return rebuild(out)


def parallel_block_tridiag_smoother(Pobs: torch.Tensor, eta: torch.Tensor,
                                    Phi: torch.Tensor, Q: torch.Tensor,
                                    Sigma0: torch.Tensor) -> SmootherResult:
    """Exact trajectory smoothing of n nodes in O(log T) depth.

    ``Pobs`` (n, T, d, d) per-time observation information (PSD), ``eta``
    (n, T, d) information vectors, ``Phi``, ``Q``, ``Sigma0`` (d, d) the
    AR(1) prior.  Returns the :class:`~tame_torch.ops.tridiag.
    SmootherResult` of the implied block-tridiagonal systems: means (n, T,
    d), marginal covariances (n, T, d, d), lag-1 cross-covariances (n,
    T-1, d, d) and each node's joint-precision log determinant (n,).  A
    system that is not positive definite gives NaN, not an exception."""
    n, T, d, _ = Pobs.shape
    eye = torch.eye(d, dtype=Pobs.dtype, device=Pobs.device)
    Q_inv = _inv(Q)
    S0_inv = _inv(Sigma0)
    QinvPhi = Q_inv @ Phi
    PhiT_Qinv_Phi = _t(Phi) @ QinvPhi

    if T == 1:
        chol = _cholesky_nan(S0_inv + Pobs[:, 0])
        cov = torch.cholesky_solve(eye.expand(n, d, d), chol)
        logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2,
                                                dim2=-1)).sum(-1)
        return SmootherResult(mean=_mv(cov, eta[:, 0])[:, None],
                              cov=_sym(cov)[:, None],
                              cross_cov=Pobs.new_zeros((n, 0, d, d)),
                              logdet=logdet)

    # -- filter elements ---------------------------------------------------
    # k = 0 absorbs the initial prior directly
    P11 = _inv(S0_inv + Pobs[:, 0])
    zeros_dd = Pobs.new_zeros((n, 1, d, d))
    # k >= 1
    Lam = Q_inv + Pobs[:, 1:]                              # (n, T-1, d, d)
    Lam_inv = torch.cholesky_solve(eye.expand_as(Lam), _cholesky_nan(Lam))
    A = Lam_inv @ QinvPhi
    J_el = _sym(PhiT_Qinv_Phi - _t(QinvPhi) @ (Lam_inv @ QinvPhi))
    elems = _FilterElem(
        A=torch.cat([zeros_dd, A], 1),
        b=torch.cat([_mv(P11, eta[:, 0])[:, None], _mv(Lam_inv, eta[:, 1:])],
                    1),
        C=torch.cat([_sym(P11)[:, None], _sym(Lam_inv)], 1),
        eta=torch.cat([eta.new_zeros((n, 1, d)), _mv(_t(A), eta[:, 1:])], 1),
        J=torch.cat([zeros_dd, J_el], 1))
    filt = associative_scan(_filter_combine, elems)
    m_f, P_f = filt.b, filt.C                  # m_t|t (n, T, d), P_t|t

    # -- smoothing gains and backward conditional moments (parallel in t) --
    m_p = _mv(Phi, m_f[:, :-1])                            # m_{t+1|t}
    PhiP = Phi @ P_f[:, :-1]
    P_p = _sym(PhiP @ _t(Phi) + Q)
    # G_t = P_t|t Phi' P_{t+1|t}^-1, solved from the symmetric side
    G = _t(_solve(P_p, PhiP))
    g = m_f[:, :-1] - _mv(G, m_p)
    L = _sym(P_f[:, :-1] - G @ P_p @ _t(G))
    sm = associative_scan(_smooth_combine, _SmoothElem(
        E=torch.cat([G, zeros_dd], 1),
        g=torch.cat([g, m_f[:, -1:]], 1),
        L=torch.cat([L, P_f[:, -1:]], 1)), reverse=True)
    cov = sm.L
    # det Cov_joint = det P_T|T * prod_t det L_t
    logdet = -(torch.linalg.slogdet(P_f[:, -1])[1]
               + torch.linalg.slogdet(L)[1].sum(-1))
    return SmootherResult(mean=sm.g, cov=cov, cross_cov=G @ cov[:, 1:],
                          logdet=logdet)
