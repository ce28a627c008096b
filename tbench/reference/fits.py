"""Plain reference of the fits the benchmark times: damped block
coordinate ascent for the Good structured mean field (a full d x d
covariance per node and time) and for the smoothed family (one joint
Gaussian per node trajectory), each with its ELBO after every iteration.

The observation terms of node i, given its partners' means, are written
as the model defines them.  Its state x_i = [a_i, b_i, U_i, V_i] enters
the pair (y_ij, y_ji) through

    J_ij = [[1, 0, V_j, 0],        (y_ij = a_i + b_j + U_i . V_j)
            [0, 1, 0, U_j]]        (y_ji = a_j + b_i + U_j . V_i)

so over the observed partners j (mask m_ij, never j = i)

    P_obs_i   = sum_j m_ij J_ij' R^-1 J_ij
    eta_obs_i = sum_j m_ij J_ij' R^-1 ((y_ij, y_ji) - offset_ij)

with offset 0 (the Good-SMF engines' plug-in) or the partner's additive
terms (b_j, a_j) (``corrected``, the smoothed engine's).  A phase updates
one block of nodes against the freshest means of all others; blocks run
in order.  The prior adds Sigma0^-1 at t = 0, Q^-1 for t > 0 and
Phi' Q^-1 Phi for t < T - 1.

Good SMF: each (i, t) factor's precision is P_obs + prior and its natural
parameter adds Q^-1 Phi mu_{t-1} and Phi' Q^-1 mu_{t+1}; the covariance is
the symmetrised inverse plus 1e-6 I, the mean that covariance times the
natural parameter; both are damped with the learning rate.

Smoothed: a node's trajectory precision is block tridiagonal, diagonal
blocks P_obs_t + prior_t and (t, t+1) blocks -Phi' Q^-1; it is solved by
block elimination forward and substitution backward, giving the means
(damped), the marginal and lag-one covariances and log det of the
precision (not damped).

Nothing here reads the program: inputs are the benchmark's tensors and
the configuration's numbers.  Data live time-major, (T, n, n).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tbench.reference.model import LOG2PI, Params, Precision


class Data(NamedTuple):
    """A network in the reference's precision, time-major."""

    Y0: torch.Tensor          # (T, n, n) y_ij^t, hidden entries 0
    Y1: torch.Tensor          # (T, n, n) y_ji^t as stored in Y[i, j, t, 1]
    mask: torch.Tensor        # (T, n, n) or (1, n, n): observed, 0 on i = j
    W0: torch.Tensor          # (T, n, n) p y_ij + q y_ji
    W1: torch.Tensor          # (T, n, n) q y_ij + p y_ji
    cnt: torch.Tensor         # (n, T) observed partners of (i, t)
    n_dyads: torch.Tensor     # observed unordered dyad-times


def prepare(Y: torch.Tensor, mask: Optional[torch.Tensor], params: Params,
            prec: Precision) -> Data:
    """``Y`` (n, n, T, 2) and an optional (n, n, T) mask of the benchmark,
    cast to the reference's precision."""
    n, _, T, _ = Y.shape
    off = 1.0 - torch.eye(n, dtype=prec.dtype, device=Y.device)
    if mask is None:
        m = off[None]
    else:
        m = mask.permute(2, 0, 1).to(prec.dtype).contiguous() * off
    Y0, Y1 = (Y[..., k].permute(2, 0, 1).to(prec.dtype).contiguous() * m
              for k in (0, 1))
    p, q = params.R_inv[0, 0], params.R_inv[0, 1]
    cnt = m.expand(T, n, n).sum(-1).T.contiguous()
    return Data(Y0=Y0, Y1=Y1, mask=m, W0=p * Y0 + q * Y1,
                W1=q * Y0 + p * Y1, cnt=cnt, n_dyads=0.5 * cnt.sum())


def partner_sum(data: Data, rows: slice, Z: torch.Tensor,
                prec: Precision) -> torch.Tensor:
    """``sum_j m_ij Z_j`` for the nodes ``rows``: Z (n, T, K) ->
    (m, T, K)."""
    M = data.mask[:, rows]                              # (T or 1, m, n)
    return prec.mm(M, Z.transpose(0, 1)).transpose(0, 1)


def _split(X: torch.Tensor):
    r = (X.shape[-1] - 2) // 2
    return X[..., 0], X[..., 1], X[..., 2:2 + r], X[..., 2 + r:]


def jacobian_rows(X: torch.Tensor):
    """(J0_j, J1_j) of every partner j: [1, 0, V_j, 0] and [0, 1, 0, U_j],
    each (n, T, d)."""
    _, _, U, V = _split(X)
    one, zero = torch.ones_like(U[..., :1]), torch.zeros_like(U[..., :1])
    J0 = torch.cat([one, zero, V, torch.zeros_like(U)], -1)
    J1 = torch.cat([zero, one, torch.zeros_like(V), U], -1)
    return J0, J1


def obs_terms(X: torch.Tensor, rows: slice, data: Data, params: Params,
              prec: Precision, corrected: bool):
    """``(P_obs (m, T, d, d), eta_obs (m, T, d))`` of the nodes ``rows``
    against the partners' means ``X``."""
    n, T, d = X.shape
    p, q = params.R_inv[0, 0], params.R_inv[0, 1]
    J0, J1 = jacobian_rows(X)
    outer = lambda A, B: (A[..., :, None] * B[..., None, :]).reshape(  # noqa
        n, T, d * d)
    S = partner_sum(data, rows, torch.cat(
        [outer(J0, J0), outer(J1, J1), outer(J0, J1)], -1), prec)
    m = S.shape[0]
    A00, A11, A01 = (s.reshape(m, T, d, d) for s in S.split(d * d, -1))
    P = p * (A00 + A11) + q * (A01 + A01.transpose(-1, -2))
    eta = (prec.mm(data.W0[:, rows], J0.transpose(0, 1))
           + prec.mm(data.W1[:, rows], J1.transpose(0, 1))).transpose(0, 1)
    if corrected:
        a, b, _, _ = _split(X)
        c = (p * b + q * a)[..., None]     # R^-1 (b_j, a_j), first entry
        e = (q * b + p * a)[..., None]     # and second
        eta = eta - partner_sum(data, rows, c * J0 + e * J1, prec)
    return P, eta


class Prior(NamedTuple):
    P: torch.Tensor         # (T, d, d) prior precision per time
    Qinv_Phi: torch.Tensor  # Q^-1 Phi
    Sigma0_inv: torch.Tensor
    Q_inv: torch.Tensor
    PhiT_Qinv_Phi: torch.Tensor
    logdet_Sigma0: torch.Tensor
    logdet_Q: torch.Tensor
    logdet_R: torch.Tensor


def prior(params: Params, T: int, prec: Precision) -> Prior:
    s0i = torch.linalg.inv(params.Sigma0)
    qi = torch.linalg.inv(params.Q)
    qp = prec.mm(qi, params.Phi)
    ptqp = prec.mm(params.Phi.T, qp)
    t = torch.arange(T, device=qi.device)[:, None, None]
    P = (t == 0) * s0i + (t > 0) * qi + (t < T - 1) * ptqp
    return Prior(P=P, Qinv_Phi=qp, Sigma0_inv=s0i, Q_inv=qi,
                 PhiT_Qinv_Phi=ptqp,
                 logdet_Sigma0=torch.logdet(params.Sigma0),
                 logdet_Q=torch.logdet(params.Q),
                 logdet_R=torch.logdet(params.R))


def _mv(A: torch.Tensor, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.mm(A, x[..., None])[..., 0]


# ---------------------------------------------------------------------------
# Likelihood part of the ELBO (both families)
# ---------------------------------------------------------------------------

def quad_sum(X: torch.Tensor, data: Data, params: Params, prec: Precision,
             chunk: int = 5) -> torch.Tensor:
    """``sum over observed unordered dyad-times of r' R^-1 r`` at the
    means, r = (y_ij - mu_ij, y_ji - mu_ji); time steps in chunks."""
    a, b, U, V = (t.transpose(0, 1) for t in _split(X))    # time-major
    p, q = params.R_inv[0, 0], params.R_inv[0, 1]
    total = X.new_zeros(())
    T = a.shape[0]
    for t0 in range(0, T, chunk):
        s = slice(t0, t0 + chunk)
        fwd = (a[s][:, :, None] + b[s][:, None, :]
               + prec.mm(U[s], V[s].transpose(1, 2)))       # mu_ij
        e0 = data.Y0[s] - fwd
        e1 = data.Y1[s] - fwd.transpose(1, 2)             # y_ji - mu_ji
        m = data.mask if data.mask.shape[0] == 1 else data.mask[s]
        total = total + 0.5 * torch.sum(
            (p * (e0 * e0 + e1 * e1) + 2.0 * q * e0 * e1) * m)
    return total


def log_likelihood(X, cov, data, params, pri, prec) -> torch.Tensor:
    """Plug-in Gaussian likelihood at the means, with the structured
    families' trace correction ``0.1 tr(R^-1) / d`` times each observed
    dyad's covariance traces."""
    d = X.shape[-1]
    tr_cov = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)     # (n, T)
    wsum = torch.sum(data.cnt * tr_cov)
    ll = -0.5 * (quad_sum(X, data, params, prec)
                 + data.n_dyads * (pri.logdet_R + 2.0 * LOG2PI))
    return ll - 0.5 * (0.1 * torch.trace(params.R_inv) / d * wsum)


def _quad(x: torch.Tensor, A: torch.Tensor, prec: Precision) -> torch.Tensor:
    return torch.sum(x * _mv(A, x, prec))


def _trace_with(A: torch.Tensor, S: torch.Tensor, prec: Precision):
    """``sum over a batch of tr(A S)``."""
    return torch.sum(torch.diagonal(prec.mm(A, S), dim1=-2, dim2=-1))


# ---------------------------------------------------------------------------
# Good structured mean field
# ---------------------------------------------------------------------------

def smf_elbo(X, cov, data, params, pri, prec) -> torch.Tensor:
    """Likelihood, the expected log priors of each factor's mean and
    covariance (transitions at the means only, as the structured engines
    define it), and the factors' Gaussian entropy."""
    n, T, d = X.shape
    mu0 = X[:, 0]
    prior0 = -0.5 * (_quad(mu0, pri.Sigma0_inv, prec)
                     + _trace_with(pri.Sigma0_inv, cov[:, 0], prec)
                     + n * (pri.logdet_Sigma0 + d * LOG2PI))
    resid = X[:, 1:] - _mv(params.Phi, X[:, :-1], prec)
    priort = -0.5 * (_quad(resid, pri.Q_inv, prec)
                     + _trace_with(pri.Q_inv, cov[:, 1:], prec)
                     + n * (T - 1) * (pri.logdet_Q + d * LOG2PI))
    L = torch.linalg.cholesky(cov)
    logdets = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    entropy = 0.5 * torch.sum(logdets + d * (1.0 + LOG2PI))
    return (log_likelihood(X, cov, data, params, pri, prec) + prior0 + priort
            + entropy)


def smf_step(X, cov, data, params, pri, prec, lr: float, num_blocks: int,
             corrected: bool) -> None:
    """One iteration of block coordinate ascent, in place."""
    n, T, d = X.shape
    bs = n // num_blocks
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    zero = X.new_zeros(X[:, :1].shape)
    for blk in range(num_blocks):
        rows = slice(blk * bs, (blk + 1) * bs)
        P_obs, eta = obs_terms(X, rows, data, params, prec, corrected)
        Xb = X[rows]
        prev = torch.cat([zero[rows], Xb[:, :-1]], 1)
        nxt = torch.cat([Xb[:, 1:], zero[rows]], 1)
        eta = (eta + _mv(pri.Qinv_Phi, prev, prec)
               + _mv(pri.Qinv_Phi.T, nxt, prec))
        inv = torch.linalg.inv(P_obs + pri.P)
        new_cov = 0.5 * (inv + inv.transpose(-1, -2)) + 1e-6 * eye
        new_mean = _mv(new_cov, eta, prec)
        X[rows] = lr * new_mean + (1.0 - lr) * Xb
        cov[rows] = lr * new_cov + (1.0 - lr) * cov[rows]


# ---------------------------------------------------------------------------
# Smoothed family
# ---------------------------------------------------------------------------

class Trajectories(NamedTuple):
    mean: torch.Tensor      # (m, T, d)
    cov: torch.Tensor       # (m, T, d, d)
    cross: torch.Tensor     # (m, T-1, d, d) Cov(x_t, x_{t+1})
    logdet: torch.Tensor    # (m,) log det of each trajectory's precision


def solve_trajectories(D: torch.Tensor, O: torch.Tensor, b: torch.Tensor,
                       prec: Precision) -> Trajectories:
    """Block-tridiagonal systems, diagonal blocks D (m, T, d, d), every
    (t, t+1) block O and (t+1, t) block O', right sides b (m, T, d)."""
    m, T, d, _ = D.shape
    S_inv, c = [], []
    logdet = D.new_zeros(m)
    for t in range(T):
        S, ct = D[:, t], b[:, t]
        if t:
            OtSi = prec.mm(O.T, S_inv[-1])
            S = S - prec.mm(OtSi, O)
            ct = ct - _mv(OtSi, c[-1], prec)
        logdet = logdet + torch.logdet(S)
        S_inv.append(torch.linalg.inv(S))
        c.append(ct)
    mean, cov = [None] * T, [None] * T
    cross = [None] * (T - 1)
    mean[T - 1] = _mv(S_inv[T - 1], c[T - 1], prec)
    cov[T - 1] = S_inv[T - 1]
    for t in range(T - 2, -1, -1):
        mean[t] = _mv(S_inv[t], c[t] - _mv(O, mean[t + 1], prec), prec)
        G = prec.mm(S_inv[t], O)
        GS = prec.mm(G, cov[t + 1])
        cov[t] = S_inv[t] + prec.mm(GS, G.transpose(-1, -2))
        cross[t] = -GS
    return Trajectories(
        mean=torch.stack(mean, 1), cov=torch.stack(cov, 1),
        cross=(torch.stack(cross, 1) if T > 1
               else D.new_zeros((m, 0, d, d))), logdet=logdet)


class SmoothedState(NamedTuple):
    X: torch.Tensor
    cov: torch.Tensor
    cross: torch.Tensor
    logdets: torch.Tensor


def smoothed_step(st: SmoothedState, data, params, pri, prec, lr: float,
                  num_blocks: int, corrected: bool) -> None:
    """One iteration over the node blocks, in place."""
    n = st.X.shape[0]
    bs = n // num_blocks
    O = -pri.Qinv_Phi.T
    for blk in range(num_blocks):
        rows = slice(blk * bs, (blk + 1) * bs)
        P_obs, eta = obs_terms(st.X, rows, data, params, prec, corrected)
        out = solve_trajectories(P_obs + pri.P, O, eta, prec)
        st.X[rows] = lr * out.mean + (1.0 - lr) * st.X[rows]
        st.cov[rows] = out.cov
        st.cross[rows] = out.cross
        st.logdets[rows] = out.logdet


def smoothed_elbo(st: SmoothedState, data, params, pri, prec) -> torch.Tensor:
    """Likelihood as the structured engines, the exact expected log prior
    with lag-one cross-covariances, and the joint trajectories' entropy."""
    X, cov = st.X, st.cov
    n, T, d = X.shape
    mu0 = X[:, 0]
    prior0 = -0.5 * (_quad(mu0, pri.Sigma0_inv, prec)
                     + _trace_with(pri.Sigma0_inv, cov[:, 0], prec)
                     + n * (pri.logdet_Sigma0 + d * LOG2PI))
    priort = X.new_zeros(())
    if T > 1:
        resid = X[:, 1:] - _mv(params.Phi, X[:, :-1], prec)
        # E[(x_t - Phi x_{t-1})' Q^-1 (x_t - Phi x_{t-1})]
        priort = -0.5 * (_quad(resid, pri.Q_inv, prec)
                         + _trace_with(pri.Q_inv, cov[:, 1:], prec)
                         + _trace_with(pri.PhiT_Qinv_Phi, cov[:, :-1], prec)
                         - 2.0 * _trace_with(pri.Qinv_Phi, st.cross, prec)
                         + n * (T - 1) * (pri.logdet_Q + d * LOG2PI))
    entropy = 0.5 * (n * T * d * (1.0 + LOG2PI) - torch.sum(st.logdets))
    return (log_likelihood(X, cov, data, params, pri, prec) + prior0 + priort
            + entropy)
