"""Batched damped-CAVI engine for the temporal AME family, dense float32
path (counterpart of :mod:`tame.inference.cavi`).

One coordinate-ascent engine parameterized by a covariance-structure
policy: ``"diag"`` (naive mean field), ``"full"`` (good structured MF) and
``"block"`` (bad structured MF).  With R^-1 = [[p, q], [q, p]] the
observation terms of factor (i, t) collapse into global sufficient
statistics per time step (see the JAX module's docstring for the algebra):

    P_obs[i,t] = assembled from sU, sV, GUU, GVV, GVU minus node i's term
    eta_obs[i,t] = [ sum_j W0_ij, sum_j W1_ij, (W0 @ V)_i, (W1 @ U)_i ]

with W0 = p Y[...,0] + q Y[...,1] and W1 = q Y[...,0] + p Y[...,1].  The
``W @ Z`` contractions are plain batched matrix products (``torch.einsum``,
full float32: TF32 is off, see the package docstring).  The d x d solves and
the entropy's log-determinants go through :mod:`tame_torch.ops.cholesky`;
a whole small fit on the card goes through :mod:`tame_torch.ops.fused_fit`.

PyTorch has no device ``while_loop``: :func:`fit_loop` is a Python loop
that reads each iteration's ELBO on the host and applies the JAX loop's
stopping rule in float32.  The port updates the state in place, block by
block, on its own copy of the initial state.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from tame_torch.models.params import AMEParams, _fields_as_tensors
from tame_torch.ops import dyad as dyad_ops
from tame_torch.ops import fused_fit
from tame_torch.ops.cholesky import (
    batched_logdet_spd,
    batched_spd_solve,
    batched_spd_solve_inv,
)

_LOG2PI = 1.8378770664093453  # log(2 * pi)


class ObsConstants(NamedTuple):
    """Data-dependent quantities that are constant across CAVI iterations."""

    W0: torch.Tensor     # (n, n, T)  p*y_ij + q*y_ji
    W1: torch.Tensor     # (n, n, T)  q*y_ij + p*y_ji
    eta_a: torch.Tensor  # (n, T)     row-sums of W0
    eta_b: torch.Tensor  # (n, T)     row-sums of W1


class PriorMatrices(NamedTuple):
    """Precomputed prior/transition matrices (all (d, d)) and log-dets."""

    Sigma0_inv: torch.Tensor
    Q_inv: torch.Tensor
    Qinv_Phi: torch.Tensor        # Q^-1 Phi
    PhiT_Qinv_Phi: torch.Tensor   # Phi' Q^-1 Phi
    logdet_Sigma0: torch.Tensor
    logdet_Q: torch.Tensor
    logdet_R: torch.Tensor


class CaviState(NamedTuple):
    X_mean: torch.Tensor  # (n, T, d)
    X_cov: torch.Tensor   # (n, T, d, d)


class FitResult(NamedTuple):
    X_mean: torch.Tensor         # (n, T, d)
    X_cov: torch.Tensor          # (n, T, d, d)
    elbo_history: torch.Tensor   # (buf,) on the CPU, NaN past the stop
    mse_history: torch.Tensor    # (buf,)
    n_iter: int
    converged: bool
    diverged: bool               # ELBO went non-finite; fit halted
    last_elbo: float             # convergence carry for a follow-up fit
    pat_count: int


def state_from_numpy(s, device=None, dtype=torch.float32) -> CaviState:
    """Port's :class:`CaviState` from any object (or dict) holding
    ``X_mean``/``X_cov`` arrays (e.g. the JAX ``CaviState``)."""
    return CaviState(**_fields_as_tensors(s, CaviState._fields, device,
                                          dtype))


def precompute_obs_constants(Y: torch.Tensor,
                             R_inv: torch.Tensor) -> ObsConstants:
    """Dyad weights and their row sums; constant across CAVI iterations."""
    p, q = R_inv[0, 0], R_inv[0, 1]
    W0 = p * Y[..., 0] + q * Y[..., 1]
    W1 = q * Y[..., 0] + p * Y[..., 1]
    return ObsConstants(W0=W0, W1=W1, eta_a=W0.sum(1), eta_b=W1.sum(1))


def _eta_contract(W: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """``einsum("ijt,jtr->itr")``: the engine's dominant contraction."""
    return torch.einsum("ijt,jtr->itr", W, Z)


def precompute_priors(params: AMEParams) -> PriorMatrices:
    Q_inv = torch.linalg.inv(params.Q)
    return PriorMatrices(
        Sigma0_inv=torch.linalg.inv(params.Sigma0),
        Q_inv=Q_inv,
        Qinv_Phi=Q_inv @ params.Phi,
        PhiT_Qinv_Phi=params.Phi.T @ Q_inv @ params.Phi,
        logdet_Sigma0=torch.linalg.slogdet(params.Sigma0)[1],
        logdet_Q=torch.linalg.slogdet(params.Q)[1],
        logdet_R=torch.linalg.slogdet(params.R)[1],
    )


# ---------------------------------------------------------------------------
# Observation-term assembly
# ---------------------------------------------------------------------------

def _gram(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``sum_j A_j B_j'`` per time step: (n, T, r) x (n, T, r) -> (T, r, r)."""
    return torch.einsum("jtk,jtl->tkl", A, B)


def _outer(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A[..., :, None] * B[..., None, :]


def _P_from_partner_stats(cnt, sU, sV, GUU, GVV, GVU,
                          R_inv: torch.Tensor) -> torch.Tensor:
    """Assemble the observation precision (m, T, d, d) from partner
    statistics — the one place the d x d slot layout lives."""
    m, T, r = sU.shape
    d = 2 + 2 * r
    p, q = R_inv[0, 0], R_inv[0, 1]
    P = sU.new_zeros((m, T, d, d))
    P[..., 0, 0] = p * cnt
    P[..., 1, 1] = p * cnt
    P[..., 0, 1] = q * cnt
    P[..., 1, 0] = q * cnt
    P[..., 0, 2:2 + r] = P[..., 2:2 + r, 0] = p * sV
    P[..., 0, 2 + r:] = P[..., 2 + r:, 0] = q * sU
    P[..., 1, 2:2 + r] = P[..., 2:2 + r, 1] = q * sV
    P[..., 1, 2 + r:] = P[..., 2 + r:, 1] = p * sU
    P[..., 2:2 + r, 2:2 + r] = p * GVV
    P[..., 2 + r:, 2 + r:] = p * GUU
    P[..., 2:2 + r, 2 + r:] = q * GVU
    P[..., 2 + r:, 2:2 + r] = q * GVU.transpose(-1, -2)
    return P


def _obs_precision(U: torch.Tensor, V: torch.Tensor,
                   R_inv: torch.Tensor) -> torch.Tensor:
    """Observation precision ``sum_{j != i} J' R^-1 J`` for every (i, t):
    U, V (n, T, r) -> (n, T, d, d)."""
    n = U.shape[0]
    sU = U.sum(0)[None] - U
    sV = V.sum(0)[None] - V
    GUU = _gram(U, U)[None] - _outer(U, U)
    GVV = _gram(V, V)[None] - _outer(V, V)
    GVU = _gram(V, U)[None] - _outer(V, U)
    return _P_from_partner_stats(float(n - 1), sU, sV, GUU, GVV, GVU, R_inv)


def _obs_nat_param(obs: ObsConstants, X_mean: torch.Tensor, r: int,
                   R_inv: torch.Tensor, corrected: bool) -> torch.Tensor:
    """Observation natural parameter for every (i, t): (n, T, d).

    ``corrected=False`` reproduces the reference's simplification (the other
    node's additive offsets are not subtracted from ``y``);
    ``corrected=True`` subtracts them — the exact coordinate update.
    """
    a, b, U, V = dyad_ops.split_state(X_mean, r)
    eta_a, eta_b = obs.eta_a, obs.eta_b
    etaU = _eta_contract(obs.W0, V)
    etaV = _eta_contract(obs.W1, U)
    if corrected:
        p, q = R_inv[0, 0], R_inv[0, 1]
        c = p * b + q * a
        dd = q * b + p * a
        eta_a = eta_a - (c.sum(0)[None] - c)
        eta_b = eta_b - (dd.sum(0)[None] - dd)
        etaU = etaU - (torch.einsum("jt,jtr->tr", c, V)[None]
                       - c[..., None] * V)
        etaV = etaV - (torch.einsum("jt,jtr->tr", dd, U)[None]
                       - dd[..., None] * U)
    return torch.cat([eta_a[..., None], eta_b[..., None], etaU, etaV], -1)


def _prior_precision(pri: PriorMatrices, T: int) -> torch.Tensor:
    """Time-indexed prior precision terms: (T, d, d)."""
    t = torch.arange(T, device=pri.Q_inv.device)
    is0 = (t == 0)[:, None, None]
    has_prev = (t > 0)[:, None, None]
    has_next = (t < T - 1)[:, None, None]
    return (is0 * pri.Sigma0_inv + has_prev * pri.Q_inv
            + has_next * pri.PhiT_Qinv_Phi)


def _prior_nat_param(pri: PriorMatrices, X_mean: torch.Tensor) -> torch.Tensor:
    """Neighbor-mean coupling terms of the natural parameter: (n, T, d)."""
    T = X_mean.shape[1]
    zero = X_mean.new_zeros(X_mean[:, :1].shape)
    mu_prev = torch.cat([zero, X_mean[:, :-1]], 1)
    mu_next = torch.cat([X_mean[:, 1:], zero], 1)
    t = torch.arange(T, device=X_mean.device)
    has_prev = (t > 0)[None, :, None]
    has_next = (t < T - 1)[None, :, None]
    eta_prev = mu_prev @ pri.Qinv_Phi.T
    eta_next = mu_next @ pri.Qinv_Phi
    return has_prev * eta_prev + has_next * eta_next


# ---------------------------------------------------------------------------
# Structure policies
# ---------------------------------------------------------------------------

def _solve_diag(P: torch.Tensor, eta: torch.Tensor):
    """Naive-MF policy: full-precision mean solve, diagonal variances
    ``1 / (diag(P) + 1e-8)``."""
    mu = batched_spd_solve(P, eta)
    var = 1.0 / (torch.diagonal(P, dim1=-2, dim2=-1) + 1e-8)
    return mu, torch.diag_embed(var)


def _finalize_cov(cov: torch.Tensor) -> torch.Tensor:
    """Symmetrize + jitter."""
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    return cov + 1e-6 * torch.eye(cov.shape[-1], dtype=cov.dtype,
                                  device=cov.device)


def _solve_full(P: torch.Tensor, eta: torch.Tensor):
    """Good-SMF policy: Sigma = P^-1, mean from the projected covariance."""
    _, cov_raw = batched_spd_solve_inv(P, eta)
    cov = _finalize_cov(cov_raw)
    return (cov @ eta[..., None])[..., 0], cov


def _solve_block(P: torch.Tensor, eta: torch.Tensor):
    """Bad-SMF policy: invert, zero the additive x multiplicative cross
    blocks post-inversion, then symmetrize/jitter; mean from the truncated
    covariance."""
    _, cov_raw = batched_spd_solve_inv(P, eta)
    d = P.shape[-1]
    cross = torch.zeros(d, d, dtype=torch.bool, device=P.device)
    cross[:2, 2:] = True
    cross[2:, :2] = True
    cov = _finalize_cov(cov_raw.masked_fill(cross, 0.0))
    return (cov @ eta[..., None])[..., 0], cov


_SOLVERS = {"diag": _solve_diag, "full": _solve_full, "block": _solve_block}


# ---------------------------------------------------------------------------
# ELBO
# ---------------------------------------------------------------------------

def compute_elbo(Y: torch.Tensor, params: AMEParams, pri: PriorMatrices,
                 state: CaviState, structure: str,
                 mu_dyadic: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ELBO with the reference's exact term structure (plug-in likelihood
    at the means, the structured policies' trace correction, Gaussian
    priors with trace terms, Gaussian entropy)."""
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    if mu_dyadic is None:
        mu_dyadic = dyad_ops.dyadic_mean_temporal(state.X_mean, r)
    m = dyad_ops.offdiag_mask(n, Y.dtype, Y.device)[:, :, None]
    resid = Y - mu_dyadic
    p_, q_ = params.R_inv[0, 0], params.R_inv[0, 1]
    e0, e1 = resid[..., 0], resid[..., 1]
    quad = p_ * (e0 * e0 + e1 * e1) + 2.0 * q_ * (e0 * e1)
    quad_sum = 0.5 * torch.sum(quad * m)
    return _elbo_from_quad(quad_sum, params, pri, state, structure)


def state_prior_terms(params: AMEParams, pri: PriorMatrices,
                      state: CaviState):
    """Expected initial-state and transition log-prior terms
    ``(prior0, priort)``."""
    n, T, d = state.X_mean.shape
    mu0 = state.X_mean[:, 0]
    quad0 = torch.einsum("ia,ab,ib->i", mu0, pri.Sigma0_inv, mu0)
    trace0 = torch.einsum("ab,iba->i", pri.Sigma0_inv, state.X_cov[:, 0])
    prior0 = -0.5 * torch.sum(quad0 + trace0 + pri.logdet_Sigma0
                              + d * _LOG2PI)
    if T == 1:
        return prior0, torch.zeros((), dtype=prior0.dtype,
                                   device=prior0.device)
    residt = state.X_mean[:, 1:] - state.X_mean[:, :-1] @ params.Phi.T
    quadt = torch.einsum("ita,ab,itb->it", residt, pri.Q_inv, residt)
    tracet = torch.einsum("ab,itba->it", pri.Q_inv, state.X_cov[:, 1:])
    priort = -0.5 * torch.sum(quadt + tracet + pri.logdet_Q + d * _LOG2PI)
    return prior0, priort


def gaussian_entropy(state: CaviState) -> torch.Tensor:
    """Entropy of the per-(node, time) Gaussian factors."""
    d = state.X_mean.shape[-1]
    logdets = batched_logdet_spd(state.X_cov)
    return 0.5 * torch.sum(logdets + d * (1.0 + _LOG2PI))


def _elbo_from_quad(quad_sum: torch.Tensor, params: AMEParams,
                    pri: PriorMatrices, state: CaviState,
                    structure: str) -> torch.Tensor:
    """ELBO given ``sum_{i<j,t} resid' R^-1 resid``; every other term
    depends only on the variational state."""
    n, T, d = state.X_mean.shape
    n_dyads = n * (n - 1) // 2 * T
    log_lik = -0.5 * (quad_sum + n_dyads * (pri.logdet_R + 2.0 * _LOG2PI))
    if structure in ("full", "block"):
        tr_cov = torch.diagonal(state.X_cov, dim1=-2, dim2=-1).sum(-1)
        wsum = (n - 1) * torch.sum(tr_cov)
        trR = params.R_inv[0, 0] + params.R_inv[1, 1]
        log_lik = log_lik - 0.5 * (0.1 * trR / d * wsum)
    prior0, priort = state_prior_terms(params, pri, state)
    return log_lik + prior0 + priort + gaussian_entropy(state)


# ---------------------------------------------------------------------------
# One CAVI step
# ---------------------------------------------------------------------------

def cavi_step_jacobi(state: CaviState, obs: ObsConstants, pri: PriorMatrices,
                     params: AMEParams, structure: str, lr: float,
                     corrected: bool = False) -> CaviState:
    """Simultaneous (Jacobi) update of every q(X_i^t) factor under the
    damped update ``new = lr * closed_form + (1 - lr) * old``."""
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    _, _, U, V = dyad_ops.split_state(state.X_mean, r)
    P = _obs_precision(U, V, params.R_inv) + _prior_precision(pri, T)[None]
    eta = (_obs_nat_param(obs, state.X_mean, r, params.R_inv, corrected)
           + _prior_nat_param(pri, state.X_mean))
    mu_new, cov_new = _SOLVERS[structure](P, eta)
    return CaviState(X_mean=lr * mu_new + (1.0 - lr) * state.X_mean,
                     X_cov=lr * cov_new + (1.0 - lr) * state.X_cov)


def cavi_step_block(state: CaviState, obs: ObsConstants, pri: PriorMatrices,
                    params: AMEParams, structure: str, lr: float,
                    num_blocks: int, corrected: bool = False) -> CaviState:
    """Block Gauss-Seidel: nodes split into ``num_blocks`` groups updated in
    sequence, each group reading the freshest global state; all (node,
    time) factors within a group update simultaneously.

    Works on a copy of ``state`` and updates it block by block in place.
    """
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    if n % num_blocks != 0:
        raise ValueError(f"num_blocks={num_blocks} must divide n={n}")
    bs = n // num_blocks
    solver = _SOLVERS[structure]
    prior_P = _prior_precision(pri, T)[None]
    p, q = params.R_inv[0, 0], params.R_inv[0, 1]
    X_mean, X_cov = state.X_mean.clone(), state.X_cov.clone()
    a_all, b_all, U, V = dyad_ops.split_state(X_mean, r)   # views

    for blk in range(num_blocks):
        sl = slice(blk * bs, (blk + 1) * bs)
        Ub, Vb = U[sl], V[sl]
        # Fresh global sufficient statistics (O(n T r^2)).
        sU = U.sum(0)[None] - Ub
        sV = V.sum(0)[None] - Vb
        GUU = _gram(U, U)[None] - _outer(Ub, Ub)
        GVV = _gram(V, V)[None] - _outer(Vb, Vb)
        GVU = _gram(V, U)[None] - _outer(Vb, Ub)
        P = _P_from_partner_stats(float(n - 1), sU, sV, GUU, GVV, GVU,
                                  params.R_inv) + prior_P

        etaU = _eta_contract(obs.W0[sl], V)
        etaV = _eta_contract(obs.W1[sl], U)
        eta_a, eta_b = obs.eta_a[sl], obs.eta_b[sl]
        if corrected:
            cc = p * b_all + q * a_all
            ddc = q * b_all + p * a_all
            cb, db = cc[sl], ddc[sl]
            eta_a = eta_a - (cc.sum(0)[None] - cb)
            eta_b = eta_b - (ddc.sum(0)[None] - db)
            etaU = etaU - (torch.einsum("jt,jtr->tr", cc, V)[None]
                           - cb[..., None] * Vb)
            etaV = etaV - (torch.einsum("jt,jtr->tr", ddc, U)[None]
                           - db[..., None] * Ub)
        eta = torch.cat([eta_a[..., None], eta_b[..., None], etaU, etaV], -1)
        eta = eta + _prior_nat_param(pri, X_mean[sl])

        mu_new, cov_new = solver(P, eta)
        X_mean[sl] = lr * mu_new + (1.0 - lr) * X_mean[sl]
        X_cov[sl] = lr * cov_new + (1.0 - lr) * X_cov[sl]
    return CaviState(X_mean=X_mean, X_cov=X_cov)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def init_state(generator: torch.Generator, n: int, T: int, d: int,
               structure: str, init_scale: float, cov_init_scale: float,
               device=None) -> CaviState:
    """Variational-parameter initialization per structure (the JAX
    package's scheme; draws from ``generator`` on its device, then moves
    to ``device``)."""
    gdev = generator.device
    X_mean = torch.randn(n, T, d, generator=generator, device=gdev) * init_scale
    eye = torch.eye(d, device=gdev)
    if structure == "diag":
        X_cov = (eye * 0.5).expand(n, T, d, d).clone()
    else:
        noise = torch.randn(n, T, d, d, generator=generator, device=gdev) * 0.01
        noise = 0.5 * (noise + noise.transpose(-1, -2))
        if structure == "full":
            X_cov = eye * cov_init_scale + noise + eye * 0.1
        else:  # block
            cross = torch.zeros(d, d, dtype=torch.bool, device=gdev)
            cross[:2, 2:] = True
            cross[2:, :2] = True
            X_cov = ((eye * cov_init_scale + noise).masked_fill(cross, 0.0)
                     + eye * 0.05)
    return CaviState(X_mean=X_mean.to(device or gdev),
                     X_cov=X_cov.to(device or gdev))


# ---------------------------------------------------------------------------
# Full fit
# ---------------------------------------------------------------------------

class _StopRule:
    """The JAX loop's tolerance x patience and divergence rule, evaluated
    in float32 on the host so the stop iteration matches bit for bit."""

    def __init__(self, carry_elbo, carry_patience: int, tolerance: float,
                 patience: int):
        self.prev = np.float32(-np.inf if carry_elbo is None else carry_elbo)
        self.pat = int(carry_patience)
        self.tol = np.float32(tolerance)
        self.patience = patience
        self.converged = self.diverged = False

    @property
    def running(self) -> bool:
        return not (self.converged or self.diverged)

    def update(self, elbo: Optional[float]) -> None:
        """Record one iteration; ``elbo`` is None where it was not
        evaluated."""
        if elbo is not None:
            e = np.float32(elbo)
            with np.errstate(invalid="ignore", over="ignore"):
                rel = np.abs(e - self.prev) / (np.abs(self.prev)
                                               + np.float32(1e-8))
            small = bool(np.isfinite(self.prev)) and bool(rel < self.tol)
            self.pat = self.pat + 1 if small else 0
            self.prev = e
        self.converged = self.pat >= self.patience
        self.diverged = elbo is not None and not math.isfinite(elbo)


def _exact_diagnostics(Y, params, pri, state, structure):
    """(ELBO, reconstruction MSE) from the exact dyadic residuals."""
    n, _, T, _ = Y.shape
    r = (state.X_mean.shape[-1] - 2) // 2
    fwd = dyad_ops.dyadic_fwd_temporal(state.X_mean, r)
    sq, cross = dyad_ops.residual_stats_from_fwd(Y, fwd)
    quad_sum = params.R_inv[0, 0] * sq + params.R_inv[0, 1] * cross
    elbo = _elbo_from_quad(quad_sum, params, pri, state, structure)
    return elbo, 2.0 * sq / (n * (n - 1) * T)


def fit_loop(Y: torch.Tensor, params: AMEParams, init: CaviState, *,
             structure: str, update_mode: str, num_blocks: Optional[int],
             max_iter: int, learning_rate: float, tolerance: float,
             patience: int, corrected: bool, elbo_every: int, buf_size: int,
             carry_elbo=None, carry_patience: int = 0) -> FitResult:
    """The unfused fit: one step, one diagnostics pass and one host check
    of the stopping rule per iteration."""
    n, _, T, _ = Y.shape
    obs = precompute_obs_constants(Y, params.R_inv)
    pri = precompute_priors(params)
    lr = float(learning_rate)
    eh = np.full(buf_size, np.nan, np.float32)
    mh = np.full(buf_size, np.nan, np.float32)
    rule = _StopRule(carry_elbo, carry_patience, tolerance, patience)
    state = init
    it = 0
    while it < max_iter and rule.running:
        if update_mode == "jacobi":
            state = cavi_step_jacobi(state, obs, pri, params, structure, lr,
                                     corrected)
        else:
            state = cavi_step_block(state, obs, pri, params, structure, lr,
                                    num_blocks, corrected)
        elbo = None
        if (it + 1) % elbo_every == 0 or it + 1 == max_iter:
            elbo_t, mse_t = _exact_diagnostics(Y, params, pri, state,
                                               structure)
            elbo, mse = torch.stack([elbo_t, mse_t]).tolist()
            eh[it], mh[it] = elbo, mse
        rule.update(elbo)
        it += 1
    return FitResult(X_mean=state.X_mean, X_cov=state.X_cov,
                     elbo_history=torch.from_numpy(eh),
                     mse_history=torch.from_numpy(mh), n_iter=it,
                     converged=rule.converged, diverged=rule.diverged,
                     last_elbo=float(rule.prev), pat_count=rule.pat)


def fit_cavi(Y: torch.Tensor, params: AMEParams, init: CaviState, *,
             structure: str = "full", update_mode: str = "jacobi",
             max_iter: int = 100, learning_rate=1.0, tolerance=1e-4,
             patience: int = 3, num_blocks=None, corrected: bool = False,
             elbo_every: int = 1, diag_mode: str = "exact",
             fused="auto", carry_elbo=None, carry_patience: int = 0
             ) -> FitResult:
    """Run damped CAVI to convergence (the JAX ``fit_cavi`` contract on the
    dense float32 path).

    PRECONDITION: ``Y`` follows the reciprocal layout
    ``Y[i, j, t, 1] == Y[j, i, t, 0]`` with zero diagonal.

    Stop once the relative ELBO change stays below ``tolerance`` for
    ``patience`` consecutive evaluations, or when the ELBO goes non-finite
    (``diverged``).  Histories are NaN-padded buffers whose length is the
    next power of two >= max(max_iter, 64).  ``elbo_every=k`` evaluates the
    diagnostics every k-th iteration (and at the last).

    ``fused`` selects K3 (:mod:`tame_torch.ops.fused_fit`): ``"auto"`` uses
    it exactly when ``Y`` is on a CUDA device and
    :func:`~tame_torch.ops.fused_fit.fused_fit_supported` holds; ``True``
    forces it (its plain twin on the CPU) and raises outside the envelope;
    ``False`` disables it.  ``carry_elbo``/``carry_patience`` seed the
    stopping rule from a previous segment's ``last_elbo``/``pat_count``.
    """
    if diag_mode != "exact":
        raise NotImplementedError(
            f"diag_mode={diag_mode!r}: the port runs exact diagnostics only")
    if update_mode not in ("jacobi", "block"):
        raise NotImplementedError(
            f"update_mode={update_mode!r}: the port runs 'jacobi' and "
            "'block' updates only")
    buf = 64
    while buf < max_iter:
        buf *= 2
    n, _, T, _ = Y.shape
    d = init.X_mean.shape[-1]
    if update_mode == "block" and num_blocks is None:
        # Largest divisor of n that is <= 16.
        num_blocks = next(k for k in range(min(16, n), 0, -1) if n % k == 0)
    if fused not in (False, None):
        supported = fused_fit.fused_fit_supported(
            n, T, d, structure=structure, update_mode=update_mode,
            diag_mode=diag_mode, elbo_every=elbo_every,
            num_blocks=num_blocks)
        if fused is True and not supported:
            raise ValueError(
                "fused=True requires update_mode 'jacobi' or 'block', "
                "diag_mode='exact', elbo_every=1, d in "
                "(4, 6, 8, 10, 12) and a shared-memory-sized problem")
        if fused is True or (supported and Y.is_cuda):
            out = fused_fit.fused_fit(
                Y, params.R_inv, params.Sigma0, params.Q, params.Phi,
                init.X_mean, init.X_cov, max_iter, learning_rate, tolerance,
                carry_elbo, carry_patience, r=(d - 2) // 2, buf_size=buf,
                patience=patience, corrected=corrected, structure=structure,
                num_blocks=num_blocks if update_mode == "block" else 1)
            return FitResult(*out)
    return fit_loop(Y, params, init, structure=structure,
                    update_mode=update_mode, num_blocks=num_blocks,
                    max_iter=max_iter, learning_rate=learning_rate,
                    tolerance=tolerance, patience=patience,
                    corrected=corrected, elbo_every=elbo_every,
                    buf_size=buf, carry_elbo=carry_elbo,
                    carry_patience=carry_patience)
