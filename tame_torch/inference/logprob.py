"""Joint log-density of the temporal AME model (counterpart of
:mod:`tame.inference.logprob`).

The AR(1) latent prior and the bilinear dyadic likelihood as batched
log-density functions of the latent tensor ``X``: (n, T, d) for one
state, or (..., n, T, d) for a batch of them (chains, particles), which
gives one log-density per batch entry, (...,).  A batch is one call of
batched einsums, not a loop, and ``torch.autograd.grad`` of the summed
log-densities gives every entry's own gradient (the entries do not
interact).  These are the targets of the HMC, NUTS and SMC samplers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tame_torch.models.params import AMEParams
from tame_torch.ops import dyad as dyad_ops

_LOG2PI = 1.8378770664093453


class LogProbConstants(NamedTuple):
    """Inverses and log-determinants precomputed from model params."""

    Sigma0_inv: torch.Tensor
    Q_inv: torch.Tensor
    R_inv: torch.Tensor
    logdet_Sigma0: torch.Tensor
    logdet_Q: torch.Tensor
    logdet_R: torch.Tensor


def precompute(params: AMEParams) -> LogProbConstants:
    return LogProbConstants(
        Sigma0_inv=torch.linalg.inv(params.Sigma0),
        Q_inv=torch.linalg.inv(params.Q),
        R_inv=params.R_inv,
        logdet_Sigma0=torch.linalg.slogdet(params.Sigma0)[1],
        logdet_Q=torch.linalg.slogdet(params.Q)[1],
        logdet_R=torch.linalg.slogdet(params.R)[1],
    )


def log_prior(params: AMEParams, X: torch.Tensor,
              consts: Optional[LogProbConstants] = None) -> torch.Tensor:
    """log p(X): initial-state prior and AR(1) transitions over every node
    and time; X (..., n, T, d) -> (...,)."""
    if consts is None:
        consts = precompute(params)
    n, T, d = X.shape[-3:]
    x0 = X[..., 0, :]
    quad0 = torch.einsum("...ia,ab,...ib->...", x0, consts.Sigma0_inv, x0)
    lp = -0.5 * (quad0 + n * (consts.logdet_Sigma0 + d * _LOG2PI))
    if T > 1:
        resid = X[..., 1:, :] - X[..., :-1, :] @ params.Phi.T
        quadt = torch.einsum("...ita,ab,...itb->...", resid, consts.Q_inv,
                             resid)
        lp = lp - 0.5 * (quadt
                         + n * (T - 1) * (consts.logdet_Q + d * _LOG2PI))
    return lp


def log_likelihood(params: AMEParams, Y: torch.Tensor, X: torch.Tensor,
                   consts: Optional[LogProbConstants] = None,
                   obs_mask: Optional[torch.Tensor] = None,
                   family=None) -> torch.Tensor:
    """log p(Y | X) over unordered pairs i < j and all t; ``Y`` (n, n, T,
    2), ``X`` (..., n, T, d) -> (...,).

    ``obs_mask`` (n, n, T; symmetric, zero diagonal) restricts the sum to
    observed dyads; masked entries of ``Y`` are never read, so NaN coding
    is safe for the value and its gradient.  ``family``: ``None`` /
    ``"gaussian"`` is the exchangeable-R bivariate Gaussian; any other
    (``"poisson"``, ``"bernoulli"``, a family instance) goes through
    :func:`tame_torch.models.likelihoods.get_family`, ``vmap``-ed over the
    batch axes.
    """
    if consts is None:
        consts = precompute(params)
    n, T, d = X.shape[-3:]
    r = (d - 2) // 2
    offd = dyad_ops.offdiag_mask(n, Y.dtype, Y.device)[:, :, None]
    if obs_mask is None:
        mask = offd
        n_dyads = float(n * (n - 1) // 2 * T)
    else:
        # Sanitize BEFORE the residual: gating only the output leaks NaN
        # through the gradient (0 cotangent * NaN residual = NaN).
        Y = torch.where(obs_mask[..., None] > 0, Y,
                        torch.zeros((), dtype=Y.dtype, device=Y.device))
        mask = obs_mask * offd
        n_dyads = 0.5 * torch.sum(mask)
    fwd = dyad_ops.dyadic_fwd_temporal(X, r)
    if family is not None and getattr(family, "name", family) != "gaussian":
        from tame_torch.models.likelihoods import get_family

        fam = get_family(family)
        mask = mask.expand(Y.shape[:3])
        mu = torch.stack([fwd, fwd.transpose(-3, -2)], dim=-1)
        batch = mu.shape[:-4]
        if not batch:
            return fam.log_prob(params, Y, mu, mask)
        flat = torch.vmap(lambda m: fam.log_prob(params, Y, m, mask))(
            mu.reshape(-1, *mu.shape[-4:]))
        return flat.reshape(batch)
    # resid' R^-1 resid elementwise from the two directions' residuals
    # (mu[i, j] = [fwd_ij, fwd_ji]), on contiguous operands; a (..., 2) x
    # (2, 2) product or a three-operand einsum is a library call per pair,
    # 2-25x slower on the card
    e0 = Y[..., 0].contiguous() - fwd
    e1 = Y[..., 1].contiguous() - fwd.transpose(-3, -2).contiguous()
    Ri = consts.R_inv
    quad = (Ri[0, 0] * e0 * e0 + (Ri[0, 1] + Ri[1, 0]) * e0 * e1
            + Ri[1, 1] * e1 * e1)
    quad_sum = 0.5 * torch.sum(quad * mask, dim=(-3, -2, -1))
    return -0.5 * (quad_sum + n_dyads * (consts.logdet_R + 2.0 * _LOG2PI))


def log_joint(params: AMEParams, Y: torch.Tensor, X: torch.Tensor,
              consts: Optional[LogProbConstants] = None,
              obs_mask: Optional[torch.Tensor] = None,
              family=None) -> torch.Tensor:
    """log p(Y, X), the samplers' target up to the constant log p(Y);
    X (..., n, T, d) -> (...,)."""
    if consts is None:
        consts = precompute(params)
    return (log_prior(params, X, consts)
            + log_likelihood(params, Y, X, consts, obs_mask=obs_mask,
                             family=family))


def make_logdensity_fn(params: AMEParams, Y: torch.Tensor,
                       obs_mask: Optional[torch.Tensor] = None,
                       family=None):
    """Close over the data: ``X -> log p(Y, X)`` for the samplers, batched
    over X's leading axes.  ``obs_mask`` (its diagonal zeroed here) makes
    the target the missing-data posterior; ``family`` declares the dyadic
    observation model (e.g. ``"poisson"``: the posterior of a count
    network, which NUTS, HMC and SMC sample unchanged)."""
    consts = precompute(params)
    if obs_mask is not None:
        obs_mask = obs_mask * dyad_ops.offdiag_mask(
            Y.shape[0], Y.dtype, Y.device)[:, :, None]
    if family is not None:
        from tame_torch.models.likelihoods import get_family

        family = get_family(family)

    def logdensity(X: torch.Tensor) -> torch.Tensor:
        return log_joint(params, Y, X, consts, obs_mask=obs_mask,
                         family=family)

    return logdensity
