"""Smoothed (joint-trajectory) variational E-steps for non-Gaussian dyadic
families (counterpart of :mod:`tame.inference.family_smoothed`).

The quadratic pseudo-likelihood reductions of the mean-field engines (the
Jaakkola-Jordan bound for Bernoulli, the CVI surrogate for Poisson, any
family's ``vi_surrogate``) feed the block-tridiagonal trajectory smoother
instead of the per-time solve:

    D_t = P_obs[t] + [t=0] Sigma0^-1 + [t>0] Q^-1 + [t<T-1] Phi'Q^-1 Phi
    O   = -Phi' Q^-1
    b_t = eta_obs[t]

so each node's trajectory is one joint Gaussian with exact marginal and
lag-1 cross-covariances, the statistics the EM M-step needs.  The JAX
package ``vmap``s its scan smoother over the nodes; here all n
trajectories go through one
:func:`~tame_torch.ops.fused_smoother.fused_smoother` call per update: K4
on the card, its scan twin on the CPU (a recorded deliberate difference,
ROADMAP C).

The objective is the family's variational objective plus the smoothed
family's exact cross-time prior terms and trajectory entropy; the loop is
the guarded ascent of :mod:`tame_torch.inference.poisson_cavi` (revert and
halve the step scale on a regression), with one host read of the
objective per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tame_torch.inference import cavi
from tame_torch.inference.binary_cavi import (
    _predictor_moments,
    damped,
    family_inputs,
    weighted_obs_terms,
)
from tame_torch.inference.poisson_cavi import GuardRule
from tame_torch.inference.smoothed import (
    SmoothedState,
    smoothed_prior_entropy,
    warm_init_smoothed_state,
)
from tame_torch.models.likelihoods import get_family
from tame_torch.models.params import AMEParams
from tame_torch.ops.fused_smoother import fused_smoother

FAMILIES = ("bernoulli", "poisson")


class SmoothedFamilyResult(NamedTuple):
    state: SmoothedState
    elbo_history: torch.Tensor   # (buf,) on the CPU, NaN past the stop
    n_iter: int
    converged: bool
    diverged: bool


def warm_init_smoothed_family(Y: torch.Tensor, params: AMEParams, family,
                              obs_mask=None) -> SmoothedState:
    """Link-linearized warm start: pseudo-Gaussian observations of the
    predictor (``4 (y - 1/2)`` for Bernoulli, ``log(y + 1/2)`` for
    Poisson, a custom family's ``warm_transform(Y)`` if it declares one,
    else ``Y``) through the Gaussian closed-form warm start.  A sharded
    ``Y`` (:func:`tame_torch.parallel.shard_smoothed_inputs`) transforms
    each rank's piece and returns a sharded state."""
    if cavi.is_sharded(Y):
        Z = Y._replace(local=_warm_transform(Y.local, family))
    else:
        Z = _warm_transform(Y, family)
    return warm_init_smoothed_state(Z, params, obs_mask=obs_mask)


def _warm_transform(Y: torch.Tensor, family) -> torch.Tensor:
    """The pseudo-Gaussian observations of a family's predictor
    (elementwise)."""
    if family == "bernoulli":
        return 4.0 * (Y - 0.5)
    if family == "poisson":
        return torch.log(Y + 0.5)
    if isinstance(family, str):
        raise ValueError(f"unknown family {family!r}; choose from "
                         f"{FAMILIES}")
    if hasattr(family, "warm_transform"):
        return family.warm_transform(Y)
    return Y


def _evaluate(family, state: SmoothedState, y0, offd, pri, params):
    """``(objective, w, s)`` of a state; ``w``/``s`` time-major."""
    r = (state.X_mean.shape[-1] - 2) // 2
    m, var = _predictor_moments(state, r)
    loglik, w, s = family.vi_surrogate(y0, offd, m, var)
    prior0, priort, entropy = smoothed_prior_entropy(params, pri, state)
    return loglik + prior0 + priort + entropy, w, s


def _smoothed_update(state: SmoothedState, w: torch.Tensor, s: torch.Tensor,
                     pri, params: AMEParams, lr: float) -> SmoothedState:
    """Exact re-solve of every node's trajectory against the weighted
    observation terms, one :func:`fused_smoother` call; damping applies to
    the means only, covariances come fresh from the solve."""
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    P_obs, eta_obs = weighted_obs_terms(state.X_mean, r, w, s,
                                        cov=state.X_cov)
    D = P_obs + cavi._prior_precision(pri, T)[None]
    out = fused_smoother(D, -pri.Qinv_Phi.T, eta_obs)
    return SmoothedState(X_mean=damped(out.mean, state.X_mean, lr),
                         X_cov=out.cov, X_cross=out.cross_cov,
                         logdets=out.logdet)


def _resolve_family(family):
    """A family name -> its built-in instance, which must declare a
    ``vi_surrogate``; a custom object must implement one."""
    if isinstance(family, str):
        fam = get_family(family)
        if not hasattr(fam, "vi_surrogate"):
            raise ValueError(
                f"family {family!r} declares no vi_surrogate — no VI path "
                f"(built-ins with one: {FAMILIES})")
        return fam
    if not hasattr(family, "vi_surrogate"):
        raise ValueError(
            "custom family must implement vi_surrogate(y0, offd, m, var) "
            "-> (loglik, w, s); see tame_torch.models.likelihoods")
    return family


def fit_smoothed_family(Y: torch.Tensor, params: AMEParams,
                        init: SmoothedState, *, family, max_iter: int = 150,
                        learning_rate=0.7, tolerance=1e-5, patience: int = 3,
                        mask=None) -> SmoothedFamilyResult:
    """Fit the smoothed variational family to a non-Gaussian network in a
    guarded loop (the JAX ``fit_smoothed_family`` contract).

    ``Y``: the (n, n, T, 2) reciprocal layout (component 0 read);
    ``family``: ``"bernoulli"``, ``"poisson"`` or any object with a
    ``vi_surrogate`` (:mod:`tame_torch.models.likelihoods`; it receives
    time-major (T, n, n) tensors); ``mask``: optional (n, n, T)
    observation gate (hidden dyads are never read).  One K4 launch per
    iteration on the card.

    ``Y`` and ``init`` from :func:`tame_torch.parallel.shard_smoothed_inputs`
    (``mask`` the whole mask) run the fit sharded over the mesh's nodes
    (:func:`tame_torch.parallel.sharded_family.fit_smoothed_family_sharded`;
    one K4 launch per iteration on each rank's nodes)."""
    family = _resolve_family(family)
    if cavi._sharded(Y, init):
        from tame_torch.parallel.sharded_family import (
            fit_smoothed_family_sharded,
        )

        return fit_smoothed_family_sharded(
            Y, params, init, family=family, max_iter=max_iter,
            learning_rate=learning_rate, tolerance=tolerance,
            patience=patience, mask=mask)
    fi = family_inputs(Y, mask)
    params = params.to(Y.device, Y.dtype)
    pri = cavi.precompute_priors(params)
    rule = GuardRule(-np.inf, 1.0, 0, tolerance, patience)
    eh = np.full(cavi.history_buffer(max_iter), np.nan, np.float32)
    state = base = init
    it = 0
    while it < max_iter and rule.running:
        elbo, w, s = _evaluate(family, state, fi.y0, fi.offd, pri, params)
        if rule.judge(elbo.item()):
            # rejected: the pseudo-likelihood terms are the base's
            state = base
            _, w, s = _evaluate(family, state, fi.y0, fi.offd, pri, params)
        eh[it] = rule.e_base
        base = state
        state = _smoothed_update(base, w, s, pri, params,
                                 rule.step_lr(learning_rate))
        it += 1
    return SmoothedFamilyResult(state=base, elbo_history=torch.from_numpy(eh),
                                n_iter=it, converged=rule.converged,
                                diverged=rule.diverged)
