"""CAVI for COUNT dynamic networks via conjugate-computation VI
(counterpart of :mod:`tame.inference.poisson_cavi`).

Count ties ``y_ij ~ Poisson(exp(m_ij))``: under a Gaussian variational
factor the expected log-likelihood is exact in closed form,

    E_q[y m - exp(m) - log y!] = y mu - exp(mu + v/2) - log y!,

so the objective reported per iteration is the TRUE ELBO.  The coordinate
update is conjugate-computation VI: each dyad's expected log-likelihood is
replaced by the quadratic surrogate with the same mu/v gradients, a
Gaussian pseudo-observation of precision ``w = exp(mu + v/2)`` and linear
coefficient ``y - w + w mu``; the binary engine's weighted contractions
(:func:`tame_torch.inference.binary_cavi.weighted_obs_terms`) and its
direct solve (K1 on the card) then do the rest.  ``w``'s log is clamped at
:data:`_EXP_CLIP`, so the precisions K1 sees span up to ~9 orders of
magnitude in float32.

The CVI weights are unbounded, so the simultaneous update can diverge:
the loop is a GUARDED ascent.  Each iteration evaluates the exact ELBO of
the current iterate; if it regressed below its base state by more than
``1e-4 |ELBO| + 1`` or went non-finite, the iterate is rejected — the loop
reverts to the base, recomputes its moments and retries with the step
scale halved, growing it back (x1.25, capped at 1) after accepted steps.
``diverged`` is raised when the scale falls below 1e-3 with the guard
still rejecting.  The JAX loop's ``lax.cond`` is a branch on the host
here, after the one host read of the ELBO and the deviance per iteration.

Layout, masks and K2 (the entropy) as in the binary engine.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tame_torch.inference import cavi
from tame_torch.inference.binary_cavi import (
    MeanFieldFamilyVI,
    _predictor_moments,
    damped,
    family_inputs,
    forecast_predictor,
    public_layout,
    solve_direct,
    weighted_obs_terms,
)
from tame_torch.models.params import AMEParams

# exp() clamp for the CVI weights: e^20 ~ 5e8 per dyad is far beyond any
# realistic rate yet inside float32; it binds only on divergent transients.
_EXP_CLIP = 20.0


class PoissonFitResult(NamedTuple):
    X_mean: torch.Tensor            # (n, T, d) the last accepted iterate
    X_cov: torch.Tensor             # (n, T, d, d)
    elbo_history: torch.Tensor      # (buf,) EXACT ELBO, NaN past the stop
    deviance_history: torch.Tensor  # (buf,) mean plug-in deviance, NaN on
    #                                 rejected iterations
    n_iter: int
    converged: bool
    diverged: bool
    # The guarded loop's carry at exit: the proposal not yet evaluated, the
    # last accepted ELBO, the step scale and the patience count.
    prop_mean: torch.Tensor
    prop_cov: torch.Tensor
    last_elbo: float
    step_scale: float
    pat_count: int

    def resume_carry(self):
        """The carry to pass as ``carry=`` of a follow-up
        :func:`fit_cavi_poisson` started from this result's state."""
        return (cavi.CaviState(X_mean=self.prop_mean, X_cov=self.prop_cov),
                self.last_elbo, self.step_scale, self.pat_count)


def resume_carry_from_numpy(carry, device=None, dtype=torch.float32):
    """The port's guarded-loop carry from any ``(state, last_elbo,
    step_scale, pat_count)`` whose state holds ``X_mean``/``X_cov`` arrays,
    e.g. the JAX ``PoissonFitResult.resume_carry()``."""
    state, e, scale, pat = carry
    return (cavi.state_from_numpy(state, device, dtype), float(e),
            float(scale), int(pat))


def _weights(m: torch.Tensor, var: torch.Tensor,
             offd: torch.Tensor) -> torch.Tensor:
    """``w = E_q[exp(m)]`` (clamped), gated."""
    return torch.exp(torch.clamp(m + 0.5 * var, -_EXP_CLIP, _EXP_CLIP)) * offd


def _evaluate(state: cavi.CaviState, y0: torch.Tensor,
              logyfac: torch.Tensor, offd: torch.Tensor,
              pri: cavi.PriorMatrices, params: AMEParams):
    """Exact ELBO, mean plug-in deviance (0-d tensors) and the predictor
    moments (T, n, n) of a state."""
    r = (state.X_mean.shape[-1] - 2) // 2
    m, var = _predictor_moments(state, r)
    w = _weights(m, var, offd)
    elbo = torch.sum(offd * (y0 * m - logyfac) - w)
    prior0, priort = cavi.state_prior_terms(params, pri, state)
    elbo = elbo + prior0 + priort + cavi.gaussian_entropy(state)
    # plug-in mean deviance 2 [y log(y / rate) - (y - rate)] at the
    # predictor mean (rate clamp shared with the weights)
    rate = torch.exp(torch.clamp(m, -_EXP_CLIP, _EXP_CLIP))
    dev = 2.0 * torch.sum(offd * (torch.xlogy(y0, y0) - y0 * m - y0 + rate))
    dev = dev / torch.clamp(offd.sum(), min=1.0)
    return elbo, dev, m, var


def _cvi_update(state: cavi.CaviState, y0: torch.Tensor, offd: torch.Tensor,
                pri: cavi.PriorMatrices, m: torch.Tensor, var: torch.Tensor,
                lr: float) -> cavi.CaviState:
    """The damped CVI coordinate update given the state's moments."""
    T = state.X_mean.shape[1]
    r = (state.X_mean.shape[-1] - 2) // 2
    w = _weights(m, var, offd)
    # surrogate coefficient on m: y - w + w mu (weighted_obs_terms then
    # subtracts the partner-offset pulls)
    resid = (y0 - w + w * m) * offd
    P, eta = weighted_obs_terms(state.X_mean, r, w, resid, cov=state.X_cov)
    P = P + cavi._prior_precision(pri, T)[None]
    eta = eta + cavi._prior_nat_param(pri, state.X_mean)
    mu_new, cov_new = solve_direct(P, eta)
    return cavi.CaviState(X_mean=damped(mu_new, state.X_mean, lr),
                          X_cov=damped(cov_new, state.X_cov, lr))


def poisson_step(state: cavi.CaviState, y0: torch.Tensor,
                 logyfac: torch.Tensor, offd: torch.Tensor,
                 pri: cavi.PriorMatrices, params: AMEParams, lr: float):
    """One simultaneous (Jacobi) CVI update, unguarded: ``(new_state,
    elbo, deviance)``, the ELBO and deviance at the INCOMING state.
    ``y0``/``logyfac``/``offd`` time-major (T, n, n)."""
    elbo, dev, m, var = _evaluate(state, y0, logyfac, offd, pri, params)
    return _cvi_update(state, y0, offd, pri, m, var, lr), elbo, dev


class GuardRule:
    """The guarded loop's bookkeeping, in float32 on the host as the JAX
    loop computes it: accept or reject an iterate against its base, the
    step scale, and the tolerance x patience stop on accepted ELBOs."""

    def __init__(self, e_base, scale, pat: int, tolerance: float,
                 patience: int):
        self.e_base = np.float32(e_base)
        self.scale = np.float32(scale)
        self.pat = int(pat)
        self.tol = np.float32(tolerance)
        self.patience = patience
        self.converged = self.diverged = False

    @property
    def running(self) -> bool:
        return not (self.converged or self.diverged)

    def judge(self, elbo: float) -> bool:
        """Record an evaluated iterate; True if it is rejected."""
        e = np.float32(elbo)
        e_base = self.e_base
        with np.errstate(invalid="ignore", over="ignore"):
            slack = np.float32(1e-4) * np.abs(e_base) + np.float32(1.0)
            bad = (not np.isfinite(e)) or (bool(np.isfinite(e_base))
                                           and bool(e < e_base - slack))
            e_nxt = e_base if bad else e
            rel = np.abs(e_nxt - e_base) / (np.abs(e_base)
                                            + np.float32(1e-8))
        self.scale = np.float32(0.5) * self.scale if bad else min(
            np.float32(1.25) * self.scale, np.float32(1.0))
        small = bool(np.isfinite(e_base)) and bool(rel < self.tol)
        # a reverted iteration is not progress: never counted toward the
        # patience rule
        if not bad:
            self.pat = self.pat + 1 if small else 0
        self.converged = self.pat >= self.patience
        self.diverged = bad and bool(self.scale < np.float32(1e-3))
        self.e_base = e_nxt
        return bad

    def step_lr(self, lr: float) -> float:
        """The damping of the next proposal, ``lr x scale`` in float32."""
        return float(np.float32(lr) * self.scale)


def fit_cavi_poisson(Y: torch.Tensor, params: AMEParams,
                     init: cavi.CaviState, *, max_iter: int = 200,
                     learning_rate=0.7, tolerance=1e-5, patience: int = 3,
                     carry=None, mask=None) -> PoissonFitResult:
    """Fit the guarded CVI engine to a count network (the JAX
    ``fit_cavi_poisson`` contract): tolerance x patience stopping on the
    exact ELBO.

    ``Y``: the (n, n, T, 2) reciprocal layout (component 0 read); ``mask``:
    optional (n, n, T) observation gate (hidden dyads are never read).
    ``carry``: a previous segment's :meth:`PoissonFitResult.resume_carry`,
    with ``init`` that segment's ``X_mean``/``X_cov``: the follow-up
    continues the guarded loop bit for bit.  Inputs from
    :func:`tame_torch.parallel.shard_fit_inputs` run the fit sharded over
    the mesh (:mod:`tame_torch.parallel.sharded_family`)."""
    if cavi._sharded(Y, init):
        from tame_torch.parallel.sharded_family import fit_poisson_sharded

        return fit_poisson_sharded(
            Y, params, init, max_iter=max_iter, learning_rate=learning_rate,
            tolerance=tolerance, patience=patience, carry=carry, mask=mask)
    fi = family_inputs(Y, mask)
    logyfac = torch.lgamma(fi.y0 + 1.0)
    params = params.to(Y.device, Y.dtype)
    pri = cavi.precompute_priors(params)
    if carry is None:
        prop, e0, scale0, pat0 = init, -np.inf, 1.0, 0
    else:
        prop, e0, scale0, pat0 = carry
    rule = GuardRule(e0, scale0, pat0, tolerance, patience)
    buf = cavi.history_buffer(max_iter)
    eh = np.full(buf, np.nan, np.float32)
    dh = np.full(buf, np.nan, np.float32)
    state, base = prop, init
    it = 0
    while it < max_iter and rule.running:
        # evaluate the current iterate (last iteration's proposal from
        # `base`) and keep it or fall back to `base`
        elbo, dev, m, var = _evaluate(state, fi.y0, logyfac, fi.offd, pri,
                                      params)
        elbo, dev = torch.stack([elbo, dev]).tolist()
        if rule.judge(elbo):
            state = base
            m, var = _predictor_moments(state, (state.X_mean.shape[-1] - 2)
                                        // 2)
        else:
            dh[it] = dev
        eh[it] = rule.e_base
        base = state
        state = _cvi_update(base, fi.y0, fi.offd, pri, m, var,
                            rule.step_lr(learning_rate))
        it += 1
    return PoissonFitResult(
        X_mean=base.X_mean, X_cov=base.X_cov,
        elbo_history=torch.from_numpy(eh),
        deviance_history=torch.from_numpy(dh), n_iter=it,
        converged=rule.converged, diverged=rule.diverged,
        prop_mean=state.X_mean, prop_cov=state.X_cov,
        last_elbo=float(rule.e_base), step_scale=float(rule.scale),
        pat_count=rule.pat)


class TemporalAMEPoissonVI(MeanFieldFamilyVI):
    """Engine for count dynamic networks (guarded CVI), an ``nn.Module``
    whose buffers are the variational state on the device of the model's
    ``Y`` (counts in the reciprocal layout, e.g. from
    ``sample_observations(..., family="poisson")``).

    ``init_mode="warm"`` (default: the log-link linearization
    ``log(y + 1/2)`` through the Gaussian warm start) or ``"random"``
    (seeded ``seed``); ``mask`` goes to the warm init and every fit.  The
    checkpoint carries the guarded loop's whole state, the proposal and the
    step scale included, so a resumed fit gives the uninterrupted one's
    bits."""

    structure = "poisson"
    history_keys = ("elbo", "deviance")

    @staticmethod
    def warm_transform(Y):
        return torch.log(Y + 0.5)

    def __init__(self, model, learning_rate: float = 0.7,
                 init_scale: float = 0.1, seed: int = 42,
                 init_mode: str = "warm", mask=None):
        super().__init__(model, learning_rate, init_scale, seed, init_mode,
                         mask)

    def _reset_carry(self) -> None:
        self._carry = None

    def _run_segment(self, max_iter: int, tolerance: float):
        out = fit_cavi_poisson(
            self.Y, self.params, self._state(), max_iter=max_iter,
            learning_rate=self.lr, tolerance=tolerance, mask=self.mask,
            carry=self._carry)
        self.X_mean, self.X_cov = out.X_mean, out.X_cov
        self._converged, self._diverged = out.converged, out.diverged
        self._carry = out.resume_carry()
        k = out.n_iter
        return (k, out.elbo_history[:k].tolist(),
                out.deviance_history[:k].tolist())

    def _carry_state(self) -> dict:
        if self._carry is None:
            return {}
        prop, e, scale, pat = self._carry
        return {"prop_mean": prop.X_mean, "prop_cov": prop.X_cov,
                "carry_elbo": float(e), "carry_scale": float(scale),
                "carry_pat": int(pat)}

    def _restore_carry(self, state: dict) -> None:
        if "prop_mean" not in state:
            self._carry = None
            return
        dev = self.Y.device
        self._carry = (cavi.CaviState(
            X_mean=torch.as_tensor(state["prop_mean"], device=dev),
            X_cov=torch.as_tensor(state["prop_cov"], device=dev)),
            state["carry_elbo"], state["carry_scale"],
            int(state["carry_pat"]))

    def predict_rate(self) -> torch.Tensor:
        """Posterior-mean count rates ``E_q[exp(m_ij)]`` (n, n, T): the
        exact log-normal mean, not the plug-in exp of the mean."""
        m, var = _predictor_moments(self._state(), self.r)
        return public_layout(torch.exp(torch.clamp(m + 0.5 * var,
                                                   -_EXP_CLIP, _EXP_CLIP)))

    def predict_rate_forward(self, n_steps: int = 1) -> torch.Tensor:
        """Forecast count rates (n, n, n_steps): the plug-in exp of the
        AR(1)-propagated predictor."""
        m = forecast_predictor(self.X_mean, self.params, self.r, n_steps)
        return torch.exp(torch.clamp(m, -_EXP_CLIP, _EXP_CLIP))
