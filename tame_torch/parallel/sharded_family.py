"""The Bernoulli (Jaakkola-Jordan) and Poisson (guarded CVI) fits and the
smoothed families sharded over a mesh's ranks (the port's counterpart of
GSPMD partitioning :func:`tame.inference.fit_cavi_bernoulli`,
``fit_cavi_poisson`` and ``fit_smoothed_family``).

The mean-field fits are Jacobi sweeps over time-major (T, n, n) quantities.  A rank holds
its rows and time slice of the observations, (T_local, m, n), and every
node's means and covariances, replicated: a row's predictor moments read
the partner's factors.  The sender-side contractions of a row are local;
the receiver side of node j sums over every sender i, so each rank
contracts its own senders for all receivers and an all-reduce over the
``nodes`` ranks completes the sums (two per iteration, (n, T_local, K)
floats).  The bound (or the exact ELBO and the deviance), the prior terms,
the entropy (K2 on the rank's factors) and the accuracy count are
all-reduced as one vector, so every rank sees the same value, and the
Poisson guard accepts or rejects the same iterate everywhere.  The new
factors of the rank's rows (K1 on its n_local x T_local systems) are
all-gathered over the mesh once per iteration.

A mask gates the rank's (T_local, m, n) terms (its rows of the whole mask,
:func:`~tame_torch.parallel.mesh.place_mask`); the observed count is
all-reduced.

The smoothed families (:func:`fit_smoothed_family_sharded`, on a mesh over
``nodes``) take the same terms and the same receiver-side all-reduces; in
place of the per-(node, time) solve, one K4 launch re-solves the rank's
trajectories, and the new means and marginal covariances are all-gathered
(the partner moments read them) while the lag-1 cross-covariances and
log-determinants stay with their owner.  A segmented Poisson fit takes ``carry=`` from a sharded
result's ``resume_carry()``: the proposal's pieces are gathered into the
replicated proposal, so the resumed fit continues the one-shot fit's bits.
"""

from __future__ import annotations

import numpy as np
import torch

from tame_torch.inference import cavi
from tame_torch.inference.binary_cavi import (
    BernoulliFitResult,
    _lam,
    _predictor_moments,
    damped,
    solve_direct,
    weighted_obs_terms,
)
from tame_torch.inference.family_smoothed import SmoothedFamilyResult
from tame_torch.inference.poisson_cavi import (
    _EXP_CLIP,
    GuardRule,
    PoissonFitResult,
    _weights,
)
from tame_torch.inference.smoothed import (
    SmoothedState,
    smoothed_prior_entropy,
)
from tame_torch.models.likelihoods import softplus
from tame_torch.ops.fused_smoother import fused_smoother
from tame_torch.parallel.mesh import (
    Sharded,
    cov_sharding,
    gather,
    place_mask,
    smoothed_spec,
    state_sharding,
)
from tame_torch.parallel.sharded_cavi import (
    Geometry,
    _check,
    nodes_only,
    prior_partials,
)


class _Rank:
    """One rank's share of a family fit: its observations and gate
    (T_local, m, n; off the diagonal and, under ``mask``, the observed
    dyads), the replicated factors' geometry and the priors."""

    def __init__(self, Y: Sharded, params, init: Sharded, mask):
        _check(Y, init)
        self.mesh, self.comm = Y.mesh, Y.mesh.comm
        n, T = Y.sizes["nodes"], Y.sizes["time"]
        self.geo = geo = Geometry(self.mesh, n, T)
        self.params = params.to(self.mesh.device)
        self.pri = cavi.precompute_priors(self.params)
        self.prior_P = cavi._prior_precision(self.pri, T)[geo.ts][None]
        self.r = (init.local.X_mean.shape[-1] - 2) // 2
        Yl = Y.local
        ids = torch.arange(n, device=Yl.device)
        off = (ids[None, :] != ids[geo.rows][:, None]).to(Yl.dtype)
        offd = off[None].expand(Yl.shape[2], *off.shape)
        if mask is not None:
            offd = offd * place_mask(Y, mask).permute(2, 0, 1)
        self.offd = offd.contiguous()
        self.y0 = torch.where(self.offd > 0, Yl[..., 0].permute(2, 0, 1),
                              torch.zeros((), dtype=Yl.dtype,
                                          device=Yl.device)).contiguous()
        self.n_obs = torch.clamp(
            self.comm.all_reduce(self.offd.sum(), "mesh"), min=1.0)
        self.spec, self.sizes = init.spec, init.sizes
        self.state = self.replicated(init.local)

    def replicated(self, state: cavi.CaviState):
        """The replicated factors of a state of this rank's pieces."""
        return tuple(gather(self.mesh, getattr(state, f), self.spec[f],
                            self.sizes) for f in ("X_mean", "X_cov"))

    def own(self, state) -> cavi.CaviState:
        X, C = state
        g = self.geo
        return cavi.CaviState(X[g.rows, g.ts], C[g.rows, g.ts])

    def moments(self, state):
        """The predictor moments (T_local, m, n) of this rank's rows."""
        X, C = state
        ts = self.geo.ts
        return _predictor_moments(cavi.CaviState(X[:, ts], C[:, ts]),
                                  self.r, senders=self.own(state))

    def terms(self, state):
        """The prior terms and the entropy of this rank's factors."""
        own = self.own(state)
        return (*prior_partials(self.params, self.pri,
                                state[0][self.geo.rows], own.X_cov,
                                self.geo.ts.start),
                cavi.gaussian_entropy(own))

    def obs_terms(self, state, w: torch.Tensor, s: torch.Tensor):
        """The weighted observation terms ``(P, eta)`` of this rank's rows
        from the weights ``w`` and coefficients ``s`` of its rows: the
        receiver sides all-reduced over the ``nodes`` ranks."""
        X, C = state
        g = self.geo
        return weighted_obs_terms(
            X[:, g.ts], self.r, w, s, cov=C[:, g.ts], rows=g.rows,
            reduce=lambda x: self.comm.all_reduce(x, "nodes"))

    def gather_factors(self, mean: torch.Tensor, cov: torch.Tensor):
        """New replicated factors from this rank's rows' means and
        covariances: one all-gather over the mesh."""
        g = self.geo
        d = mean.shape[-1]
        both = mean.new_empty((g.n, g.T, d + d * d))
        g.gather_means(both, torch.cat([mean, cov.flatten(-2)], -1), 0, g.n)
        return both[..., :d], both[..., d:].unflatten(-1, (d, d))

    def update(self, state, w: torch.Tensor, s: torch.Tensor, lr: float):
        """One damped update of this rank's factors from the weights ``w``
        and coefficients ``s`` of its rows, gathered into new replicated
        factors."""
        X = state[0]
        P, eta = self.obs_terms(state, w, s)
        P = P + self.prior_P
        eta = eta + cavi._prior_nat_param(self.pri, X[self.geo.rows])[
            :, self.geo.ts]
        mu_new, cov_new = solve_direct(P, eta)
        own = self.own(state)
        return self.gather_factors(damped(mu_new, own.X_mean, lr),
                                   damped(cov_new, own.X_cov, lr))

    def wrap(self, result, fields) -> Sharded:
        spec = {}
        for f in fields:
            spec[f] = (state_sharding(self.mesh).spec
                       if getattr(result, f).dim() == 3
                       else cov_sharding(self.mesh).spec)
        return Sharded(result, self.mesh, self.sizes, spec)


def fit_bernoulli_sharded(Y: Sharded, params, init: Sharded, *,
                          max_iter: int, learning_rate, tolerance,
                          patience: int, carry_elbo, carry_patience: int,
                          mask) -> Sharded:
    """:func:`tame_torch.inference.binary_cavi.fit_cavi_bernoulli` on
    inputs from :func:`~tame_torch.parallel.mesh.shard_fit_inputs`."""
    rk = _Rank(Y, params, init, mask)
    y0, offd = rk.y0, rk.offd
    state = rk.state
    buf = cavi.history_buffer(max_iter)
    eh = np.full(buf, np.nan, np.float32)
    ah = np.full(buf, np.nan, np.float32)
    rule = cavi._StopRule(carry_elbo, carry_patience, tolerance, patience)
    it = 0
    while it < max_iter and rule.running:
        m, var = rk.moments(state)
        Em2 = m * m + var
        xi = torch.sqrt(torch.clamp(Em2, min=1e-12))
        lam = _lam(xi) * offd
        resid = (y0 - 0.5) * offd
        lik = torch.sum(offd * (resid * m - lam * Em2 + xi / 2.0
                                - softplus(xi) + lam * xi * xi))
        hits = torch.sum(offd * ((m > 0) == (y0 > 0.5)))
        lik, prior0, priort, ent, hits = rk.comm.all_reduce(
            torch.stack([lik, *rk.terms(state), hits]), "mesh")
        state = rk.update(state, 2.0 * lam, resid, learning_rate)
        bound = lik + prior0 + priort + ent
        eh[it], ah[it] = torch.stack([bound, hits / rk.n_obs]).tolist()
        rule.update(float(eh[it]))
        it += 1
    own = rk.own(state)
    return rk.wrap(BernoulliFitResult(
        X_mean=own.X_mean.clone(), X_cov=own.X_cov.clone(),
        elbo_history=torch.from_numpy(eh),
        accuracy_history=torch.from_numpy(ah), n_iter=it,
        converged=rule.converged, diverged=rule.diverged,
        last_elbo=float(rule.prev), pat_count=rule.pat),
        ("X_mean", "X_cov"))


def fit_poisson_sharded(Y: Sharded, params, init: Sharded, *,
                        max_iter: int, learning_rate, tolerance,
                        patience: int, carry, mask) -> Sharded:
    """:func:`tame_torch.inference.poisson_cavi.fit_cavi_poisson` on
    inputs from :func:`~tame_torch.parallel.mesh.shard_fit_inputs`: the
    guard judges the all-reduced exact ELBO.  ``carry``: a previous
    sharded segment's ``resume_carry()`` (its proposal as this rank's
    pieces), with ``init`` that segment's state."""
    rk = _Rank(Y, params, init, mask)
    y0, offd = rk.y0, rk.offd
    logyfac = torch.lgamma(y0 + 1.0)

    def evaluate(state):
        m, var = rk.moments(state)
        w = _weights(m, var, offd)
        lik = torch.sum(offd * (y0 * m - logyfac) - w)
        rate = torch.exp(torch.clamp(m, -_EXP_CLIP, _EXP_CLIP))
        dev = 2.0 * torch.sum(offd * (torch.xlogy(y0, y0) - y0 * m - y0
                                      + rate))
        lik, prior0, priort, ent, dev = rk.comm.all_reduce(
            torch.stack([lik, *rk.terms(state), dev]), "mesh")
        return lik + prior0 + priort + ent, dev / rk.n_obs, m, var

    def cvi_update(base, m, var, lr):
        w = _weights(m, var, offd)
        return rk.update(base, w, (y0 - w + w * m) * offd, lr)

    if carry is None:
        prop, e0, scale0, pat0 = rk.state, -np.inf, 1.0, 0
    else:
        prop, e0, scale0, pat0 = carry
        prop = rk.replicated(prop)
    rule = GuardRule(e0, scale0, pat0, tolerance, patience)
    buf = cavi.history_buffer(max_iter)
    eh = np.full(buf, np.nan, np.float32)
    dh = np.full(buf, np.nan, np.float32)
    state, base = prop, rk.state
    it = 0
    while it < max_iter and rule.running:
        elbo, dev, m, var = evaluate(state)
        elbo, dev = torch.stack([elbo, dev]).tolist()
        if rule.judge(elbo):
            state = base
            m, var = rk.moments(state)
        else:
            dh[it] = dev
        eh[it] = rule.e_base
        base = state
        state = cvi_update(base, m, var, rule.step_lr(learning_rate))
        it += 1
    own, prop = rk.own(base), rk.own(state)
    return rk.wrap(PoissonFitResult(
        X_mean=own.X_mean.clone(), X_cov=own.X_cov.clone(),
        elbo_history=torch.from_numpy(eh),
        deviance_history=torch.from_numpy(dh), n_iter=it,
        converged=rule.converged, diverged=rule.diverged,
        prop_mean=prop.X_mean.clone(), prop_cov=prop.X_cov.clone(),
        last_elbo=float(rule.e_base), step_scale=float(rule.scale),
        pat_count=rule.pat), ("X_mean", "X_cov", "prop_mean", "prop_cov"))


def fit_smoothed_family_sharded(Y: Sharded, params, init: Sharded, *,
                                family, max_iter: int, learning_rate,
                                tolerance, patience: int, mask) -> Sharded:
    """:func:`tame_torch.inference.family_smoothed.fit_smoothed_family` on
    inputs from :func:`~tame_torch.parallel.mesh.shard_smoothed_inputs`
    (a mesh over ``nodes``): the family's terms on the rank's (T, m, n)
    gate against the replicated means and marginal covariances (the
    partner moments read them); one
    :func:`~tame_torch.ops.fused_smoother.fused_smoother` call (K4 on the
    card) per iteration re-solves the rank's trajectories; the new means
    and covariances are all-gathered, the cross-covariances and
    log-determinants stay with their owner.  The guard judges the
    all-reduced objective, so every rank accepts or rejects together."""
    nodes_only(Y.mesh)
    rk = _Rank(Y, params, init, mask)
    y0, offd = rk.y0, rk.offd
    off_prior = -rk.pri.Qinv_Phi.T

    def evaluate(state):
        factors, cross, logdets = state
        m, var = rk.moments(factors)
        loglik, w, s = family.vi_surrogate(y0, offd, m, var)
        own = rk.own(factors)
        loglik, prior0, priort, ent = rk.comm.all_reduce(torch.stack([
            loglik, *smoothed_prior_entropy(rk.params, rk.pri, SmoothedState(
                own.X_mean, own.X_cov, cross, logdets))]), "mesh")
        return loglik + prior0 + priort + ent, w, s

    def update(base, w, s, lr):
        factors = base[0]
        P, eta = rk.obs_terms(factors, w, s)
        out = fused_smoother(P + rk.prior_P, off_prior, eta)
        return (rk.gather_factors(
            damped(out.mean, rk.own(factors).X_mean, lr), out.cov),
            out.cross_cov, out.logdet)

    rule = GuardRule(-np.inf, 1.0, 0, tolerance, patience)
    eh = np.full(cavi.history_buffer(max_iter), np.nan, np.float32)
    state = base = (rk.state, init.local.X_cross, init.local.logdets)
    it = 0
    while it < max_iter and rule.running:
        elbo, w, s = evaluate(state)
        if rule.judge(elbo.item()):
            # rejected: the pseudo-likelihood terms are the base's
            state = base
            _, w, s = evaluate(state)
        eh[it] = rule.e_base
        base = state
        state = update(base, w, s, rule.step_lr(learning_rate))
        it += 1
    own = rk.own(base[0])
    result = SmoothedFamilyResult(
        state=SmoothedState(own.X_mean.clone(), own.X_cov.clone(), *base[1:]),
        elbo_history=torch.from_numpy(eh), n_iter=it,
        converged=rule.converged, diverged=rule.diverged)
    return Sharded(result, rk.mesh, rk.sizes,
                   {"state": smoothed_spec(result.state)})
