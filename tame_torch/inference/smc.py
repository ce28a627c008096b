"""Sequential Monte Carlo with likelihood tempering for the temporal AME
posterior (counterpart of :mod:`tame.inference.smc`).

N particles over the full latent tensor (N, n, T, d) move through a
tempering schedule ``beta: 0 -> 1`` as one batch:

1. init: particles from the AR(1) prior, all N drawn at once
   (:func:`tame_torch.models.temporal_ame.sample_latents` of N n
   trajectories);
2. reweight: incremental weights ``dbeta * loglik`` per particle;
3. resample: systematic resampling when the ESS falls under
   ``ess_threshold * N`` (and after every ESS-limited adaptive step);
4. move: MCMC steps targeting ``prior * lik^beta``, Hamiltonian by
   default (leapfrog with the diagonal mass ``proposal_scale^-2``), or
   random-walk Metropolis (``move_kernel="rwm"``).

The move kernel decides the evidence estimate: in the (n T d)-dimensional
latent space random-walk moves have vanishing acceptance, the population
cannot track the tempered path, and the log-evidence collapses far below
the exact variational lower bound; with Hamiltonian moves it lands above
it, as log p(Y) must (the JAX package's measurements, ``SMC_BENCH.json``;
held here by ``chip_smoke.py`` on the card).

The stage loop runs on the host with one readback per stage (the
temperature reached); the adaptive increment's 30 bisection steps, the
resampling decision and the moves stay on the device.  Randomness comes
from an explicit ``torch.Generator`` on ``Y``'s device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from tame_torch.inference.hmc import (
    declared_family,
    per_chain,
    value_and_grad,
)
from tame_torch.inference.logprob import log_likelihood, log_prior, precompute
from tame_torch.models.params import AMEParams
from tame_torch.models.temporal_ame import sample_latents


class SMCResult(NamedTuple):
    particles: torch.Tensor       # (N, n, T, d) final particles
    log_weights: torch.Tensor     # (N,) final log weights (normalized)
    ess_history: torch.Tensor     # (max_stages,) ESS (NaN past n_stages)
    accept_history: torch.Tensor  # (max_stages,) mean MH acceptance
    log_evidence: torch.Tensor    # SMC estimate of log p(Y)
    beta_history: torch.Tensor    # (max_stages,) realized temperatures
    n_stages: int = 0             # stages run
    n_resamples: int = 0          # resampling events


def systematic_resample(generator: Optional[torch.Generator],
                        log_weights: torch.Tensor, *,
                        u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Systematic resampling: parent indices (N,) from one uniform ``u``
    (drawn from ``generator`` unless given).  An index past the last
    particle (the float32 cumulative sum short of 1) is clamped to it, as
    JAX clamps a gather index."""
    N = log_weights.shape[0]
    if u is None:
        u = torch.rand((), generator=generator, device=log_weights.device,
                       dtype=log_weights.dtype)
    w = torch.softmax(log_weights, 0)
    positions = (u + torch.arange(N, device=log_weights.device,
                                  dtype=log_weights.dtype)) / N
    idx = torch.searchsorted(torch.cumsum(w, 0), positions)
    return torch.clamp(idx, max=N - 1)


def effective_sample_size(log_weights: torch.Tensor) -> torch.Tensor:
    w = torch.softmax(log_weights, -1)
    return 1.0 / torch.sum(w ** 2, -1)


def choose_dbeta(log_weights: torch.Tensor, ll: torch.Tensor,
                 beta: torch.Tensor, target: float) -> torch.Tensor:
    """Largest temperature increment that keeps the reweighted ESS at
    ``target`` (30 bisection steps on the device; Del Moral et al. 2012
    adaptive tempering); the whole remaining step if that keeps it."""
    hi0 = 1.0 - beta

    def ess_at(db):
        return effective_sample_size(log_weights + db * ll)

    lo, hi = torch.zeros_like(hi0), hi0
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(ess_at(hi0) >= target, hi0,
                       torch.maximum(lo, hi0 * 1e-6))


@torch.no_grad()
def run_smc(params: AMEParams, Y: torch.Tensor,
            generator: torch.Generator, *, num_particles: int = 256,
            num_stages: int = 200, num_moves: int = 3,
            step_scale: float = 0.5, ess_threshold: float = 0.5,
            proposal_scale: Optional[torch.Tensor] = None,
            obs_mask: Optional[torch.Tensor] = None,
            move_kernel: str = "hmc", num_leapfrog: int = 10,
            schedule: str = "adaptive",
            resume_from: Optional[SMCResult] = None,
            max_new_stages: Optional[int] = None,
            family=None, shard=None) -> SMCResult:
    """Run tempered SMC on ``Y``'s device (see the module docstring).

    ``proposal_scale`` (n, T, d): the per-coordinate move scale, the RWM
    proposal sd and the HMC diagonal mass ``M = proposal_scale^-2``;
    defaults to the stationary prior marginal scale (pass the CAVI
    posterior scales for production use, as :class:`TemporalAMESMC`
    does).  ``obs_mask`` targets the missing-data posterior.
    ``move_kernel``: ``"hmc"`` (``num_leapfrog`` steps per move, step size
    ``step_scale`` in mass-preconditioned coordinates) or ``"rwm"``
    (proposal sd ``step_scale * proposal_scale``).

    ``schedule``: ``"adaptive"`` picks each increment by bisection so the
    incremental-weight ESS stays at ``ess_threshold * N``; ``num_stages``
    is then the buffer (``n_stages`` says how many ran, the histories are
    NaN-padded past it).  ``"linear"`` takes fixed steps of
    ``1 / num_stages``.

    ``resume_from`` / ``max_new_stages`` segment a sweep across calls:
    pass a previous call's result (same ``num_stages`` buffer) to continue
    it, optionally bounding the stages this call may add; the population,
    weights, evidence, temperature and histories carry over.  Each call
    draws fresh randomness from ``generator``.

    ``shard`` (:class:`tame_torch.parallel.mesh.ChainShard`) splits the
    ``num_particles`` over the ranks of a mesh's ``batch`` axis: a rank
    draws the whole population's numbers and keeps its particles, moves
    them, and all-gathers the log-likelihoods (every rank then holds the
    same weights, ESS, temperature and evidence), the acceptances and, at
    each stage, the particles the resampling reads from.  The returned
    ``particles`` are this rank's; ``log_weights`` cover all."""
    if move_kernel not in ("hmc", "rwm"):
        raise ValueError(f"unknown move_kernel {move_kernel!r}; choose "
                         "from ('hmc', 'rwm')")
    if schedule not in ("adaptive", "linear"):
        raise ValueError(f"unknown schedule {schedule!r}; choose from "
                         "('adaptive', 'linear')")
    dev, dt = Y.device, Y.dtype
    params = params.to(dev, dt)
    consts = precompute(params)
    n, _, T, _ = Y.shape
    d = params.d
    N = num_particles
    if proposal_scale is None:
        proposal_scale = torch.sqrt(torch.diagonal(params.Sigma0)).expand(
            n, T, d)
    if obs_mask is not None:
        obs_mask = torch.as_tensor(obs_mask, dtype=dt, device=dev)

    def loglik(X):
        return log_likelihood(params, Y, X, consts, obs_mask=obs_mask,
                              family=family)

    def tempered_logp(beta):
        return lambda X: log_prior(params, X, consts) + beta * loglik(X)

    def draw(fn, shape):
        """``fn`` drawn for the whole population, this rank's share."""
        kw = dict(generator=generator, device=dev, dtype=dt)
        return fn(shape, **kw) if shard is None else shard.draw(fn, shape,
                                                                **kw)

    def gathered(x):
        return x if shard is None else shard.gather(x)

    def rwm_move(X, beta):
        """One random-walk MH step of every particle."""
        prop = X + step_scale * proposal_scale * draw(torch.randn, X.shape)
        u = draw(torch.rand, (N,))
        target = tempered_logp(beta)
        accept = torch.log(u) < target(prop) - target(X)
        return torch.where(per_chain(accept, X), prop, X), accept.to(dt)

    def hmc_move(X, beta):
        """One Hamiltonian move of every particle: ``num_leapfrog`` steps
        with the diagonal mass ``M = proposal_scale^-2`` (leapfrog in the
        coordinates ``X / proposal_scale`` with scalar step
        ``step_scale``).  A step's closing gradient opens the next one."""
        target = tempered_logp(beta)
        # momentum ~ N(0, M); kinetic energy 0.5 p' M^-1 p
        p = draw(torch.randn, X.shape) / proposal_scale
        u = draw(torch.rand, (N,))

        def kin(p):
            return 0.5 * ((p * proposal_scale) ** 2).flatten(1).sum(1)

        logp, grad = value_and_grad(target, X)
        h_old = -logp + kin(p)
        x, eps = X, step_scale
        for _ in range(num_leapfrog):
            p = p + 0.5 * eps * grad
            x = x + eps * proposal_scale ** 2 * p
            logp, grad = value_and_grad(target, x)
            p = p + 0.5 * eps * grad
        h_new = -logp + kin(p)
        # a non-finite trajectory (diverged leapfrog) is rejected
        log_acc = torch.where(torch.isfinite(h_new), h_old - h_new,
                              -torch.inf)
        accept = torch.log(u) < log_acc
        return torch.where(per_chain(accept, X), x, X), accept.to(dt)

    move = hmc_move if move_kernel == "hmc" else rwm_move

    if resume_from is None:
        particles = sample_latents(params, generator, N * n, T).reshape(
            N, n, T, d).to(dev)
        if shard is not None:
            particles = particles[shard.lo:shard.hi]
        lw = torch.zeros(N, dtype=dt, device=dev)
        logev = torch.zeros((), dtype=dt, device=dev)
        beta = torch.zeros((), dtype=dt, device=dev)
        stage0, nres = 0, torch.zeros((), dtype=torch.int64, device=dev)
        nan = torch.full((num_stages,), math.nan, dtype=dt, device=dev)
        ess_h, acc_h, beta_h = nan, nan.clone(), nan.clone()
        beta_now = 0.0
    else:
        r = resume_from
        particles = r.particles
        # normalized log weights carry over unchanged: the ESS, softmax
        # and evidence increments are invariant to the constant
        lw, logev = r.log_weights, r.log_evidence
        stage0 = int(r.n_stages)
        nres = torch.as_tensor(r.n_resamples, device=dev)
        ess_h, acc_h = r.ess_history.clone(), r.accept_history.clone()
        beta_h = r.beta_history.clone()
        beta = (beta_h[stage0 - 1] if stage0 > 0
                else torch.zeros((), dtype=dt, device=dev))
        beta_now = float(beta)
    stage_cap = num_stages
    if max_new_stages is not None:
        stage_cap = min(num_stages, stage0 + max_new_stages)

    stage = stage0
    while beta_now < 1.0 and stage < stage_cap:
        # 2. reweight (adaptive or fixed increment)
        ll = gathered(loglik(particles))
        remaining = 1.0 - beta
        if schedule == "adaptive":
            dbeta = choose_dbeta(lw, ll, beta, ess_threshold * N)
        else:
            dbeta = torch.clamp(remaining, max=1.0 / num_stages)
        beta = torch.clamp(beta + dbeta, max=1.0)
        new_lw = lw + dbeta * ll
        # evidence increment: log mean exp of the incremental weights
        # under the previous normalized weights
        logev = logev + (torch.logsumexp(new_lw, 0)
                         - torch.logsumexp(lw, 0))
        lw = new_lw
        ess = effective_sample_size(lw)
        # 3. conditional systematic resample; adaptive mode also resamples
        # after every ESS-limited step (the bisection lands the ESS at the
        # threshold, and carrying those weights on stalls the next one)
        do_resample = ess < ess_threshold * N
        if schedule == "adaptive":
            do_resample = do_resample | (dbeta < remaining)
        idx = systematic_resample(generator, lw)
        if shard is not None:
            idx = idx[shard.lo:shard.hi]
        particles = torch.where(do_resample, gathered(particles)[idx],
                                particles)
        lw = torch.where(do_resample, torch.zeros_like(lw), lw)
        nres = nres + do_resample.to(nres.dtype)
        # 4. move: num_moves MCMC steps per particle
        acc = torch.zeros((), dtype=dt, device=dev)
        for _ in range(num_moves):
            particles, a = move(particles, beta)
            acc = acc + gathered(a).mean()
        ess_h[stage] = ess
        acc_h[stage] = acc / num_moves
        beta_h[stage] = beta
        stage += 1
        beta_now = float(beta)              # the stage's one readback
    return SMCResult(particles=particles,
                     log_weights=lw - torch.logsumexp(lw, 0),
                     ess_history=ess_h, accept_history=acc_h,
                     log_evidence=logev, beta_history=beta_h,
                     n_stages=stage, n_resamples=int(nres))


class TemporalAMESMC:
    """SMC posterior sampler with the reference-compatible class feel, on
    the device of the model's ``Y``.  ``precondition`` takes the move
    scales from a short CAVI fit (Gaussian family only); ``mask`` and
    ``family`` as in :class:`~tame_torch.inference.hmc.TemporalAMEHMC`."""

    def __init__(self, model, num_particles: int = 256,
                 num_stages: int = 200, num_moves: int = 3, seed: int = 0,
                 precondition: bool = True, mask=None, family=None):
        if model.Y is None:
            raise ValueError(
                "Model has no data. Call model.generate_data() first.")
        self.model = model
        self.Y = torch.as_tensor(model.Y)
        self.params = model.params.to(self.Y.device, self.Y.dtype)
        self.num_particles = num_particles
        self.num_stages = num_stages
        self.num_moves = num_moves
        self.seed = seed
        self.family, self.precondition = declared_family(family,
                                                         precondition)
        self.mask = (None if mask is None else torch.as_tensor(
            mask, dtype=self.Y.dtype, device=self.Y.device))

    def sample(self, mesh=None, stages_per_call=None) -> SMCResult:
        """Run the tempered sweep.  ``stages_per_call`` splits it into
        calls of at most that many stages, carried with ``resume_from``
        (for checkpointed or very long adaptive schedules).  ``mesh`` (a
        :func:`tame_torch.parallel.make_mesh` mesh with a ``batch`` axis
        that divides ``num_particles``) splits the particles over its
        ranks (:func:`run_smc`'s ``shard``) and returns a
        :class:`~tame_torch.parallel.mesh.Sharded` result whose ``full()``
        gathers them; any other ``mesh`` raises ``TypeError``."""
        shard = None
        if mesh is not None:
            from tame_torch.parallel.mesh import chain_shard

            shard = chain_shard(mesh, self.num_particles)
        proposal_scale = None
        if self.precondition:
            from tame_torch.inference.hmc import precondition_from_cavi

            _, variances = precondition_from_cavi(
                self.Y, self.params, seed=self.seed, mask=self.mask)
            proposal_scale = torch.sqrt(variances)
        gen = torch.Generator(device=self.Y.device).manual_seed(self.seed)
        kw = dict(num_particles=self.num_particles,
                  num_stages=self.num_stages, num_moves=self.num_moves,
                  proposal_scale=proposal_scale, obs_mask=self.mask,
                  family=self.family, shard=shard)
        res = None
        while True:
            res = run_smc(self.params, self.Y, gen, resume_from=res,
                          max_new_stages=stages_per_call, **kw)
            ns = res.n_stages
            if (stages_per_call is None or ns >= self.num_stages
                    or float(res.beta_history[ns - 1]) >= 1.0):
                self._warn_if_partial(res)
                return (res if shard is None
                        else shard.wrap(res, ("particles",)))

    @staticmethod
    def _warn_if_partial(result: SMCResult) -> None:
        """The adaptive schedule stops at the stage buffer if beta has not
        reached 1: the particles then target a tempered posterior and the
        log-evidence is partial.  Say so loudly."""
        ns = result.n_stages
        if ns == 0:
            return
        beta = float(result.beta_history[ns - 1])
        if beta < 1.0:
            print(f"WARNING: SMC exhausted its {ns}-stage buffer at "
                  f"beta={beta:.4f} < 1 — the log-evidence is PARTIAL "
                  "and the particles target a tempered posterior; "
                  "raise num_stages (the adaptive schedule needs more "
                  "room) or continue with "
                  "run_smc(resume_from=result).", flush=True)

    def posterior_mean(self, result: SMCResult) -> torch.Tensor:
        w = torch.softmax(result.log_weights, 0)
        return torch.einsum("p,pntd->ntd", w, result.particles)
