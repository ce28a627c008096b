"""Smoothed CAVI: per-node joint-trajectory variational family, dense
float32 path (counterpart of :mod:`tame.inference.smoothed`).

Each node's whole trajectory is one joint Gaussian

    q(X) = prod_i q(X_i^{0:T-1}),

whose exact coordinate update, given the other nodes' means, is the
block-tridiagonal system solved by AR(1) forward-backward smoothing
(:func:`tame_torch.ops.fused_smoother.fused_smoother`: the K4 kernel on
the card, its plain twin :mod:`tame_torch.ops.tridiag` on the CPU):

    D_t = P_obs[t] + [t=0] Sigma0^-1 + [t>0] Q^-1 + [t<T-1] Phi' Q^-1 Phi
    O   = -Phi' Q^-1        (precision block (t, t+1))
    b_t = eta_obs[t]        (time coupling handled exactly)

With ``smoother="parallel"`` the same systems are solved by the
O(log T)-depth associative-scan smoother
(:func:`tame_torch.ops.ptridiag.parallel_block_tridiag_smoother`), which
takes the observation terms and the AR(1) prior instead of the blocks.

The ELBO has exact cross-time terms: transition expectations use the lag-1
cross-covariances and the entropy the trajectory log-determinants.
Damping applies to the means only; covariances come fresh from each solve.

:func:`fit_cavi_smoothed` is a Python loop with one host read of the ELBO
per iteration and the JAX loop's stopping rule (``cavi._StopRule``); on
the card its iterations after the first are CUDA graph replays
(:mod:`tame_torch.inference.graphed`; not with the associative-scan
smoother).  Masks, bf16 weights and stats
diagnostics share the CAVI engine's inputs and diagnostics
(``cavi.fit_inputs``, ``cavi.residual_stats``).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from tame_torch.inference import cavi, graphed
from tame_torch.models.params import AMEParams, _fields_as_tensors
from tame_torch.ops import dyad as dyad_ops
from tame_torch.ops.fused_smoother import (
    fused_smoother,
    fused_smoother_supported,
)
from tame_torch.ops.ptridiag import parallel_block_tridiag_smoother
from tame_torch.utils import profiling

_LOG2PI = 1.8378770664093453


class SmoothedState(NamedTuple):
    X_mean: torch.Tensor    # (n, T, d)
    X_cov: torch.Tensor     # (n, T, d, d)   marginal covariances
    X_cross: torch.Tensor   # (n, T-1, d, d) Cov(X_t, X_{t+1}) per node
    logdets: torch.Tensor   # (n,)           log det of each joint precision


class SmoothedFitResult(NamedTuple):
    state: SmoothedState
    elbo_history: torch.Tensor   # (buf,) on the CPU, NaN past the stop
    mse_history: torch.Tensor    # (buf,)
    n_iter: int
    converged: bool
    diverged: bool
    last_elbo: float             # convergence carry for a follow-up fit
    pat_count: int


def smoothed_state_from_numpy(s, device=None,
                              dtype=torch.float32) -> SmoothedState:
    """Port's :class:`SmoothedState` from any object (or dict) holding its
    four fields as arrays (e.g. the JAX ``SmoothedState``)."""
    return SmoothedState(**_fields_as_tensors(s, SmoothedState._fields,
                                              device, dtype))


def _fresh_covariances(n: int, T: int, d: int, dtype, device):
    """Independent 0.5 I blocks: marginal covariances, zero cross terms and
    the log det of the joint precision (2 I per block)."""
    eye = torch.eye(d, dtype=dtype, device=device)
    return ((eye * 0.5).expand(n, T, d, d).clone(),
            torch.zeros(n, max(T - 1, 0), d, d, dtype=dtype, device=device),
            torch.full((n,), -T * d * math.log(0.5), dtype=dtype,
                       device=device))


def init_smoothed_state(generator: torch.Generator, n: int, T: int, d: int,
                        init_scale: float = 0.1,
                        device=None) -> SmoothedState:
    """Random init: means ``N(0, init_scale^2)`` drawn from ``generator``
    on its device, then moved to ``device``."""
    X_mean = torch.randn(n, T, d, generator=generator,
                         device=generator.device) * init_scale
    profiling.count_copies((X_mean,), device or generator.device)
    X_mean = X_mean.to(device or generator.device)
    return SmoothedState(X_mean, *_fresh_covariances(
        n, T, d, X_mean.dtype, X_mean.device))


def warm_init_smoothed_state(Y: torch.Tensor, params: AMEParams,
                             obs_mask=None, *,
                             probe: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> SmoothedState:
    """Data-driven warm start: the centroid decomposition of
    :func:`tame_torch.inference.cavi.warm_init_state` (``probe`` /
    ``generator`` as there) with the smoothed family's deterministic
    covariances.

    A sharded ``Y`` (:func:`tame_torch.parallel.shard_smoothed_inputs`)
    returns the state as that function places one
    (:func:`tame_torch.parallel.sharded_init.warm_init_smoothed_sharded`).
    """
    if cavi.is_sharded(Y):
        from tame_torch.parallel.sharded_init import (
            warm_init_smoothed_sharded,
        )

        return warm_init_smoothed_sharded(Y, params, obs_mask=obs_mask,
                                          probe=probe, generator=generator)
    warm = cavi.warm_init_state(Y, params, structure="full",
                                obs_mask=obs_mask, probe=probe,
                                generator=generator)
    n, T, d = warm.X_mean.shape
    return SmoothedState(warm.X_mean, *_fresh_covariances(
        n, T, d, warm.X_mean.dtype, warm.X_mean.device))


def smoothed_step(state: SmoothedState, obs: cavi.ObsConstants,
                  pri: cavi.PriorMatrices, params: AMEParams, lr: float,
                  corrected: bool = True, parallel: bool = False,
                  mask=None) -> SmoothedState:
    """One simultaneous update: every node's trajectory re-solved exactly
    against the other nodes' current means, in one
    :func:`fused_smoother` call.  ``mask`` (missing-data fits) as in
    ``cavi.cavi_step_jacobi``.  ``parallel=True`` solves with the
    time-parallel associative-scan smoother
    (:func:`~tame_torch.ops.ptridiag.parallel_block_tridiag_smoother`,
    O(log T) depth), which takes the observation terms and the AR(1)
    prior ``(Phi, Q, Sigma0)`` and launches no K4.

    Under a mask the JAX package leaves its Pallas smoother for the scan;
    the port sends every sequential smooth through :func:`fused_smoother`
    (K4 on the card) all the same: the smoother solves whatever D and b
    it is given, so the result is the same."""
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    _, _, U, V = dyad_ops.split_state(state.X_mean, r)
    D_obs = (cavi._obs_precision(U, V, params.R_inv) if mask is None
             else cavi._masked_obs_precision(mask, U, V, params.R_inv))
    b = cavi._obs_nat_param(obs, state.X_mean, r, params.R_inv, corrected,
                            mask=mask)
    out = _trajectory_solver(pri, params, T, parallel)(D_obs, b)
    return SmoothedState(X_mean=lr * out.mean + (1.0 - lr) * state.X_mean,
                         X_cov=out.cov, X_cross=out.cross_cov,
                         logdets=out.logdet)


def _trajectory_solver(pri: cavi.PriorMatrices, params: AMEParams, T: int,
                       parallel: bool):
    """``(D_obs, b) -> SmootherResult`` for one update: the
    associative-scan smoother on the observation terms, or
    :func:`fused_smoother` on the full precision blocks (the prior
    blocks, built once here, added)."""
    if parallel:
        return lambda D_obs, b: parallel_block_tridiag_smoother(
            D_obs, b, params.Phi, params.Q, params.Sigma0)
    prior_D = cavi._prior_precision(pri, T)[None]
    O = -pri.Qinv_Phi.T
    return lambda D_obs, b: fused_smoother(D_obs + prior_D, O, b)


def smoothed_step_block(state: SmoothedState, obs: cavi.ObsConstants,
                        pri: cavi.PriorMatrices, params: AMEParams,
                        lr: float, num_blocks: int,
                        corrected: bool = True, parallel: bool = False,
                        mask=None) -> SmoothedState:
    """Block Gauss-Seidel smoothed update: node blocks re-solved in
    sequence, each block's trajectories solved exactly against the
    freshest other-node means (fresh statistics per phase, as
    ``cavi.cavi_step_block``, masked partner sums under ``mask``; no
    neighbour-mean prior coupling, time is handled exactly), one
    :func:`fused_smoother` call per block (the associative-scan smoother
    under ``parallel=True``, as in :func:`smoothed_step`).  Works on a
    copy of ``state``, updated in place."""
    n, T, d = state.X_mean.shape
    if n % num_blocks != 0:
        raise ValueError(f"num_blocks={num_blocks} must divide n={n}")
    bs = n // num_blocks
    solve = _trajectory_solver(pri, params, T, parallel)
    contract = cavi._block_mask_contract(mask, num_blocks, bs)
    X_mean = state.X_mean.clone()
    X_cov, X_cross = state.X_cov.clone(), state.X_cross.clone()
    logdets = state.logdets.clone()

    for blk in range(num_blocks):
        sl = slice(blk * bs, (blk + 1) * bs)
        D_obs, bvec = cavi._block_obs_terms(X_mean, obs, params.R_inv, blk,
                                            bs, corrected, contract)
        out = solve(D_obs, bvec)
        X_mean[sl] = lr * out.mean + (1.0 - lr) * X_mean[sl]
        X_cov[sl] = out.cov
        X_cross[sl] = out.cross_cov
        logdets[sl] = out.logdet
    return SmoothedState(X_mean=X_mean, X_cov=X_cov, X_cross=X_cross,
                         logdets=logdets)


# ---------------------------------------------------------------------------
# ELBO
# ---------------------------------------------------------------------------

def smoothed_elbo(Y: torch.Tensor, params: AMEParams,
                  pri: cavi.PriorMatrices, state: SmoothedState,
                  mu_dyadic: Optional[torch.Tensor] = None,
                  obs_mask=None) -> torch.Tensor:
    """ELBO with exact cross-time transition terms and trajectory entropy;
    the likelihood uses the structured engines' plug-in + trace-correction
    convention, so values are comparable to Good SMF.  Under ``obs_mask``
    it runs over observed dyads (NaN-coded hidden entries are never
    read).  A sharded ``Y`` and ``state`` sum each rank's nodes
    (:func:`tame_torch.parallel.sharded_cavi.smoothed_elbo_sharded`)."""
    if cavi._sharded(Y, state):
        from tame_torch.parallel.sharded_cavi import smoothed_elbo_sharded

        cavi.refuse_mu_dyadic(mu_dyadic)
        return smoothed_elbo_sharded(Y, params, pri, state, obs_mask)
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    if obs_mask is None:
        mask = dyad_ops.offdiag_mask(n, Y.dtype, Y.device)[:, :, None]
        mask_stats = None
    else:
        mask, Y = cavi._observed(Y, obs_mask)
        mask_stats = cavi._mask_stats(mask)
    if mu_dyadic is None:
        mu_dyadic = dyad_ops.dyadic_mean_temporal(state.X_mean, r)
    resid = Y - mu_dyadic
    p_, q_ = params.R_inv[0, 0], params.R_inv[0, 1]
    e0, e1 = resid[..., 0], resid[..., 1]
    quad = p_ * (e0 * e0 + e1 * e1) + 2.0 * q_ * (e0 * e1)
    quad_sum = 0.5 * torch.sum(quad * mask)
    return smoothed_elbo_from_quad(quad_sum, params, pri, state,
                                   mask_stats=mask_stats)


def smoothed_elbo_from_quad(quad_sum: torch.Tensor, params: AMEParams,
                            pri: cavi.PriorMatrices, state: SmoothedState,
                            mask_stats=None) -> torch.Tensor:
    """Smoothed ELBO given ``sum_{i<j,t} resid' R^-1 resid``; every other
    term depends only on the variational state.  ``mask_stats`` as in
    ``cavi._elbo_from_quad``."""
    n, T, d = state.X_mean.shape
    tr_cov = torch.diagonal(state.X_cov, dim1=-2, dim2=-1).sum(-1)
    if mask_stats is None:
        n_dyads = n * (n - 1) // 2 * T
        wsum = (n - 1) * torch.sum(tr_cov)
    else:
        n_dyads = mask_stats[0]
        wsum = torch.sum(mask_stats[1] * tr_cov)
    return smoothed_elbo_from_terms(
        quad_sum, n_dyads, wsum,
        *smoothed_prior_entropy(params, pri, state), params, pri, d)


def smoothed_elbo_from_terms(quad_sum, n_dyads, wsum, prior0, priort,
                             entropy, params: AMEParams,
                             pri: cavi.PriorMatrices, d: int) -> torch.Tensor:
    """The smoothed ELBO from its sums (as ``cavi.elbo_from_terms``; a
    sharded fit all-reduces them first)."""
    log_lik = -0.5 * (quad_sum + n_dyads * (pri.logdet_R + 2.0 * _LOG2PI))
    corr = 0.1 * torch.trace(params.R_inv) / d * wsum
    log_lik = log_lik - 0.5 * corr
    return log_lik + prior0 + priort + entropy


def smoothed_prior_entropy(params: AMEParams, pri: cavi.PriorMatrices,
                           state: SmoothedState) -> tuple:
    """The likelihood-independent ELBO terms ``(prior0, priort,
    entropy)``: exact cross-time transition expectations

        E[(x_t - Phi x_{t-1})' Q^-1 (...)] = resid-quad(means)
            + tr(Q^-1 Sig_t) + tr(Phi' Q^-1 Phi Sig_{t-1})
            - 2 tr(Q^-1 Phi C_{t-1,t})

    and the joint-trajectory entropy ``0.5 (T d (1 + log 2 pi) -
    logdet P)`` per node."""
    n, T, d = state.X_mean.shape
    mu0 = state.X_mean[:, 0]
    quad0 = torch.einsum("ia,ab,ib->", mu0, pri.Sigma0_inv, mu0)
    trace0 = torch.einsum("ab,iba->", pri.Sigma0_inv, state.X_cov[:, 0])
    prior0 = -0.5 * (quad0 + trace0
                     + n * (pri.logdet_Sigma0 + d * _LOG2PI))
    if T > 1:
        residt = state.X_mean[:, 1:] - state.X_mean[:, :-1] @ params.Phi.T
        quadt = torch.einsum("ita,ab,itb->", residt, pri.Q_inv, residt)
        tr_t = torch.einsum("ab,itba->", pri.Q_inv, state.X_cov[:, 1:])
        tr_prev = torch.einsum("ab,itba->", pri.PhiT_Qinv_Phi,
                               state.X_cov[:, :-1])
        tr_cross = torch.einsum("ab,itba->", pri.Qinv_Phi, state.X_cross)
        priort = -0.5 * (quadt + tr_t + tr_prev - 2.0 * tr_cross
                         + n * (T - 1) * (pri.logdet_Q + d * _LOG2PI))
    else:
        priort = state.X_mean.new_zeros(())
    entropy = 0.5 * (n * T * d * (1.0 + _LOG2PI) - torch.sum(state.logdets))
    return prior0, priort, entropy


# ---------------------------------------------------------------------------
# Full fit
# ---------------------------------------------------------------------------

@profiling.spanned("fit.run")
def fit_cavi_smoothed(Y: torch.Tensor, params: AMEParams,
                      init: SmoothedState, *, max_iter: int = 100,
                      learning_rate=0.8, tolerance=1e-4, patience: int = 3,
                      corrected: bool = True, fused="auto",
                      smoother: str = "auto", update_mode: str = "auto",
                      num_blocks=None, mixed_precision: bool = False,
                      diag_mode: str = "exact", carry_elbo=None,
                      carry_patience: int = 0,
                      mask=None) -> SmoothedFitResult:
    """Run smoothed CAVI to convergence (the JAX ``fit_cavi_smoothed``
    contract).

    ``smoother`` picks the trajectory solver: ``"sequential"`` (and
    ``"auto"``, which resolves to it, as in the JAX package) sends every
    smooth through :func:`~tame_torch.ops.fused_smoother.fused_smoother`:
    K4 on a CUDA ``Y`` (which raises outside
    :func:`fused_smoother_supported`), its plain twin on a CPU one.
    ``"parallel"`` takes the O(log T)-depth associative-scan smoother
    (:mod:`tame_torch.ops.ptridiag`, batched ``torch.linalg`` solves on
    either device) in the Jacobi, block and masked modes, and launches no
    K4.  ``fused`` keeps the JAX keyword and is only checked: ``True``
    raises up front outside the envelope and together with
    ``smoother="parallel"`` (``"auto"`` yields to the parallel smoother).
    ``TAME_DISABLE_FUSED_FIT``, which sends the JAX fit to its scan
    smoother, is not read here: the sequential smoothed fit always runs K4
    on the card.  ``update_mode``: ``"jacobi"`` (:func:`smoothed_step`),
    ``"block"`` (:func:`smoothed_step_block`, ``num_blocks`` defaulting to
    the largest divisor of n that is <= 16) or ``"auto"`` (block once
    n >= 256).

    Stops once the relative ELBO change stays below ``tolerance`` for
    ``patience`` consecutive iterations, or when the ELBO goes non-finite
    (``diverged``).  Histories are NaN-padded buffers of the next power of
    two >= max(max_iter, 64).  ``carry_elbo``/``carry_patience`` seed the
    stopping rule from a previous segment's ``last_elbo``/``pat_count``.

    ``mask``, ``mixed_precision`` and ``diag_mode`` as in
    ``cavi.fit_cavi``: the mask's diagonal is zeroed, masked entries of
    ``Y`` are never read, and ``TAME_PACKED_MASK=1`` sends the masked
    contractions through K5, packed with the block count.  Under a mask
    the JAX function leaves its Pallas smoother; this one does not (see
    :func:`smoothed_step`).

    ``Y`` and ``init`` from :func:`tame_torch.parallel.shard_smoothed_inputs`
    run the fit sharded over the mesh's ``nodes`` ranks
    (:func:`tame_torch.parallel.sharded_cavi.fit_smoothed_sharded`).
    """
    if cavi._sharded(Y, init):
        from tame_torch.parallel.sharded_cavi import fit_smoothed_sharded

        return fit_smoothed_sharded(
            Y, params, init, max_iter=max_iter, learning_rate=learning_rate,
            tolerance=tolerance, patience=patience, corrected=corrected,
            fused=fused, smoother=smoother, update_mode=update_mode,
            num_blocks=num_blocks, mixed_precision=mixed_precision,
            diag_mode=diag_mode, carry_elbo=carry_elbo,
            carry_patience=carry_patience, mask=mask)
    if diag_mode not in ("exact", "stats"):
        raise ValueError(f"unknown diag_mode: {diag_mode!r}")
    if smoother not in ("auto", "sequential", "parallel"):
        raise ValueError(f"unknown smoother: {smoother!r}")
    if update_mode not in ("auto", "jacobi", "block"):
        raise ValueError(f"unknown update_mode: {update_mode!r}")
    if fused not in ("auto", True, False):
        raise ValueError(f"unknown fused: {fused!r}")
    if smoother == "parallel" and fused is True:
        raise ValueError("fused=True and smoother='parallel' are mutually "
                         "exclusive solver choices; drop one (fused='auto' "
                         "yields to the parallel smoother)")
    parallel = smoother == "parallel"
    buf = cavi.history_buffer(max_iter)
    n, _, T, _ = Y.shape
    d = init.X_mean.shape[-1]
    if fused is True and not fused_smoother_supported(n, T, d):
        raise ValueError(f"fused smoother unsupported for n={n}, T={T}, "
                         f"d={d} (needs an even d from 4 to 48)")
    if update_mode == "auto":
        update_mode = "block" if n >= 256 else "jacobi"
    if update_mode == "block" and num_blocks is None:
        num_blocks = next(k for k in range(min(16, n), 0, -1) if n % k == 0)
    if mask is not None:
        mask = cavi.gated_mask(mask, Y)
    fi = cavi.fit_inputs(
        Y, params.R_inv, mask, mixed_precision=mixed_precision,
        diag_mode=diag_mode,
        packed_mask=mask is not None and cavi.packed_mask_requested(),
        num_blocks=num_blocks if update_mode == "block" else 1)
    pri = cavi.precompute_priors(params)
    p_, q_ = params.R_inv[0, 0], params.R_inv[0, 1]
    lr = float(learning_rate)
    eh = np.full(buf, np.nan, np.float32)
    mh = np.full(buf, np.nan, np.float32)
    rule = cavi._StopRule(carry_elbo, carry_patience, tolerance, patience)

    # the step functions are looked up by name at each call, as in
    # cavi.fit_loop
    def step(state):
        if update_mode == "block":
            return smoothed_step_block(state, fi.obs, pri, params, lr,
                                       num_blocks, corrected, parallel,
                                       mask=fi.mask_c)
        return smoothed_step(state, fi.obs, pri, params, lr, corrected,
                             parallel, mask=fi.mask_c)

    def diagnostics(state):
        sq, cross = cavi.residual_stats(fi, state.X_mean, params.R_inv,
                                        diag_mode)
        elbo_t = smoothed_elbo_from_quad(p_ * sq + q_ * cross, params, pri,
                                         state, mask_stats=fi.mask_stats)
        return torch.stack([elbo_t, 2.0 * sq / fi.mse_norm])

    it = 0
    graphs = graphed.engages(Y.device, max_iter, capturable=not parallel)
    with graphed.LoopRunner(step, diagnostics, init, graphs) as loop:
        while it < max_iter and rule.running:
            with profiling.span("loop.step"):
                loop.step()
            out = loop.diagnostics()
            with profiling.span("loop.readback"):
                elbo, mse = out.tolist()
                profiling.count(profiling.SYNCS)
            eh[it], mh[it] = elbo, mse
            rule.update(elbo)
            it += 1
    return SmoothedFitResult(state=loop.state,
                             elbo_history=torch.from_numpy(eh),
                             mse_history=torch.from_numpy(mh), n_iter=it,
                             converged=rule.converged,
                             diverged=rule.diverged,
                             last_elbo=float(rule.prev), pat_count=rule.pat)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class TemporalAMESmoothedVI(torch.nn.Module):
    """Engine for the smoothed (joint-trajectory) family, an ``nn.Module``
    whose buffers are the variational state on the device of the model's
    ``Y``: ``X_mean``, ``X_cov`` (marginal covariances), ``X_cross``
    (lag-1 cross-covariances) and ``logdets``.

    ``init_mode="warm"`` starts from
    :func:`warm_init_smoothed_state` (subspace probe from a CPU generator
    seeded 0, as the JAX engine uses ``PRNGKey(0)``); ``"random"`` from
    :func:`init_smoothed_state` seeded ``seed``.  ``mask``,
    ``mixed_precision`` and ``diag_mode`` go to every fit (and ``mask`` to
    the warm init).  Segmented fits with checkpoints and a bit-for-bit
    resume work as in the CAVI engines
    (:meth:`tame_torch.inference.TemporalAMECaviVI.fit`).
    """

    structure = "smoothed"

    @profiling.spanned("engine.build")
    def __init__(self, model, learning_rate: float = 0.8,
                 init_scale: float = 0.1, seed: int = 42,
                 corrected: bool = True, init_mode: str = "random",
                 update_mode: str = "auto", num_blocks=None,
                 mixed_precision: bool = False, diag_mode: str = "exact",
                 mask=None):
        super().__init__()
        if model.Y is None:
            raise ValueError(
                "Model has no data. Call model.generate_data() first.")
        self.model = model
        self.Y = torch.as_tensor(model.Y)
        self.n, self.T, self.d, self.r = model.n, model.T, model.d, model.r
        self.lr = learning_rate
        self.seed = seed
        self.corrected = corrected
        self.update_mode = update_mode
        self.num_blocks = num_blocks
        self.mixed_precision = mixed_precision
        self.diag_mode = diag_mode
        profiling.count_copies((*model.params, mask), self.Y.device)
        self.mask = (None if mask is None else torch.as_tensor(
            mask, dtype=self.Y.dtype, device=self.Y.device))
        self.params = model.params.to(self.Y.device, self.Y.dtype)
        self.history = {"elbo": [], "reconstruction_error": []}
        self._converged = self._diverged = False
        self._carry_elbo: Optional[float] = None
        self._carry_pat = 0
        with profiling.span("engine.start"):
            if init_mode == "warm":
                st = warm_init_smoothed_state(self.Y, self.params,
                                              obs_mask=self.mask)
            elif init_mode == "random":
                st = init_smoothed_state(
                    torch.Generator().manual_seed(seed), self.n, self.T,
                    self.d, init_scale, device=self.Y.device)
            else:
                raise ValueError(f"unknown init_mode '{init_mode}'")
        for name, value in st._asdict().items():
            self.register_buffer(name, value)

    def _state(self) -> SmoothedState:
        return SmoothedState(self.X_mean, self.X_cov, self.X_cross,
                             self.logdets)

    @profiling.spanned("engine.fit")
    def fit(self, max_iter: int = 100, tolerance: float = 1e-4,
            verbose: bool = True, check_every: int = 10,
            checkpoint_every=None, ckpt_dir=None, resume: bool = False):
        """Run smoothed CAVI to convergence from the current state; the
        history grows by the iterations run.  ``checkpoint_every``,
        ``ckpt_dir`` and ``resume`` as in the CAVI engines: segments with
        the convergence carry threaded through, an asynchronous checkpoint
        after each, and a resume that reproduces the uninterrupted fit bit
        for bit."""
        if resume:
            if ckpt_dir is None:
                raise ValueError("resume=True requires ckpt_dir")
            if os.path.exists(os.fspath(ckpt_dir)):
                self.load_checkpoint(ckpt_dir)
        done = len(self.history["elbo"])
        budget = max_iter - done if resume else max_iter
        if budget <= 0:
            return self.history
        segment = checkpoint_every or budget
        if not (resume and done > 0):
            self._carry_elbo, self._carry_pat = None, 0
            self._converged = self._diverged = False
        ckptr = None
        if checkpoint_every and ckpt_dir is not None:
            from tame_torch.io.async_ckpt import AsyncCheckpointer

            ckptr = AsyncCheckpointer()
        while budget > 0 and not (self._converged or self._diverged):
            result = fit_cavi_smoothed(
                self.Y, self.params, self._state(),
                max_iter=min(segment, budget), learning_rate=self.lr,
                tolerance=tolerance, corrected=self.corrected,
                update_mode=self.update_mode, num_blocks=self.num_blocks,
                mixed_precision=self.mixed_precision,
                diag_mode=self.diag_mode, mask=self.mask,
                carry_elbo=self._carry_elbo,
                carry_patience=self._carry_pat)
            for name, value in result.state._asdict().items():
                setattr(self, name, value)
            n_iter = result.n_iter
            eh = result.elbo_history[:n_iter].tolist()
            mh = result.mse_history[:n_iter].tolist()
            self.history["elbo"].extend(eh)
            self.history["reconstruction_error"].extend(mh)
            self._converged, self._diverged = result.converged, result.diverged
            self._carry_elbo = result.last_elbo
            self._carry_pat = result.pat_count
            budget -= n_iter
            if checkpoint_every:
                if ckptr is not None:
                    ckptr.save(ckpt_dir, self._checkpoint_state())
                if verbose and n_iter:
                    print(f"Iter {len(self.history['elbo']) - 1:4d} | "
                          f"ELBO: {eh[-1]:10.2f} | MSE: {mh[-1]:.6f}"
                          + (" | checkpointed" if ckpt_dir else ""),
                          flush=True)
        if ckptr is not None:
            ckptr.wait()

        n_total = len(self.history["elbo"])
        if self._diverged:
            print(f"WARNING: {self.__class__.__name__} halted at "
                  f"iteration {n_total - 1}: ELBO became non-finite "
                  "(try a smaller learning_rate).")
        if verbose and not checkpoint_every:
            eh = self.history["elbo"]
            mh = self.history["reconstruction_error"]
            for it in range(done, n_total):
                if (it - done) % check_every == 0 or it == n_total - 1:
                    print(f"Iter {it:4d} | ELBO: {eh[it]:10.2f} | "
                          f"MSE: {mh[it]:.6f}")
        return self.history

    def get_variational_means(self) -> torch.Tensor:
        return self.X_mean

    def get_variational_covariances(self) -> torch.Tensor:
        return self.X_cov

    def predict_forward(self, n_steps: int = 1) -> torch.Tensor:
        """AR(1) forward forecast from the last smoothed means:
        (n, n_steps, d)."""
        from tame_torch.inference.engine import forecast_means

        return forecast_means(self.X_mean[:, -1], self.params.Phi, n_steps)

    def _checkpoint_state(self) -> dict:
        """The fit state in the JAX engine's checkpoint layout."""
        state = self._state()._asdict()
        state.update({
            "history": {
                "elbo": np.asarray(self.history["elbo"]),
                "reconstruction_error": np.asarray(
                    self.history["reconstruction_error"]),
            },
            "structure": self.structure,
            "learning_rate": self.lr,
            "seed": self.seed,
            "carry_elbo": self._carry_elbo,
            "carry_pat": self._carry_pat,
            "converged": bool(self._converged),
            "diverged": bool(self._diverged),
        })
        return state

    def save_checkpoint(self, ckpt_dir) -> None:
        """Checkpoint the whole smoothed-fit state (means, marginal and
        lag-1 cross covariances, logdets, history, convergence carry)."""
        from tame_torch.io import save_checkpoint

        save_checkpoint(ckpt_dir, self._checkpoint_state())

    def load_checkpoint(self, ckpt_dir) -> None:
        """Restore a checkpoint written by :meth:`save_checkpoint` or by
        the JAX engine onto the device of ``Y``; a later ``fit`` continues
        from it."""
        from tame_torch.io import load_checkpoint

        state = load_checkpoint(ckpt_dir)
        if state.get("structure", "smoothed") != "smoothed":
            raise ValueError(
                f"checkpoint structure '{state.get('structure')}' is not "
                "'smoothed'")
        for name in SmoothedState._fields:
            setattr(self, name, torch.as_tensor(state[name],
                                                device=self.Y.device))
        self.history = {
            "elbo": np.asarray(state["history"]["elbo"]).tolist(),
            "reconstruction_error": np.asarray(
                state["history"]["reconstruction_error"]).tolist(),
        }
        self._carry_elbo = state.get("carry_elbo")
        self._carry_pat = int(state.get("carry_pat", 0))
        self._converged = bool(state.get("converged", False))
        self._diverged = bool(state.get("diverged", False))
