"""CAVI for BINARY dynamic networks via the Jaakkola-Jordan bound
(counterpart of :mod:`tame.inference.binary_cavi`).

The JJ bound makes each Bernoulli term quadratic,

    log p(y|m) >= (y - 1/2) m - lam(xi) m^2 + xi/2 - log(1 + e^xi)
                  + lam(xi) xi^2,     lam(xi) = tanh(xi/2) / (4 xi),

tight at ``xi^2 = E_q[m^2]``, so every directed dyad contributes a
Gaussian-shaped term of precision ``2 lam`` and the CAVI machinery applies
with iteration-dependent weighted contractions
(:func:`weighted_obs_terms`): node i's sender side [a, U] from ``m_ij``,
its receiver side [b, V] from ``m_ji``.

Layout: every (n, n, T)-sized quantity of the engine (the observations,
the gate, the predictor moments ``m``/``var``, the weights ``w`` and
coefficients ``s``) is kept time-major, (T, n, n) with ``[t, i, j]``, so
that each contraction is one ``bmm`` over t: a variance term of width r^2
is an (n, K) @ (K, n) product per t, the sender contraction ``bmm(w,
panel)`` and the receiver one ``bmm(w.transpose(1, 2), panel)``, a
transposed operand with no copy.  The data and the gate are permuted once
per fit.  These products run outside any kernel in the JAX package too, so
they stay ``torch.bmm`` (full float32; TF32 is off).

The per-(node, time) solve (:func:`solve_direct`) is one batched SPD
solve with inverse over B = n T systems: K1 on the card, its twin on the
CPU; the bound's entropy is ``cavi.gaussian_entropy``, K2 on the card.

The fit is a Python loop with one host read of the bound and the accuracy
per iteration and the JAX loop's stopping rule (``cavi._StopRule``).
Missing data: an (n, n, T) mask zeroes hidden dyads in every sum through
``where``, so NaN-coded hidden entries of ``Y`` are never read.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from tame_torch.inference import cavi
from tame_torch.inference.engine import forecast_means
from tame_torch.models.likelihoods import softplus
from tame_torch.models.params import AMEParams
from tame_torch.ops import dyad as dyad_ops
from tame_torch.ops.cholesky import batched_spd_solve_inv


class BernoulliFitResult(NamedTuple):
    X_mean: torch.Tensor            # (n, T, d)
    X_cov: torch.Tensor             # (n, T, d, d)
    elbo_history: torch.Tensor      # (buf,) the JJ bound, NaN past the stop
    accuracy_history: torch.Tensor  # (buf,) plug-in tie-prediction accuracy
    n_iter: int
    converged: bool
    diverged: bool
    last_elbo: float                # convergence carry for a follow-up fit
    pat_count: int


class FamilyInputs(NamedTuple):
    """The loop-invariant inputs of a non-Gaussian fit, time-major."""

    y0: torch.Tensor    # (T, n, n) y_ij^t, zero where not observed
    offd: torch.Tensor  # (T, n, n) off-diagonal x observation gate
    n_obs: torch.Tensor  # scalar, max(sum offd, 1)


def family_inputs(Y: torch.Tensor, mask=None) -> FamilyInputs:
    """Observations and gate of ``Y`` (the (n, n, T, 2) reciprocal layout,
    component 0 read) in the engines' (T, n, n) layout; ``mask`` (n, n, T)
    gates the observed dyads.  Unobserved entries are replaced by 0 with
    ``where``, so NaN-coded ones are never read.  A sharded ``Y`` raises
    ``TypeError``: the sharded engines build each rank's gate
    themselves."""
    if cavi.is_sharded(Y):
        raise TypeError(
            "family_inputs takes the whole network; a sharded Y goes to "
            "the sharded engines, tame_torch.parallel.sharded_family "
            "(fit_cavi_bernoulli, fit_cavi_poisson and fit_smoothed_family "
            "send it there)")
    n, _, T, _ = Y.shape
    offd = dyad_ops.offdiag_mask(n, Y.dtype, Y.device)[None].expand(T, n, n)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=Y.dtype, device=Y.device)
        offd = offd * mask.permute(2, 0, 1)
    offd = offd.contiguous()
    y0 = torch.where(offd > 0, Y[..., 0].permute(2, 0, 1),
                     torch.zeros((), dtype=Y.dtype, device=Y.device))
    return FamilyInputs(y0=y0.contiguous(), offd=offd,
                        n_obs=torch.clamp(offd.sum(), min=1.0))


def public_layout(x: torch.Tensor) -> torch.Tensor:
    """The engines' (T, n, n) layout -> the public (n, n, T) one (a
    view)."""
    return x.permute(1, 2, 0)


def solve_direct(P: torch.Tensor, eta: torch.Tensor):
    """``mu = P^-1 eta`` by the direct Cholesky solve and ``cov = P^-1``
    symmetrised with a RELATIVE jitter, ``1e-6 |mean diag|`` per block.

    The Gaussian engines' ``_solve_full`` takes the mean through the
    covariance with an absolute 1e-6 jitter (the reference's order); for
    the weighted engines, whose heavy-count Poisson dyads give precisions
    ~1e5 and covariances ~1e-5, that jitter would move the mean by ~10 %
    and can turn the ascent direction into descent (see the JAX
    function).  One call: K1 over every (node, time) system on the card."""
    mu, cov_raw = batched_spd_solve_inv(P, eta)
    cov = 0.5 * (cov_raw + cov_raw.transpose(-1, -2))
    scale = torch.diagonal(cov, dim1=-2, dim2=-1).mean(-1)[..., None, None]
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    return mu, cov + 1e-6 * scale.abs() * eye


def _lam(xi: torch.Tensor) -> torch.Tensor:
    """Jaakkola-Jordan lambda(xi) = tanh(xi/2)/(4 xi), lambda(0) = 1/8."""
    safe = torch.clamp(xi.abs(), min=1e-6)
    return torch.tanh(safe / 2.0) / (4.0 * safe)


def _panel_t(*cols: torch.Tensor) -> torch.Tensor:
    """Concatenate (n, T, k) feature columns into a time-major (T, n, K)
    panel."""
    return torch.cat(cols, -1).transpose(0, 1)


def _predictor_moments(state, r: int, senders=None):
    """Plug-in predictor ``m[t, i, j] = a_i + b_j + U_i . V_j`` and its
    posterior variance under the mean-field factors, both (T, n, n): the
    exact bilinear formula including ``tr(C_i Cr_j)``,

        var = A_i + Ar_j + 2 B_i . V_j + V_j' C_i V_j + 2 Br_j . U_i
              + U_i' Cr_j U_i + tr(C_i Cr_j),

    as one (2 + 2r + 3r^2)-column ``bmm`` per t (and one of 2 + r columns
    for ``m``).  ``senders`` (default ``state``) holds the factors of the
    rows i, (T, m, n) out: a rank's rows under a mesh."""
    mu, S = state.X_mean, state.X_cov
    n, T, _ = mu.shape
    src = state if senders is None else senders
    mi, Si = src.X_mean, src.X_cov
    m_rows = mi.shape[0]
    a, _, U, _ = dyad_ops.split_state(mi, r)
    _, b, _, V = dyad_ops.split_state(mu, r)
    one = mu.new_ones(n, T, 1)
    one_i = mi.new_ones(m_rows, T, 1)
    m = torch.bmm(_panel_t(a[..., None], one_i, U),
                  _panel_t(one, b[..., None], V).transpose(1, 2))
    rr = r * r
    C = Si[..., 2:2 + r, 2:2 + r]
    Cr = S[..., 2 + r:, 2 + r:]
    left = _panel_t(Si[..., 0, 0, None], one_i, 2.0 * Si[..., 0, 2:2 + r],
                    C.reshape(m_rows, T, rr), U,
                    cavi._outer(U, U).reshape(m_rows, T, rr),
                    C.reshape(m_rows, T, rr))
    right = _panel_t(one, S[..., 1, 1, None], V,
                     cavi._outer(V, V).reshape(n, T, rr),
                     2.0 * S[..., 1, 2 + r:], Cr.reshape(n, T, rr),
                     Cr.transpose(-1, -2).reshape(n, T, rr))
    var = torch.bmm(left, right.transpose(1, 2))
    return m, var


def _contract(L: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """``sum_j L[t, i, j] Z[j, t, :]``: (T, n, n) x (n, T, K) -> (n, T, K),
    one ``bmm`` (pass ``L.transpose(1, 2)`` for the receiver side)."""
    return torch.bmm(L, Z.transpose(0, 1)).transpose(0, 1)


def weighted_obs_terms(mu: torch.Tensor, r: int, w: torch.Tensor,
                       s: torch.Tensor, cov: Optional[torch.Tensor] = None,
                       rows=slice(None), reduce=None):
    """Observation precision (n, T, d, d) and natural parameter (n, T, d)
    of a quadratic pseudo-likelihood over directed dyads: each dyad
    contributes ``s_ij m_ij - (w_ij / 2) E[m_ij^2]``, with ``w`` and ``s``
    time-major (T, n, n) and pre-gated.

    * P: sender-side contractions of ``w`` against ``[1 | V_j | V_j V_j']``
      fill the [a, U] blocks, receiver-side ones of ``w'`` against
      ``[1 | U_i | U_i U_i']`` the [b, V] blocks;
    * eta: ``s`` minus the partner-offset pull (``w b_j`` sender side,
      ``w a_i`` receiver side), contracted against the partner factors.

    ``cov`` (the (n, T, d, d) covariances) adds the second-order terms
    ``P[UU] += sum_j w_ij Cov_j[VV]`` and ``eta[U] -= sum_j w_ij Cov_j[b,
    V]`` (and the receiver-side mirror), the exact derivatives of the
    expected likelihood through the partner covariances; without them the
    update can be a descent direction on heavy-count data.  Prior terms
    are the caller's.  The blocks are written into a preallocated P by
    slicing, as the JAX function's ``.at[].set``.

    Under a mesh ``w`` and ``s`` hold only the sender rows ``mu[rows]``
    (T, m, n): the receiver-side contractions then sum over this rank's
    senders only, and ``reduce`` (an all-reduce over the ``nodes`` ranks)
    completes them before the rows' own are taken."""
    n, T, d = mu.shape
    a, b, U, V = dyad_ops.split_state(mu, r)
    rr = r * r
    one = mu.new_ones(n, T, 1)
    VV = cavi._outer(V, V).reshape(n, T, rr)
    UU = cavi._outer(U, U).reshape(n, T, rr)
    if cov is not None:
        Zs = torch.cat([one, V, VV + cov[..., 2 + r:, 2 + r:].reshape(
            n, T, rr), cov[..., 1, 2 + r:]], -1)
        Zr = torch.cat([one, U, UU + cov[..., 2:2 + r, 2:2 + r].reshape(
            n, T, rr), cov[..., 0, 2:2 + r]], -1)
    else:
        Zs = torch.cat([one, V, VV], -1)
        Zr = torch.cat([one, U, UU], -1)
    Cs = _contract(w, Zs)
    Cr = _contract(w.transpose(1, 2), Zr[rows])
    if reduce is not None:
        Cr = reduce(Cr)
    Cr = Cr[rows]

    m = Cs.shape[0]
    P = mu.new_zeros(m, T, d, d)
    P[..., 0, 0] = Cs[..., 0]
    P[..., 1, 1] = Cr[..., 0]
    P[..., 0, 2:2 + r] = P[..., 2:2 + r, 0] = Cs[..., 1:1 + r]
    P[..., 1, 2 + r:] = P[..., 2 + r:, 1] = Cr[..., 1:1 + r]
    P[..., 2:2 + r, 2:2 + r] = Cs[..., 1 + r:1 + r + rr].reshape(m, T, r, r)
    P[..., 2 + r:, 2 + r:] = Cr[..., 1 + r:1 + r + rr].reshape(m, T, r, r)

    S_ = s - w * b.T[:, None, :]        # s_ij - w_ij b_j
    W_ = s - w * a[rows].T[:, :, None]  # s_ij - w_ij a_i
    Es = _contract(S_, torch.cat([one, V], -1))
    Er = _contract(W_.transpose(1, 2), torch.cat([one, U], -1)[rows])
    if reduce is not None:
        Er = reduce(Er)
    Er = Er[rows]
    eta_U, eta_V = Es[..., 1:], Er[..., 1:]
    if cov is not None:
        eta_U = eta_U - Cs[..., 1 + r + rr:]
        eta_V = eta_V - Cr[..., 1 + r + rr:]
    eta = torch.cat([Es[..., :1], Er[..., :1], eta_U, eta_V], -1)
    return P, eta


def damped(new: torch.Tensor, old: torch.Tensor, lr: float) -> torch.Tensor:
    """``lr new + (1 - lr) old`` with ``1 - lr`` taken in float32, as the
    JAX loops take it from a float32 ``lr``."""
    lr32 = np.float32(lr)
    return float(lr32) * new + float(np.float32(1.0) - lr32) * old


def bernoulli_step(state: cavi.CaviState, y0: torch.Tensor,
                   offd: torch.Tensor, pri: cavi.PriorMatrices,
                   params: AMEParams, lr: float, n_obs=None):
    """One simultaneous (Jacobi) JJ-bound coordinate update.

    ``y0``: (T, n, n) binary ties (``y0[t, i, j]`` = tie i -> j), zero at
    the diagonal and at masked entries; ``offd`` the gate.  Returns
    ``(new_state, bound, accuracy)``, the bound and the plug-in accuracy at
    the INCOMING state (by-products of the update's moments), as 0-d
    tensors."""
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    m, var = _predictor_moments(state, r)
    Em2 = m * m + var
    xi = torch.sqrt(torch.clamp(Em2, min=1e-12))
    lam = _lam(xi) * offd
    resid = (y0 - 0.5) * offd
    bound = torch.sum(offd * (resid * m - lam * Em2 + xi / 2.0
                              - softplus(xi) + lam * xi * xi))
    prior0, priort = cavi.state_prior_terms(params, pri, state)
    bound = bound + prior0 + priort + cavi.gaussian_entropy(state)
    if n_obs is None:
        n_obs = torch.clamp(offd.sum(), min=1.0)
    acc = torch.sum(offd * ((m > 0) == (y0 > 0.5))) / n_obs

    P, eta = weighted_obs_terms(state.X_mean, r, 2.0 * lam, resid,
                                cov=state.X_cov)
    P = P + cavi._prior_precision(pri, T)[None]
    eta = eta + cavi._prior_nat_param(pri, state.X_mean)
    mu_new, cov_new = solve_direct(P, eta)
    return (cavi.CaviState(X_mean=damped(mu_new, state.X_mean, lr),
                           X_cov=damped(cov_new, state.X_cov, lr)),
            bound, acc)


def fit_cavi_bernoulli(Y: torch.Tensor, params: AMEParams,
                       init: cavi.CaviState, *, max_iter: int = 200,
                       learning_rate=0.8, tolerance=1e-5, patience: int = 3,
                       carry_elbo=None, carry_patience: int = 0,
                       mask=None) -> BernoulliFitResult:
    """Fit the JJ-bound CAVI to a binary network (the JAX
    ``fit_cavi_bernoulli`` contract): tolerance x patience stopping on the
    bound, ``diverged`` once it goes non-finite.

    ``Y``: the (n, n, T, 2) reciprocal layout (component 0, the ordered
    adjacency, is read); ``mask``: optional (n, n, T) observation gate
    (hidden dyads are never read).  ``carry_elbo``/``carry_patience`` seed
    the stopping rule from a previous segment's ``last_elbo``/``pat_count``,
    so a fit run in segments stops where the uninterrupted one does.
    Inputs from :func:`tame_torch.parallel.shard_fit_inputs` run the fit
    sharded over the mesh (:mod:`tame_torch.parallel.sharded_family`)."""
    if cavi._sharded(Y, init):
        from tame_torch.parallel.sharded_family import fit_bernoulli_sharded

        return fit_bernoulli_sharded(
            Y, params, init, max_iter=max_iter, learning_rate=learning_rate,
            tolerance=tolerance, patience=patience, carry_elbo=carry_elbo,
            carry_patience=carry_patience, mask=mask)
    fi = family_inputs(Y, mask)
    params = params.to(Y.device, Y.dtype)
    pri = cavi.precompute_priors(params)
    buf = cavi.history_buffer(max_iter)
    eh = np.full(buf, np.nan, np.float32)
    ah = np.full(buf, np.nan, np.float32)
    rule = cavi._StopRule(carry_elbo, carry_patience, tolerance, patience)
    state = init
    it = 0
    while it < max_iter and rule.running:
        state, bound, acc = bernoulli_step(state, fi.y0, fi.offd, pri,
                                           params, learning_rate, fi.n_obs)
        eh[it], ah[it] = torch.stack([bound, acc]).tolist()
        rule.update(float(eh[it]))
        it += 1
    return BernoulliFitResult(
        X_mean=state.X_mean, X_cov=state.X_cov,
        elbo_history=torch.from_numpy(eh),
        accuracy_history=torch.from_numpy(ah), n_iter=it,
        converged=rule.converged, diverged=rule.diverged,
        last_elbo=float(rule.prev), pat_count=rule.pat)


def forecast_predictor(X_mean: torch.Tensor, params: AMEParams, r: int,
                       n_steps: int) -> torch.Tensor:
    """Plug-in predictor (n, n, n_steps) of the AR(1)-propagated means."""
    Xf = forecast_means(X_mean[:, -1], params.Phi, n_steps)
    return dyad_ops.dyadic_fwd_temporal(Xf, r)


class MeanFieldFamilyVI(torch.nn.Module):
    """What the Bernoulli and Poisson engines share: the model's data on
    its device, the (node, time) mean-field state as buffers ``X_mean`` /
    ``X_cov``, the warm or random init, segmented fits with asynchronous
    checkpoints and a bit-for-bit resume, and the AR(1) forecast.

    A subclass sets ``structure``, ``history_keys`` and ``warm_transform``
    and implements ``_run_segment`` and the carry's save and restore."""

    structure = ""
    history_keys: tuple  # the two history series, the objective first

    @staticmethod
    def warm_transform(Y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __init__(self, model, learning_rate: float, init_scale: float,
                 seed: int, init_mode: str, mask):
        super().__init__()
        if model.Y is None:
            raise ValueError(
                "Model has no data. Call model.generate_data() first.")
        self.model = model
        self.Y = torch.as_tensor(model.Y)
        self.n, self.T, self.d, self.r = model.n, model.T, model.d, model.r
        self.lr = learning_rate
        self.seed = seed
        self.mask = (None if mask is None else torch.as_tensor(
            mask, dtype=self.Y.dtype, device=self.Y.device))
        self.params = model.params.to(self.Y.device, self.Y.dtype)
        self.history = {k: [] for k in self.history_keys}
        self._converged = self._diverged = False
        self._reset_carry()
        if init_mode == "warm":
            # link linearization: pseudo-Gaussian observations of the
            # predictor, then the Gaussian closed-form warm start (its
            # subspace probe from a CPU generator seeded 0, as the JAX
            # engines use PRNGKey(0))
            st = cavi.warm_init_state(self.warm_transform(self.Y),
                                      self.params, structure="full",
                                      obs_mask=self.mask)
        elif init_mode == "random":
            st = cavi.init_state(torch.Generator().manual_seed(seed), self.n,
                                 self.T, self.d, "full", init_scale, 0.5,
                                 device=self.Y.device)
        else:
            raise ValueError(f"unknown init_mode '{init_mode}'")
        self.register_buffer("X_mean", st.X_mean)
        self.register_buffer("X_cov", st.X_cov)

    def _state(self) -> cavi.CaviState:
        return cavi.CaviState(X_mean=self.X_mean, X_cov=self.X_cov)

    def fit(self, max_iter: int = 200, tolerance: float = 1e-5,
            verbose: bool = True, check_every: int = 10,
            checkpoint_every=None, ckpt_dir=None, resume: bool = False):
        """Run the fit to convergence from the current state; the history
        grows by the iterations run.  ``checkpoint_every``/``ckpt_dir``/
        ``resume`` as in the Gaussian engines: segments with the carry
        threaded through, an asynchronous checkpoint after each, and a
        resume (``max_iter`` the total budget) that reproduces the
        uninterrupted fit bit for bit."""
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
            self._reset_carry()
            self._converged = self._diverged = False
        ckptr = None
        if checkpoint_every and ckpt_dir is not None:
            from tame_torch.io.async_ckpt import AsyncCheckpointer

            ckptr = AsyncCheckpointer()
        k0, k1 = self.history_keys
        while budget > 0 and not (self._converged or self._diverged):
            k, h0, h1 = self._run_segment(min(segment, budget), tolerance)
            self.history[k0].extend(h0)
            self.history[k1].extend(h1)
            budget -= k
            if checkpoint_every:
                if ckptr is not None:
                    ckptr.save(ckpt_dir, self._checkpoint_state())
                if verbose and k:
                    print(f"Iter {len(self.history[k0]) - 1:4d} | {k0}: "
                          f"{h0[-1]:10.2f} | {k1}: {h1[-1]:.4f}"
                          + (" | checkpointed" if ckpt_dir else ""),
                          flush=True)
        if ckptr is not None:
            ckptr.wait()
        if verbose and not checkpoint_every:
            h0, h1 = self.history[k0], self.history[k1]
            for it in range(done, len(h0)):
                if (it - done) % check_every == 0 or it == len(h0) - 1:
                    print(f"Iter {it:4d} | {k0}: {h0[it]:10.2f} | {k1}: "
                          f"{h1[it]:.4f}")
        return self.history

    def _checkpoint_state(self) -> dict:
        """The fit state in the JAX engine's checkpoint layout."""
        state = {
            "X_mean": self.X_mean,
            "X_cov": self.X_cov,
            "history": {k: np.asarray(v) for k, v in self.history.items()},
            "structure": self.structure,
            "learning_rate": self.lr,
            "seed": self.seed,
            "converged": bool(self._converged),
            "diverged": bool(self._diverged),
        }
        state.update(self._carry_state())
        return state

    def save_checkpoint(self, ckpt_dir) -> None:
        """Checkpoint the fit state (variational parameters, history,
        carry) for a restart."""
        from tame_torch.io import save_checkpoint

        save_checkpoint(ckpt_dir, self._checkpoint_state())

    def load_checkpoint(self, ckpt_dir) -> None:
        """Restore a checkpoint written by :meth:`save_checkpoint` or by
        the JAX engine onto the device of ``Y``; a later ``fit`` continues
        from it."""
        from tame_torch.io import load_checkpoint

        state = load_checkpoint(ckpt_dir)
        if state.get("structure", self.structure) != self.structure:
            raise ValueError(
                f"checkpoint structure '{state.get('structure')}' is not "
                f"'{self.structure}'")
        self.X_mean = torch.as_tensor(state["X_mean"], device=self.Y.device)
        self.X_cov = torch.as_tensor(state["X_cov"], device=self.Y.device)
        self.history = {k: np.asarray(state["history"][k]).tolist()
                        for k in self.history_keys}
        self._restore_carry(state)
        self._converged = bool(state.get("converged", False))
        self._diverged = bool(state.get("diverged", False))

    def predict_forward(self, n_steps: int = 1) -> torch.Tensor:
        """AR(1) forward forecast of the latent means (n, n_steps, d) from
        the last fitted time step."""
        return forecast_means(self.X_mean[:, -1], self.params.Phi, n_steps)

    def get_variational_means(self) -> torch.Tensor:
        return self.X_mean

    def get_variational_covariances(self) -> torch.Tensor:
        return self.X_cov


class TemporalAMEBernoulliVI(MeanFieldFamilyVI):
    """Engine for binary dynamic networks (JJ-bound CAVI), an
    ``nn.Module`` whose buffers are the variational state on the device of
    the model's ``Y`` (binary data in the reciprocal layout, e.g. from
    ``sample_observations(..., family="bernoulli")``).

    ``init_mode="random"`` (seeded ``seed``) or ``"warm"`` (the logit
    linearization ``4 (y - 1/2)`` through the Gaussian warm start);
    ``mask`` goes to the warm init and every fit.  The JJ weights are
    bounded (lam <= 1/8), so the simultaneous update with the default lr
    0.8 is stable without a guard; a fit that rings wants a lower lr or
    the smoothed binary family, whose loop backs off."""

    structure = "bernoulli"
    history_keys = ("elbo", "accuracy")

    @staticmethod
    def warm_transform(Y):
        return 4.0 * (Y - 0.5)

    def __init__(self, model, learning_rate: float = 0.8,
                 init_scale: float = 0.1, seed: int = 42,
                 init_mode: str = "random", mask=None):
        super().__init__(model, learning_rate, init_scale, seed, init_mode,
                         mask)

    def _reset_carry(self) -> None:
        self._carry_elbo: Optional[float] = None
        self._carry_pat = 0

    def _run_segment(self, max_iter: int, tolerance: float):
        out = fit_cavi_bernoulli(
            self.Y, self.params, self._state(), max_iter=max_iter,
            learning_rate=self.lr, tolerance=tolerance, mask=self.mask,
            carry_elbo=self._carry_elbo, carry_patience=self._carry_pat)
        self.X_mean, self.X_cov = out.X_mean, out.X_cov
        self._converged, self._diverged = out.converged, out.diverged
        self._carry_elbo, self._carry_pat = out.last_elbo, out.pat_count
        k = out.n_iter
        return (k, out.elbo_history[:k].tolist(),
                out.accuracy_history[:k].tolist())

    def _carry_state(self) -> dict:
        return {"carry_elbo": self._carry_elbo,
                "carry_pat": self._carry_pat}

    def _restore_carry(self, state: dict) -> None:
        self._carry_elbo = state.get("carry_elbo")
        self._carry_pat = int(state.get("carry_pat", 0))

    def predict_proba(self) -> torch.Tensor:
        """Posterior plug-in tie probabilities (n, n, T)."""
        return torch.sigmoid(dyad_ops.dyadic_fwd_temporal(self.X_mean,
                                                          self.r))

    def predict_proba_forward(self, n_steps: int = 1) -> torch.Tensor:
        """Forecast tie probabilities (n, n, n_steps): the sigmoid of the
        AR(1)-propagated plug-in predictor."""
        return torch.sigmoid(forecast_predictor(self.X_mean, self.params,
                                                self.r, n_steps))
