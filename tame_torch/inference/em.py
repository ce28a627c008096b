"""Hyperparameter learning: variational EM for the temporal AME family,
Gaussian dyads, complete or masked networks (counterpart of
:mod:`tame.inference.em`).

* **E-step** — the smoothed (joint-trajectory) engine
  (:func:`tame_torch.inference.smoothed.fit_cavi_smoothed`): its per-node
  posteriors carry exact marginal covariances and lag-1 cross-covariances,
  the sufficient statistics the M-step needs.
* **M-step** — closed forms:

  - ``phi`` (dimension groups sharing one AR rate, see :func:`_phi_groups`):
    the maximizer of the expected transition log-likelihood under the
    current Q, a ``g x g`` linear solve;
  - ``Q``: ``(1/n(T-1)) [Sxx - Phi A' - A Phi' + Phi B Phi']``;
  - ``Sigma0``: ``(1/n) sum_i E[x_0 x_0']``;
  - ``R``: exchangeable 2x2 from the dyadic residual second moments,
    including the exact posterior-variance corrections.

Every M-step quantity is a reduction over the E-step's posteriors, O(n T d^2)
besides one O(n^2 T) residual pass (and, under a mask, one mask
contraction).  Non-Gaussian families (``family="bernoulli"``/``"poisson"``
or any object with a ``vi_surrogate``) take their E-step from
:func:`tame_torch.inference.family_smoothed.fit_smoothed_family`, the same
joint-trajectory posteriors; the R M-step, Gaussian-specific, is dropped
for them.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from tame_torch.inference import cavi
from tame_torch.inference.family_smoothed import (
    fit_smoothed_family,
    warm_init_smoothed_family,
)
from tame_torch.inference.smoothed import (
    SmoothedState,
    fit_cavi_smoothed,
    init_smoothed_state,
    warm_init_smoothed_state,
)
from tame_torch.models.params import AMEParams
from tame_torch.ops import dyad as dyad_ops

LEARNABLE = ("phi", "Q", "Sigma0", "R")


class EMResult(NamedTuple):
    params: AMEParams
    state: SmoothedState
    history: Dict[str, List[float]]


def _sym(M: torch.Tensor, jitter: float = 1e-8) -> torch.Tensor:
    return 0.5 * (M + M.T) + jitter * torch.eye(M.shape[0], dtype=M.dtype,
                                                device=M.device)


def _transition_moments(state: SmoothedState
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Summed second moments over nodes and transitions ``(A, B, Sxx,
    S00)``: ``A = sum E[x_{t+1} x_t']`` (lag-1), ``B = sum E[x_t x_t']``
    (t = 0..T-2), ``Sxx = sum E[x_{t+1} x_{t+1}']`` (t = 1..T-1), ``S00 =
    sum_i E[x_0 x_0']``.  ``X_cross[t] = Cov(x_t, x_{t+1})``, so
    ``E[x_{t+1} x_t'] = mu_{t+1} mu_t' + X_cross[t]'``."""
    mu, S, C = state.X_mean, state.X_cov, state.X_cross
    A = (torch.einsum("ita,itb->ab", mu[:, 1:], mu[:, :-1])
         + C.sum((0, 1)).T)
    B = (torch.einsum("ita,itb->ab", mu[:, :-1], mu[:, :-1])
         + S[:, :-1].sum((0, 1)))
    Sxx = (torch.einsum("ita,itb->ab", mu[:, 1:], mu[:, 1:])
           + S[:, 1:].sum((0, 1)))
    S00 = (torch.einsum("ia,ib->ab", mu[:, 0], mu[:, 0])
           + S[:, 0].sum(0))
    return A, B, Sxx, S00


def _residual_moments(Y: torch.Tensor, X_mean: torch.Tensor, mask=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plug-in dyadic residual statistics over observed ordered pairs
    (``i != j`` without a mask): ``(sum e^2, sum e_ij e_ji, count)``.
    Masked entries of ``Y`` are never read (``where``, not a product)."""
    n, _, T, _ = Y.shape
    r = (X_mean.shape[-1] - 2) // 2
    fwd = dyad_ops.dyadic_fwd_temporal(X_mean, r)
    if mask is None:
        sq, cross = dyad_ops.residual_stats_from_fwd(Y, fwd)
        return sq, cross, Y.new_tensor(float(n * (n - 1) * T))
    e0 = torch.where(mask > 0, Y[..., 0] - fwd,
                     torch.zeros((), dtype=Y.dtype, device=Y.device))
    return (torch.sum(e0 * e0), torch.sum(e0 * e0.transpose(0, 1)),
            torch.sum(mask))


def _pair_sum(Xi: torch.Tensor, Zj: torch.Tensor) -> torch.Tensor:
    """``sum_{i != j, t, k} Xi[i, t, k] Zj[j, t, k]``: the JAX module's
    ``einsum("ijt,itk,jtk->", m, Xi, Zj)`` with ``m`` the off-diagonal
    mask, in O(n T k) rather than O(n^2 T k)."""
    return torch.sum(Xi.sum(0) * Zj.sum(0)) - torch.sum(Xi * Zj)


_PARTNERS = ("V", "U", "VV", "UU", "Cr", "VU", "SUVt")


def _flat(M: torch.Tensor) -> torch.Tensor:
    """(n, T, r, r) -> (n, T, r^2)."""
    return M.reshape(M.shape[:2] + (-1,))


def _mean_panels(mu: torch.Tensor, r: int) -> Dict[str, torch.Tensor]:
    """The partner panels of the pair sums that read the means."""
    _, _, U, V = dyad_ops.split_state(mu, r)
    return {"V": V, "U": U,
            "VV": _flat(V[..., :, None] * V[..., None, :]),
            "UU": _flat(U[..., :, None] * U[..., None, :]),
            "VU": _flat(V[..., :, None] * U[..., None, :])}


def _cov_panels(S: torch.Tensor, r: int) -> Dict[str, torch.Tensor]:
    """The partner panels of the pair sums that read the covariances."""
    return {"Cr": _flat(S[..., 2 + r:, 2 + r:]),
            "SUVt": _flat(S[..., 2:2 + r, 2 + r:].transpose(-1, -2))}


def _own_panels(S: torch.Tensor, r: int) -> Dict[str, torch.Tensor]:
    """The node-side panels ``x_i`` of the pair sums, from the
    covariances of the nodes i."""
    C = _flat(S[..., 2:2 + r, 2:2 + r])
    return {"S0U": S[..., 0, 2:2 + r], "C": C, "S1V": S[..., 1, 2 + r:],
            "Cr": _flat(S[..., 2 + r:, 2 + r:]), "S0V": S[..., 0, 2 + r:],
            "SU1": S[..., 2:2 + r, 1], "SUV": _flat(S[..., 2:2 + r, 2 + r:])}


def _correction_sums(S: torch.Tensor, cnt, pair
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum var_q, sum cov_q)`` over the nodes i of ``S`` (their
    covariances): ``cnt`` counts each node's partners and ``pair(x, z)``
    is the pair sum of its own panel ``x`` (:func:`_own_panels`) against
    the partner panel ``z``."""
    var_sum = (torch.sum(cnt * (S[..., 0, 0] + S[..., 1, 1]))
               + 2.0 * pair("S0U", "V") + pair("C", "VV")
               + 2.0 * pair("S1V", "U") + pair("Cr", "UU")
               + pair("C", "Cr"))
    cross_sum = (2.0 * (torch.sum(cnt * S[..., 0, 1]) + pair("S0V", "U")
                        + pair("SU1", "V") + pair("SUV", "VU"))
                 + pair("SUV", "SUVt"))
    return var_sum, cross_sum


def _residual_moment_corrections(state: SmoothedState, m=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact posterior-variance corrections to the plug-in residual
    statistics over the ordered pairs of the (n, n, T) mask ``m`` (all
    pairs ``i != j`` when None), making the R M-step the true
    ``E_q[(y - mu(X))^2]`` (see the JAX function for the algebra):

        var_q(mu_ij)        = J_i S_i J_i' + J_j S_j J_j'
                              + tr(S_i[UU] S_j[VV])
        cov_q(mu_ij, mu_ji) = K_i + K_j + tr(S_i[UV] S_j[UV])

    Each pair sum ``sum_ij m_ij x_i . z_j`` is ``sum_i x_i . (m z)_i``:
    one mask contraction of every partner panel at once (O(n^2 T k)
    multiply-adds, no (n, n, T, k) intermediate), or, for the
    off-diagonal mask, :func:`_pair_sum`.  ``m`` must be symmetric.
    Returns ``(sum var_q, sum cov_q)``."""
    mu, S = state.X_mean, state.X_cov
    n, T, d = mu.shape
    r = (d - 2) // 2
    panels = {**_mean_panels(mu, r), **_cov_panels(S, r)}
    partners = {k: panels[k] for k in _PARTNERS}
    own = _own_panels(S, r)
    if m is None:
        cnt = float(n - 1)

        def pair(x, key):
            return _pair_sum(own[x], partners[key])
    else:
        cnt = m.sum(1)                       # m symmetric: col sums = cnt
        pair = _masked_pair(m, partners, own)
    return _correction_sums(S, cnt, pair)


def _masked_pair(m, partners: Dict[str, torch.Tensor],
                 own: Dict[str, torch.Tensor]):
    """The pair sums ``sum_i x_i . (m z)_i`` of the mask rows ``m`` (m, n,
    T) against every partner panel, contracted at once."""
    Mz = dict(zip(partners, cavi._mask_contract(
        m, torch.cat(list(partners.values()), -1)).split(
            [z.shape[-1] for z in partners.values()], -1)))

    def pair(x, key):
        return torch.sum(own[x] * Mz[key])
    return pair


def _phi_groups(phi_structure: str, d: int):
    """Dimension groups sharing one AR rate: ``"scalar"`` (``Phi = phi
    I``), ``"blocks"`` ([a, b] and [U, V]) or ``"diag"`` (one rate per
    dimension)."""
    if phi_structure == "scalar":
        return [list(range(d))]
    if phi_structure == "blocks":
        return [[0, 1], list(range(2, d))]
    if phi_structure == "diag":
        return [[k] for k in range(d)]
    raise ValueError(f"unknown phi_structure {phi_structure!r}; choose "
                     "from 'scalar', 'blocks', 'diag'")


def em_update_params(params: AMEParams, Y: torch.Tensor,
                     state: SmoothedState, *,
                     learn: Sequence[str] = LEARNABLE, mask=None,
                     phi_structure: str = "scalar",
                     r_structure: str = "exchangeable") -> AMEParams:
    """One closed-form M-step; fields not in ``learn`` keep their values
    and ``Sigma``/``Psi`` report the blocks of the learned ``Sigma0``.
    ``mask`` ((n, n, T), symmetric) restricts the R statistics to
    observed dyads.

    The group rates of ``phi_structure`` solve, under the current Q,

        sum_h phi_h sum_{k in g, l in h} Q^-1[k,l] B[l,k]
            = sum_{k in g} (Q^-1 A)[k,k].

    ``r_structure``: ``"exchangeable"`` learns (sigma^2, rho);
    ``"diag"`` pins rho at zero.

    A sharded ``Y`` and ``state`` (:func:`tame_torch.parallel.
    shard_smoothed_inputs`, a sharded fit's ``field("state")``; ``mask``
    the whole mask) sum every moment over the mesh's ranks
    (:func:`tame_torch.parallel.sharded_em.em_moments`); the solves run on
    the summed moments, so the parameters come out the same on every
    rank.
    """
    _check_m_step(learn, r_structure)
    if cavi._sharded(Y, state):
        from tame_torch.parallel.sharded_em import em_moments

        n, T, d, moments, resid = em_moments(Y, state, mask, "R" in learn)
        params = params.to(Y.mesh.device)
    else:
        n, T, d = state.X_mean.shape
        moments, resid = _transition_moments(state), None
        if "R" in learn:
            resid = (*_residual_moments(Y, state.X_mean, mask),
                     *_residual_moment_corrections(state, mask))
    return m_step(params, n, T, d, moments, resid, learn=learn,
                  phi_structure=phi_structure, r_structure=r_structure)


def _check_m_step(learn, r_structure: str) -> None:
    unknown = set(learn) - set(LEARNABLE)
    if unknown:
        raise ValueError(f"unknown learnable(s) {sorted(unknown)}; "
                         f"choose from {LEARNABLE}")
    if r_structure not in ("exchangeable", "diag"):
        raise ValueError(f"unknown r_structure {r_structure!r}; choose "
                         "from 'exchangeable', 'diag'")


def m_step(params: AMEParams, n: int, T: int, d: int, moments, resid, *,
           learn: Sequence[str], phi_structure: str,
           r_structure: str) -> AMEParams:
    """The closed forms of :func:`em_update_params` from the summed
    moments: the transition moments ``(A, B, Sxx, S00)`` and, when R is
    learned, the residual statistics and their corrections ``(sq, cross,
    count, var_corr, cross_corr)``, over ``n`` nodes and ``T`` steps."""
    A, B, Sxx, S00 = moments
    Phi, Q, Sigma0 = params.Phi, params.Q, params.Sigma0
    if "phi" in learn and T > 1:
        groups = _phi_groups(phi_structure, d)
        Q_inv = torch.linalg.inv(Q)
        Z = A.new_zeros((d, len(groups)))
        for g, dims in enumerate(groups):
            Z[dims, g] = 1.0
        M = Q_inv * B.T                       # M[k,l] = Q^-1[k,l] B[l,k]
        G = Z.T @ M @ Z + 1e-12 * torch.eye(len(groups), dtype=A.dtype,
                                            device=A.device)
        c = Z.T @ torch.diagonal(Q_inv @ A)
        Phi = torch.diag(Z @ torch.linalg.solve(G, c))
    if "Q" in learn and T > 1:
        Qn = (Sxx - Phi @ A.T - A @ Phi.T + Phi @ B @ Phi.T) / (n * (T - 1))
        Q = _sym(Qn, 1e-6)
    if "Sigma0" in learn:
        Sigma0 = _sym(S00 / n, 1e-6)
    R, R_inv = params.R, params.R_inv
    if "R" in learn:
        sq, cross, count, var_corr, cross_corr = resid
        sigma2 = torch.clamp((sq + var_corr) / count, min=1e-8)
        if r_structure == "diag":
            rho = torch.zeros_like(sigma2)
        else:
            rho = torch.clamp((cross + cross_corr) / count / sigma2,
                              -0.99, 0.99)
        off = rho * sigma2
        R = torch.stack([torch.stack([sigma2, off]),
                         torch.stack([off, sigma2])])
        R_inv = torch.linalg.inv(R)
    return AMEParams(Sigma=Sigma0[:2, :2], Psi=Sigma0[2:, 2:], R=R,
                     R_inv=R_inv, Phi=Phi, Q=Q, Sigma0=Sigma0)


def fit_em(Y: torch.Tensor, params0: AMEParams, *,
           n_em: int = 15,
           inner_max_iter: int = 100,
           inner_tolerance: float = 1e-6,
           learning_rate: float = 0.5,
           learn: Sequence[str] = LEARNABLE,
           family: str = "gaussian",
           phi_structure: str = "scalar",
           r_structure: str = "exchangeable",
           mixed_precision: bool = False,
           diag_mode: str = "exact",
           mask=None,
           init=None,
           init_mode: str = "warm",
           seed: int = 0,
           em_tolerance: float = 1e-4,
           verbose: bool = False) -> EMResult:
    """Variational EM: alternate smoothed E-steps with closed-form M-steps
    until every learned scalar summary (phi, tr Q, tr Sigma0, sigma^2,
    rho) changes by less than ``em_tolerance`` (relative).

    The E-step warm-starts from the previous posterior; the first one from
    ``init``, else :func:`warm_init_smoothed_state` (``init_mode="warm"``,
    temporally coherent U/V frames, which the phi M-step needs) or a
    random init seeded ``seed``.  If an E-step diverges or its final ELBO
    regresses by more than ``max(1, 1e-4 |previous|)``, the damping is
    halved and that EM iteration retried (up to 3 times); if every retry
    diverges, EM stops with the last finite iterate.

    ``mask`` ((n, n, T), symmetric; its diagonal is zeroed) fits the
    observed dyads only, in the warm init, the E-steps and the M-step;
    ``mixed_precision``/``diag_mode`` go to the Gaussian E-steps.

    ``family``: ``"gaussian"`` (the smoothed CAVI E-step),
    ``"bernoulli"``/``"poisson"`` or a custom object with a
    ``vi_surrogate`` (the smoothed non-Gaussian E-step,
    :func:`~tame_torch.inference.family_smoothed.fit_smoothed_family`,
    warm-started by
    :func:`~tame_torch.inference.family_smoothed.warm_init_smoothed_family`).
    For those ``"R"`` is dropped from ``learn``: their dyadic noise is the
    likelihood itself.

    Returns :class:`EMResult`; ``history`` tracks ``elbo`` (final inner
    ELBO per EM iteration) and the learned scalars (``phi_mult``, the last
    latent dimension's rate, for non-scalar ``phi_structure``).

    ``Y`` from :func:`tame_torch.parallel.shard_smoothed_inputs` (a mesh
    over ``nodes``; ``mask`` the whole mask, ``init`` a sharded state)
    runs every step sharded: the warm init, the E-steps and the M-step's
    moments over the ranks' nodes, the parameters and every decision
    (backoff, stop) replicated.  ``state`` is then sharded too.
    """
    if isinstance(family, str):
        if family not in ("gaussian", "bernoulli", "poisson"):
            raise ValueError(f"unknown family {family!r}; choose from "
                             "('gaussian', 'bernoulli', 'poisson')")
    elif not hasattr(family, "vi_surrogate"):
        raise ValueError(
            "custom family must implement vi_surrogate to serve as an EM "
            "E-step")
    gaussian = isinstance(family, str) and family == "gaussian"
    if not gaussian:
        learn = tuple(k for k in learn if k != "R")
    sharded = cavi.is_sharded(Y)
    if sharded:
        n, T = Y.sizes["nodes"], Y.sizes["time"]
    else:
        n, _, T, _ = Y.shape
        if mask is not None:
            mask = cavi.gated_mask(mask, Y)
    params = params0
    if init is not None:
        state = init
    elif not gaussian and init_mode == "warm":
        state = warm_init_smoothed_family(Y, params0, family, obs_mask=mask)
    elif init_mode == "warm":
        state = warm_init_smoothed_state(Y, params0, obs_mask=mask)
    elif sharded:
        from tame_torch.parallel.mesh import place_smoothed_state

        state = place_smoothed_state(Y.mesh, init_smoothed_state(
            torch.Generator().manual_seed(seed), n, T, params0.d, 0.1),
            Y.sizes)
    else:
        state = init_smoothed_state(torch.Generator().manual_seed(seed), n,
                                    T, params0.d, 0.1, device=Y.device)

    def scalars(p: AMEParams) -> Dict[str, float]:
        vals = [p.Phi[0, 0], torch.trace(p.Q), torch.trace(p.Sigma0),
                p.R[0, 0], p.R[0, 1] / p.R[0, 0]]
        keys = ["phi", "trQ", "trSigma0", "sigma2", "rho"]
        if phi_structure != "scalar":
            vals.append(p.Phi[-1, -1])
            keys.append("phi_mult")
        return dict(zip(keys, torch.stack(vals).tolist()))

    history: Dict[str, List[float]] = {
        "elbo": [], "phi": [], "trQ": [], "trSigma0": [], "sigma2": [],
        "rho": []}
    if phi_structure != "scalar":
        history["phi_mult"] = []
    prev = scalars(params)
    prev_elbo = -np.inf
    for k in range(n_em):
        # Fresh damping each EM iteration: a backoff answers this
        # iteration's hyperparameters only.
        lr = learning_rate
        for attempt in range(4):
            if gaussian:
                out = fit_cavi_smoothed(Y, params, state,
                                        max_iter=inner_max_iter,
                                        learning_rate=lr,
                                        tolerance=inner_tolerance,
                                        corrected=True,
                                        mixed_precision=mixed_precision,
                                        diag_mode=diag_mode, mask=mask)
            else:
                out = fit_smoothed_family(Y, params, state, family=family,
                                          max_iter=inner_max_iter,
                                          learning_rate=lr,
                                          tolerance=inner_tolerance,
                                          mask=mask)
            e = float(out.elbo_history[out.n_iter - 1])
            # Relative regression threshold: near convergence the ELBO
            # moves at reduction-noise scale, which must not back off.
            slack = max(1.0, 1e-4 * abs(prev_elbo))
            if (not out.diverged and np.isfinite(e)
                    and (e >= prev_elbo - slack or attempt == 3)):
                break
            lr *= 0.5
            if verbose:
                print(f"EM {k:3d} | E-step regressed "
                      f"({e:.1f} < {prev_elbo:.1f}); retrying with "
                      f"lr={lr:.3f}", flush=True)
        if out.diverged or not np.isfinite(e):
            if not history["elbo"]:
                raise RuntimeError(
                    "fit_em: the first E-step diverged even after "
                    "damping backoff — check the starting "
                    "hyperparameters (params0) and learning_rate")
            if verbose:
                print(f"EM {k:3d} | E-step diverged after backoff; "
                      "stopping with the last finite iterate", flush=True)
            break
        prev_elbo = e
        state = out.field("state") if sharded else out.state
        params = em_update_params(params, Y, state, learn=learn, mask=mask,
                                  phi_structure=phi_structure,
                                  r_structure=r_structure)
        cur = scalars(params)
        history["elbo"].append(e)
        for key, v in cur.items():
            history[key].append(v)
        if verbose:
            print(f"EM {k:3d} | ELBO {e:10.2f} | "
                  + " ".join(f"{key}={v:.4f}" for key, v in cur.items()),
                  flush=True)
        rel = max(abs(cur[key] - prev[key]) / (abs(prev[key]) + 1e-8)
                  for key in cur)
        prev = cur
        if k > 0 and rel < em_tolerance:
            break
    return EMResult(params=params, state=state, history=history)
