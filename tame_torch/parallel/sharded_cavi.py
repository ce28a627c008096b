"""The Gaussian CAVI and smoothed fits sharded over a mesh's ``nodes`` and
``time`` ranks (the port's counterpart of GSPMD partitioning
:func:`tame.inference.cavi.fit_cavi` and ``fit_cavi_smoothed``).

Node i's update reads only row i of the dyad weights W0 and W1 (both
directions of each dyad sit in that row, ``W0 = p Y0 + q Y1``) and, from
the rest of the state, partner sums and Grams over all nodes, O(n T r^2).
So each rank keeps:

* its rows and time slice of W0 and W1 (placed by
  :func:`~tame_torch.parallel.mesh.shard_fit_inputs`; rows go to ranks
  cyclically), of the observation mask (placed by
  :func:`~tame_torch.parallel.mesh.place_mask`) and of the covariances;
* every node's means, replicated.  The partner statistics, the prior's
  neighbour means at t +- 1 (no halo) and the residuals are computed from
  them with no collective.

Each block phase of the Gauss-Seidel sweep is split over all ``nodes``
ranks (every block holds about ``bs / nodes`` of each rank's rows): a rank
solves its share of the block, B = share x T_local systems in one K1
launch (one K4 launch on its rows in the smoothed fit), then one padded
all-gather over the mesh hands every rank the block's new means, so each
phase reads the freshest global means, as the single-device loop does.  A
Jacobi sweep is one phase.  The ELBO's sums (the residual sums of the
rank's rows, its weighted covariance traces, prior terms and entropy, K2
on its own factors) are all-reduced as one vector, so every rank applies
the stopping rule to the same value and stops at the same iteration.  The
host reads that value once per iteration; the block phases read nothing
back (gloo on a card stages each collective through the host, which
synchronises).

Every option of the plain fits runs sharded, each on the plain loop's
functions applied to the rank's rows:

* ``mask``: the rank's mask rows give its masked partner sums (one
  contraction of its share of each phase against the replicated panel);
  the observed dyad-times and the MSE's count are all-reduced once,
  before the loop.  Under ``TAME_PACKED_MASK=1`` the rank packs its share
  of every phase once as a K5 stripe (62 or 63 rows at n=2000, bs=125 on
  two ranks; all its rows in a Jacobi sweep) and launches K5 where the
  plain fit does.
* ``mixed_precision``: the rank's weights (and dense mask) in bf16.
* ``diag_mode="stats"``: the data terms are row-local under the
  reciprocal layout (``sum y0_ij y0_ji`` is ``sum Y0 Y1`` over the rank's
  rows, a node's column sum its row sum of ``Y[..., 1]``); the dense
  expansion's model-side moments read only the replicated means, so one
  rank per time slice adds them.
* ``update_mode="seq"``: node by node, each node's observation natural
  parameter all-gathered from its owner's time ranks, then its T solves
  run on every rank (K1 at B=1), so the means stay replicated.

Per iteration a rank moves ``nodes x time`` padded pieces of the new means
(``ceil(bs / nodes) x ceil(T / time) x d`` floats each per block phase;
``n`` pieces of ``ceil(T / time) x d`` in a seq sweep) and one all-reduce
of 6 floats per ELBO; no observation-sized tensor ever moves.  With one
rank the arithmetic is the single-device loop's; with rows split, the
residual cross term reads the reciprocal component ``Y[..., 1]`` in place
of the transposed rows (the same numbers).  K3 never runs: ``fused=True``
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from tame_torch.inference import cavi
from tame_torch.inference import smoothed as sm
from tame_torch.ops import dyad as dyad_ops
from tame_torch.ops import masked_contract
from tame_torch.parallel.mesh import (
    Sharded,
    cov_sharding,
    gather,
    place_mask,
    slice_len,
    state_sharding,
)


def refuse(fused) -> None:
    """The one option a sharded fit does not take: K3 runs on one device's
    whole tensors, never under a mesh."""
    if fused is True:
        raise ValueError("fused=True: K3 runs on one device's tensors, "
                         "never under a mesh")


class Geometry:
    """This rank's pieces of an (n, T) fit on a (nodes, time) mesh: its
    rows ``rows`` (a strided slice, row i on rank ``i % nodes``) and time
    slice ``ts``; :meth:`share` and :meth:`gather_means` place any node
    range split over the ranks."""

    def __init__(self, mesh, n: int, T: int):
        self.mesh, self.n, self.T = mesh, n, T
        self.nodes = mesh.shape["nodes"]
        self.k = mesh.coord["nodes"]
        self.rows = mesh.piece("nodes", n)
        self.ts = mesh.piece("time", T)
        self.t_pad = -(-T // mesh.shape["time"])

    def share(self, lo: int, hi: int, k=None) -> slice:
        """Rank ``k``'s rows (this rank's by default) of ``[lo, hi)``."""
        k = self.k if k is None else k
        return slice(lo + (k - lo) % self.nodes, hi, self.nodes)

    def local(self, rows: slice) -> slice:
        """Where this rank's global ``rows`` sit among its local rows."""
        start = (rows.start - self.k) // self.nodes
        return slice(start, start + slice_len(rows, self.n))

    def gather_means(self, X: torch.Tensor, new: torch.Tensor, lo: int,
                     hi: int) -> None:
        """Every rank's new means of ``[lo, hi)`` (``new`` is this rank's:
        its share x its time slice) written into the replicated ``X``:
        one padded all-gather over the mesh."""
        mesh = self.mesh
        pad = (-(-(hi - lo) // self.nodes), self.t_pad) + tuple(
            new.shape[2:])
        for g, piece in enumerate(mesh.comm.all_gather(new, "mesh", pad)):
            c = mesh.coord_of(g)
            rows = self.share(lo, hi, c["nodes"])
            ts = mesh.piece("time", self.T, c["time"])
            X[rows, ts] = piece[:slice_len(rows, self.n),
                                :slice_len(ts, self.T)]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The (n, ...) tensor of which every ``nodes`` rank holds its rows
        ``x`` (the time ranks of a row hold the same): one padded
        all-gather over the ``nodes`` axis, so every rank builds the same
        bits."""
        mesh = self.mesh
        pad = (-(-self.n // self.nodes),) + tuple(x.shape[1:])
        out = x.new_empty((self.n,) + tuple(x.shape[1:]))
        for g, piece in enumerate(mesh.comm.all_gather(x, "nodes", pad)):
            rows = mesh.piece("nodes", self.n, mesh.axis_index("nodes", g))
            out[rows] = piece[:slice_len(rows, self.n)]
        return out


def phases(n: int, update_mode: str, num_blocks):
    """The node ranges updated in turn: the blocks for block Gauss-Seidel,
    else one (a Jacobi sweep; a seq sweep's rows)."""
    if update_mode != "block":
        return [(0, n)]
    if n % num_blocks != 0:
        raise ValueError(f"num_blocks={num_blocks} must divide n={n}")
    bs = n // num_blocks
    return [(b * bs, (b + 1) * bs) for b in range(num_blocks)]


def default_blocks(n: int, update_mode: str, num_blocks):
    if update_mode == "block" and num_blocks is None:
        return next(k for k in range(min(16, n), 0, -1) if n % k == 0)
    return num_blocks


def rank_inputs(Y: Sharded, R_inv: torch.Tensor, mask, geo: Geometry,
                steps, *, mixed_precision: bool,
                diag_mode: str) -> cavi.FitInputs:
    """:func:`tame_torch.inference.cavi.fit_inputs` on this rank's piece:
    its weights, stats constants and mask rows (the mask placed by
    :func:`~tame_torch.parallel.mesh.place_mask`; packed as one K5 stripe
    per phase under ``TAME_PACKED_MASK=1``), with the whole network's
    observed dyad-times and MSE count, all-reduced."""
    m = None if mask is None else place_mask(Y, mask)
    fi = cavi.fit_inputs(Y.local, R_inv, m, mixed_precision=mixed_precision,
                         diag_mode="exact", packed_mask=False, num_blocks=1)
    if diag_mode == "stats" and geo.nodes == 1:
        fi = fi._replace(dc=cavi.precompute_diag_constants(fi.Y))
    elif diag_mode == "stats":
        y0, y1 = fi.Y[..., 0], fi.Y[..., 1]
        fi = fi._replace(dc=cavi.DiagConstants(
            sum_y0_sq=torch.sum(y0 * y0), sum_y0_y0T=torch.sum(y0 * y1),
            row_y0=y0.sum(1), col_y0=y1.sum(1)))
    if m is not None and cavi.packed_mask_requested():
        fi = fi._replace(mask_c=cavi.PackedRows(masked_contract.pack_rows(
            m, [geo.local(geo.share(lo, hi)) for lo, hi in steps])))
    return network_counts(fi, geo)


def observed_inputs(Y: Sharded, mask, geo: Geometry) -> cavi.FitInputs:
    """What the ELBOs and moments read of this rank's piece, without the
    fits' weights: its observations (zeroed where hidden, with ``where``),
    its mask rows and the whole network's counts."""
    Yl, m = rank_observed(Y, mask)
    return network_counts(cavi.FitInputs(
        Y=Yl, obs=None, dc=None, mask=m, mask_c=m,
        mask_stats=None if m is None else cavi._mask_stats(m),
        mse_norm=None), geo)


def rank_observed(Y: Sharded, mask):
    """``(Y, m)``: this rank's piece of ``Y``, zeroed with ``where`` at
    its hidden dyads, and its rows of the whole ``mask`` (None without
    one)."""
    if mask is None:
        return Y.local, None
    m = place_mask(Y, mask)
    return torch.where(m[..., None] > 0, Y.local, torch.zeros(
        (), dtype=Y.local.dtype, device=Y.local.device)), m


def network_counts(fi: cavi.FitInputs, geo: Geometry) -> cavi.FitInputs:
    """``fi`` with the whole network's observed dyad-times and MSE count
    (one all-reduce under a mask)."""
    if fi.mask is None:
        return fi._replace(mse_norm=geo.n * (geo.n - 1) * geo.T)
    n_obs, total = geo.mesh.comm.all_reduce(
        torch.stack([fi.mask_stats[0], fi.mask.sum()]), "mesh")
    return fi._replace(mask_stats=(n_obs, fi.mask_stats[1]),
                       mse_norm=torch.clamp(total, min=1.0))


def phase_contract(fi: cavi.FitInputs, k: int, loc: slice):
    """The masked partner contraction of this rank's share ``loc`` of
    phase ``k`` (None without a mask): its K5 stripe, or its rows of the
    dense mask through ``cavi._eta_contract``."""
    if fi.mask is None:
        return None
    if isinstance(fi.mask_c, cavi.PackedRows):
        stripe = fi.mask_c.stripes[k]
        return lambda Z: masked_contract.packed_rows_contract(
            stripe, Z)[:stripe.shape[1]]
    rows = fi.mask_c[loc]
    return lambda Z: cavi._eta_contract(rows, Z)


def rows_means(X: torch.Tensor, geo: Geometry, r: int):
    """``(fwd, bwd)`` (m, n, T_local) of this rank's rows: ``fwd[i, j] =
    a_i + b_j + U_i . V_j`` and the reciprocal ``bwd[i, j] = fwd[j, i]``
    (a transpose where the rank holds every row)."""
    a, b, U, V = dyad_ops.split_state(X[:, geo.ts], r)
    rows = geo.rows
    fwd = (a[rows][:, None, :] + b[None, :, :]
           + torch.einsum("...itr,...jtr->...ijt", U[rows], V))
    if geo.nodes == 1:
        return fwd, fwd.transpose(0, 1)
    bwd = (a[None, :, :] + b[rows][:, None, :]
           + torch.einsum("...jtr,...itr->...ijt", U, V[rows]))
    return fwd, bwd


def off_diagonal(geo: Geometry, like: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the off-diagonal mask, (m, n, 1)."""
    ids = torch.arange(geo.n, device=like.device)
    return (ids[None, :] != ids[geo.rows][:, None]).to(like.dtype)[..., None]


def residual_partials(Yl: torch.Tensor, X: torch.Tensor, geo: Geometry,
                      r: int, mask=None):
    """``(sq, cross)`` of :func:`tame_torch.ops.dyad.residual_stats_from_fwd`
    over this rank's rows and time slice (its observed dyads under
    ``mask``, its rows of a symmetric zero-diagonal mask): ``e0[i, j] =
    y_ij - m_ij`` from ``Yl[..., 0]``; its partner ``e0[j, i]`` is a
    transpose where the rank holds every row, else ``y_ji - m_ji`` from
    the reciprocal component ``Yl[..., 1]``."""
    fwd, bwd = rows_means(X, geo, r)
    if mask is None:
        mask = off_diagonal(geo, Yl)
    e0 = (Yl[..., 0] - fwd) * mask
    if geo.nodes == 1:
        return torch.sum(e0 * e0), torch.sum(e0 * e0.transpose(0, 1))
    e1 = (Yl[..., 1] - bwd) * mask
    return torch.sum(e0 * e0), torch.sum(e0 * e1)


def rank_quad(fi: cavi.FitInputs, X: torch.Tensor, geo: Geometry, r: int,
              R_inv: torch.Tensor) -> torch.Tensor:
    """This rank's share of the public ELBOs' quadratic form (``quad_sum``
    of :func:`tame_torch.inference.cavi.compute_elbo`): both components of
    its rows' residuals against ``R^-1``, halved, over its off-diagonal
    or observed dyads."""
    fwd, bwd = rows_means(X, geo, r)
    e0, e1 = fi.Y[..., 0] - fwd, fi.Y[..., 1] - bwd
    p_, q_ = R_inv[0, 0], R_inv[0, 1]
    quad = p_ * (e0 * e0 + e1 * e1) + 2.0 * q_ * (e0 * e1)
    mask = off_diagonal(geo, fi.Y) if fi.mask is None else fi.mask
    return 0.5 * torch.sum(quad * mask)


def rank_residual_stats(fi: cavi.FitInputs, X: torch.Tensor, geo: Geometry,
                        r: int, R_inv: torch.Tensor, diag_mode: str):
    """This rank's share of :func:`tame_torch.inference.cavi.residual_stats`
    (summed over the mesh, the whole network's)."""
    if diag_mode == "stats" and fi.mask is not None:
        return cavi._masked_residual_stats(fi.dc, fi.obs, X[:, geo.ts], r,
                                           R_inv, fi.mask_c, geo.rows)
    if diag_mode == "stats":
        return cavi._residual_stats_from_moments(
            fi.dc, fi.obs, X[:, geo.ts], r, R_inv, geo.rows,
            model_terms=geo.k == 0)
    return residual_partials(fi.Y, X, geo, r, fi.mask)


def weighted_trace(fi: cavi.FitInputs, X_cov: torch.Tensor) -> torch.Tensor:
    """This rank's share of the structured trace correction's sum: its
    covariance traces, weighted by the observed partners under a mask."""
    tr = torch.diagonal(X_cov, dim1=-2, dim2=-1).sum(-1)
    return torch.sum(tr) if fi.mask is None else torch.sum(
        fi.mask_stats[1] * tr)


def likelihood_counts(fi: cavi.FitInputs, n: int, T: int, wtr):
    """``(n_dyads, wsum)`` of the ELBO from the all-reduced weighted trace:
    as ``cavi._elbo_from_quad`` computes them."""
    if fi.mask is None:
        return n * (n - 1) // 2 * T, (n - 1) * wtr
    return fi.mask_stats[0], wtr


def sharded_elbo(fi: cavi.FitInputs, geo: Geometry, params,
                 pri: cavi.PriorMatrices, lik, X_cov: torch.Tensor,
                 model_terms, structure: str):
    """The whole network's ELBO from this rank's shares, the same on every
    rank (one all-reduce of the sums), with the reduced likelihood sums.

    ``lik``: the rank's residual sums ``(sq, cross)`` (the quadratic form
    ``p sq + q cross``, as the fits compute it) or its ``(quad_sum,)``;
    ``X_cov`` its covariances, whose traces the structured correction
    weighs; ``model_terms`` the prior terms and entropy of its factors;
    ``structure`` a CAVI policy, or ``"smoothed"`` for the smoothed
    family's correction (:func:`~tame_torch.inference.smoothed.
    smoothed_elbo_from_terms`)."""
    k = len(lik)
    parts = geo.mesh.comm.all_reduce(torch.stack(
        [*lik, weighted_trace(fi, X_cov), *model_terms]), "mesh")
    n_dyads, wsum = likelihood_counts(fi, geo.n, geo.T, parts[k])
    quad = (params.R_inv[0, 0] * parts[0] + params.R_inv[0, 1] * parts[1]
            if k == 2 else parts[0])
    prior0, priort, ent = parts[k + 1:]
    d = X_cov.shape[-1]
    if structure == "smoothed":
        elbo = sm.smoothed_elbo_from_terms(quad, n_dyads, wsum, prior0,
                                           priort, ent, params, pri, d)
    else:
        elbo = cavi.elbo_from_terms(
            quad, n_dyads, wsum if structure in ("full", "block") else None,
            prior0, priort, ent, params, pri, d)
    return elbo, parts[:k]


def prior_partials(params, pri: cavi.PriorMatrices, Xr: torch.Tensor,
                   cov: torch.Tensor, t0: int):
    """``cavi.state_prior_terms`` over this rank's rows and time slice:
    ``Xr`` (m, T, d) the rows' means at every t (replicated), ``cov`` (m,
    T_local, d, d) their covariances from ``t0``.  The transition terms of
    the local steps t >= 1 read the mean at t - 1 from ``Xr``."""
    d = Xr.shape[-1]
    zero = Xr.new_zeros(())
    prior0 = priort = zero
    if t0 == 0:
        mu0 = Xr[:, 0]
        quad0 = torch.einsum("ia,ab,ib->i", mu0, pri.Sigma0_inv, mu0)
        trace0 = torch.einsum("ab,iba->i", pri.Sigma0_inv, cov[:, 0])
        prior0 = -0.5 * torch.sum(quad0 + trace0 + pri.logdet_Sigma0
                                  + d * cavi._LOG2PI)
    lo, hi = max(t0, 1), t0 + cov.shape[1]
    if hi > lo:
        residt = Xr[:, lo:hi] - Xr[:, lo - 1:hi - 1] @ params.Phi.T
        quadt = torch.einsum("ita,ab,itb->it", residt, pri.Q_inv, residt)
        tracet = torch.einsum("ab,itba->it", pri.Q_inv, cov[:, lo - t0:])
        priort = -0.5 * torch.sum(quadt + tracet + pri.logdet_Q
                                  + d * cavi._LOG2PI)
    return prior0, priort


def cavi_terms(params, pri: cavi.PriorMatrices, X: torch.Tensor,
               X_cov: torch.Tensor, geo: Geometry):
    """The prior terms and the entropy (K2) of this rank's mean-field
    factors: its rows of the replicated means ``X``, its covariances."""
    return (*prior_partials(params, pri, X[geo.rows], X_cov, geo.ts.start),
            cavi.gaussian_entropy(cavi.CaviState(X[geo.rows, geo.ts], X_cov)))


def replicated_means(init: Sharded, field: str = "X_mean") -> torch.Tensor:
    """The whole means tensor from every rank's piece of a sharded state."""
    return gather(init.mesh, getattr(init.local, field), init.spec[field],
                  init.sizes)


def _check(Y, init) -> None:
    if Y.mesh is not init.mesh:
        raise ValueError("Y and the initial state lie on different meshes")


def nodes_only(mesh) -> None:
    """The smoothed family's trajectories are whole on a rank: refuse a
    mesh that splits time."""
    if mesh.shape["time"] != 1:
        raise ValueError("the smoothed engine shards over 'nodes' only; "
                         "build the mesh with time=1")


def on_mesh(mesh, pri: cavi.PriorMatrices) -> cavi.PriorMatrices:
    return cavi.PriorMatrices(*(t.to(mesh.device) for t in pri))


def compute_elbo_sharded(Y: Sharded, params, pri: cavi.PriorMatrices,
                         state: Sharded, structure: str,
                         obs_mask) -> torch.Tensor:
    """:func:`tame_torch.inference.cavi.compute_elbo` of a sharded state
    (a fit's result, or inputs from
    :func:`~tame_torch.parallel.mesh.shard_fit_inputs`): each rank's rows
    of the residual quadratic form, traces, prior terms and entropy,
    summed by :func:`sharded_elbo`; ``obs_mask`` the whole mask."""
    _check(Y, state)
    geo = Geometry(Y.mesh, Y.sizes["nodes"], Y.sizes["time"])
    params, pri = params.to(Y.mesh.device), on_mesh(Y.mesh, pri)
    fi = observed_inputs(Y, obs_mask, geo)
    X, X_cov = replicated_means(state), state.local.X_cov
    r = (X.shape[-1] - 2) // 2
    elbo, _ = sharded_elbo(fi, geo, params, pri,
                           (rank_quad(fi, X, geo, r, params.R_inv),), X_cov,
                           cavi_terms(params, pri, X, X_cov, geo), structure)
    return elbo


def smoothed_elbo_sharded(Y: Sharded, params, pri: cavi.PriorMatrices,
                          state: Sharded, obs_mask) -> torch.Tensor:
    """:func:`tame_torch.inference.smoothed.smoothed_elbo` of a sharded
    smoothed state (from :func:`~tame_torch.parallel.mesh.
    shard_smoothed_inputs` or a sharded fit's ``field("state")``), as
    :func:`compute_elbo_sharded` with the smoothed family's exact prior
    terms and trajectory entropy of each rank's nodes."""
    _check(Y, state)
    nodes_only(Y.mesh)
    geo = Geometry(Y.mesh, Y.sizes["nodes"], Y.sizes["time"])
    params, pri = params.to(Y.mesh.device), on_mesh(Y.mesh, pri)
    fi = observed_inputs(Y, obs_mask, geo)
    X = replicated_means(state)
    r = (X.shape[-1] - 2) // 2
    elbo, _ = sharded_elbo(fi, geo, params, pri,
                           (rank_quad(fi, X, geo, r, params.R_inv),),
                           state.local.X_cov,
                           sm.smoothed_prior_entropy(params, pri,
                                                     state.local),
                           "smoothed")
    return elbo


def seq_sweep(X: torch.Tensor, X_cov: torch.Tensor, obs: cavi.ObsConstants,
              pri: cavi.PriorMatrices, params, structure: str, lr: float,
              geo: Geometry) -> None:
    """:func:`tame_torch.inference.cavi.seq_sweep` on the replicated means
    ``X`` and this rank's covariances ``X_cov``, in place.  Node i's
    observation natural parameter needs row i of the weights, which only
    its owner's time ranks hold: they compute their time pieces and one
    padded all-gather hands every rank the whole (T, d).  Every rank then
    runs node i's T prior-coupled solves (one K1 launch of one system
    each, as the plain sweep), so the means stay replicated; the owner
    keeps the covariances of its time slice."""
    ts, got = geo.ts, torch.empty_like(X)

    def node_eta(i, U, V):
        if i % geo.nodes == geo.k:
            piece = cavi.node_obs_eta(obs, i // geo.nodes, U[:, ts],
                                      V[:, ts])[None]
        else:
            piece = X.new_zeros(0, slice_len(ts, geo.T), X.shape[-1])
        geo.gather_means(got, piece, i, i + 1)
        return got[i]

    def keep_cov(i, t, cov_new):
        if i % geo.nodes == geo.k and ts.start <= t < ts.stop:
            li, lt = i // geo.nodes, t - ts.start
            X_cov[li, lt] = lr * cov_new + (1.0 - lr) * X_cov[li, lt]

    cavi.seq_sweep(X, pri, params, structure, lr, node_eta, keep_cov)


def fit_cavi_sharded(Y: Sharded, params, init: Sharded, *, structure: str,
                     update_mode: str, max_iter: int, learning_rate,
                     tolerance, patience: int, num_blocks, corrected: bool,
                     elbo_every: int, mixed_precision: bool, diag_mode: str,
                     fused, carry_elbo, carry_patience: int,
                     mask) -> Sharded:
    """:func:`tame_torch.inference.cavi.fit_cavi` on inputs from
    :func:`~tame_torch.parallel.mesh.shard_fit_inputs` (see the module
    docstring); ``mask`` is the whole (n, n, T) mask.  The result holds
    this rank's ``X_mean``/``X_cov`` pieces; ``full()`` gathers a plain
    ``FitResult``."""
    refuse(fused)
    cavi.check_fit_options(update_mode, diag_mode, mask, corrected,
                           mixed_precision)
    _check(Y, init)
    mesh = Y.mesh
    n, T = Y.sizes["nodes"], Y.sizes["time"]
    d = init.local.X_mean.shape[-1]
    r = (d - 2) // 2
    geo = Geometry(mesh, n, T)
    params = params.to(mesh.device)
    steps = phases(n, update_mode, default_blocks(n, update_mode,
                                                  num_blocks))
    fi = rank_inputs(Y, params.R_inv, mask, geo, steps,
                     mixed_precision=mixed_precision, diag_mode=diag_mode)
    obs = fi.obs
    shares = [(geo.share(lo, hi), geo.local(geo.share(lo, hi)))
              for lo, hi in steps]
    contracts = [phase_contract(fi, k, loc)
                 for k, (_, loc) in enumerate(shares)]
    pri = cavi.precompute_priors(params)
    prior_P = cavi._prior_precision(pri, T)[geo.ts][None]
    solver = cavi._SOLVERS[structure]
    lr = float(learning_rate)
    X = replicated_means(init)
    X_cov = init.local.X_cov.clone()
    buf = cavi.history_buffer(max_iter)
    eh = np.full(buf, np.nan, np.float32)
    mh = np.full(buf, np.nan, np.float32)
    rule = cavi._StopRule(carry_elbo, carry_patience, tolerance, patience)
    it = 0
    while it < max_iter and rule.running:
        if update_mode == "seq":
            seq_sweep(X, X_cov, obs, pri, params, structure, lr, geo)
        else:
            for (lo, hi), (rows, loc), contract in zip(steps, shares,
                                                       contracts):
                new = X[rows, geo.ts]
                if new.shape[0]:  # no row here of a block smaller than nodes
                    P, eta = cavi.rows_obs_terms(
                        X[:, geo.ts], rows, obs.W0[loc], obs.W1[loc],
                        obs.eta_a[loc], obs.eta_b[loc], params.R_inv,
                        corrected, contract)
                    eta = eta + cavi._prior_nat_param(pri, X[rows])[:, geo.ts]
                    mu_new, cov_new = solver(P + prior_P, eta)
                    new = lr * mu_new + (1.0 - lr) * new
                    X_cov[loc] = lr * cov_new + (1.0 - lr) * X_cov[loc]
                geo.gather_means(X, new, lo, hi)
        elbo = None
        if (it + 1) % elbo_every == 0 or it + 1 == max_iter:
            elbo_t, (sq, _) = sharded_elbo(
                fi, geo, params, pri,
                rank_residual_stats(fi, X, geo, r, params.R_inv, diag_mode),
                X_cov, cavi_terms(params, pri, X, X_cov, geo), structure)
            elbo, mse = torch.stack([elbo_t,
                                     2.0 * sq / fi.mse_norm]).tolist()
            eh[it], mh[it] = elbo, mse
        rule.update(elbo)
        it += 1
    local = cavi.FitResult(
        X_mean=X[geo.rows, geo.ts].clone(), X_cov=X_cov,
        elbo_history=torch.from_numpy(eh), mse_history=torch.from_numpy(mh),
        n_iter=it, converged=rule.converged, diverged=rule.diverged,
        last_elbo=float(rule.prev), pat_count=rule.pat)
    return Sharded(local, mesh, Y.sizes,
                   {"X_mean": state_sharding(mesh).spec,
                    "X_cov": cov_sharding(mesh).spec})


def fit_smoothed_sharded(Y: Sharded, params, init: Sharded, *,
                         max_iter: int, learning_rate, tolerance,
                         patience: int, corrected: bool, fused, smoother: str,
                         update_mode: str, num_blocks, mixed_precision: bool,
                         diag_mode: str, carry_elbo, carry_patience: int,
                         mask) -> Sharded:
    """:func:`tame_torch.inference.smoothed.fit_cavi_smoothed` on inputs
    from :func:`~tame_torch.parallel.mesh.shard_smoothed_inputs`: every
    block phase solves this rank's share of the block's trajectories in
    one :func:`~tame_torch.ops.fused_smoother.fused_smoother` call (K4 on
    the card; the associative-scan smoother under
    ``smoother="parallel"``), then gathers the new means.  ``mask``,
    ``mixed_precision`` and ``diag_mode`` as in :func:`fit_cavi_sharded`.
    The result's state holds this rank's pieces; ``full()`` gathers a
    plain ``SmoothedFitResult``."""
    if diag_mode not in ("exact", "stats"):
        raise ValueError(f"unknown diag_mode: {diag_mode!r}")
    if smoother not in ("auto", "sequential", "parallel"):
        raise ValueError(f"unknown smoother: {smoother!r}")
    if update_mode not in ("auto", "jacobi", "block"):
        raise ValueError(f"unknown update_mode: {update_mode!r}")
    if fused is True and smoother == "parallel":
        raise ValueError("fused=True and smoother='parallel' are mutually "
                         "exclusive solver choices")
    _check(Y, init)
    mesh = Y.mesh
    nodes_only(mesh)
    n, T = Y.sizes["nodes"], Y.sizes["time"]
    d = init.local.X_mean.shape[-1]
    r = (d - 2) // 2
    if fused is True and not sm.fused_smoother_supported(n, T, d):
        raise ValueError(f"fused smoother unsupported for n={n}, T={T}, "
                         f"d={d} (needs an even d from 4 to 48)")
    if update_mode == "auto":
        update_mode = "block" if n >= 256 else "jacobi"
    geo = Geometry(mesh, n, T)
    params = params.to(mesh.device)
    steps = phases(n, update_mode, default_blocks(n, update_mode,
                                                  num_blocks))
    fi = rank_inputs(Y, params.R_inv, mask, geo, steps,
                     mixed_precision=mixed_precision, diag_mode=diag_mode)
    obs = fi.obs
    shares = [(geo.share(lo, hi), geo.local(geo.share(lo, hi)))
              for lo, hi in steps]
    contracts = [phase_contract(fi, k, loc)
                 for k, (_, loc) in enumerate(shares)]
    pri = cavi.precompute_priors(params)
    solve = sm._trajectory_solver(pri, params, T, smoother == "parallel")
    lr = float(learning_rate)
    X = replicated_means(init)
    X_cov, X_cross = init.local.X_cov.clone(), init.local.X_cross.clone()
    logdets = init.local.logdets.clone()
    buf = cavi.history_buffer(max_iter)
    eh = np.full(buf, np.nan, np.float32)
    mh = np.full(buf, np.nan, np.float32)
    rule = cavi._StopRule(carry_elbo, carry_patience, tolerance, patience)
    it = 0
    while it < max_iter and rule.running:
        for (lo, hi), (rows, loc), contract in zip(steps, shares, contracts):
            new = X[rows]
            if new.shape[0]:  # no row here of a block smaller than nodes
                D_obs, bvec = cavi.rows_obs_terms(
                    X, rows, obs.W0[loc], obs.W1[loc], obs.eta_a[loc],
                    obs.eta_b[loc], params.R_inv, corrected, contract)
                out = solve(D_obs, bvec)
                new = lr * out.mean + (1.0 - lr) * new
                X_cov[loc], X_cross[loc] = out.cov, out.cross_cov
                logdets[loc] = out.logdet
            geo.gather_means(X, new, lo, hi)
        state = sm.SmoothedState(X[geo.rows], X_cov, X_cross, logdets)
        elbo_t, (sq, _) = sharded_elbo(
            fi, geo, params, pri,
            rank_residual_stats(fi, X, geo, r, params.R_inv, diag_mode),
            X_cov, sm.smoothed_prior_entropy(params, pri, state), "smoothed")
        elbo, mse = torch.stack([elbo_t, 2.0 * sq / fi.mse_norm]).tolist()
        eh[it], mh[it] = elbo, mse
        rule.update(elbo)
        it += 1
    local = sm.SmoothedFitResult(
        state=sm.SmoothedState(X[geo.rows].clone(), X_cov, X_cross,
                               logdets),
        elbo_history=torch.from_numpy(eh), mse_history=torch.from_numpy(mh),
        n_iter=it, converged=rule.converged, diverged=rule.diverged,
        last_elbo=float(rule.prev), pat_count=rule.pat)
    return Sharded(local, mesh, Y.sizes, {"state": init.spec})
