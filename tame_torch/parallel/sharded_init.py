"""The warm inits on a sharded network (the port's counterpart of GSPMD
partitioning :func:`tame.inference.cavi.warm_init_state` and
``tame.inference.smoothed.warm_init_smoothed_state``).

The warm start is a two-way fit of the time-averaged network ``M`` (n, n)
plus a subspace iteration on its residual.  A rank builds its rows of
``M`` from its rows of ``Y`` (and of the mask); under a ``time`` axis the
time sums (and the observed counts) are all-reduced over ``time``.  Then:

* row means are the rank's own; column sums, their counts and the grand
  sum are one all-reduce over ``nodes``;
* ``resid @ Z`` is the rank's rows times the replicated (n, r) panel,
  all-gathered over ``nodes``; ``resid' Z`` and the SVD's ``Z' resid``
  are all-reduces of the rows' partials;
* the QR and the SVD run on replicated panels, each built by a
  collective, so every rank holds the same bits and the QR's signs agree;
* the probe is drawn the same way on every rank.

On one rank this is the plain function's arithmetic, bit for bit.  The
state comes out sharded as :func:`~tame_torch.parallel.mesh.
shard_fit_inputs` (or ``shard_smoothed_inputs``) places one, so it feeds
the sharded fits directly, and no rank ever holds the whole network.
"""

from __future__ import annotations

import torch

from tame_torch.inference import cavi
from tame_torch.inference import smoothed as sm
from tame_torch.parallel.mesh import (
    Sharded,
    cov_sharding,
    place_mask,
    smoothed_spec,
    state_sharding,
)
from tame_torch.parallel.sharded_cavi import Geometry, nodes_only


def _time_average(Y: Sharded, geo: Geometry, obs_mask):
    """``(M, w)``: this rank's rows of the time-averaged network and of
    its weights (off the diagonal; observed at least once under
    ``obs_mask``)."""
    comm = Y.mesh.comm
    Yl = Y.local
    split = Y.spec[2] == "time" and Y.mesh.shape["time"] > 1
    if obs_mask is None:
        ids = torch.arange(geo.n, device=Yl.device)
        w = (ids[geo.rows][:, None] != ids[None, :]).to(Yl.dtype)
        if split:
            return comm.all_reduce(Yl[..., 0].sum(-1), "time") / geo.T * w, w
        return Yl[..., 0].mean(-1) * w, w
    om = place_mask(Y, obs_mask)
    Yo = torch.where(om[..., None] > 0, Yl,
                     torch.zeros((), dtype=Yl.dtype, device=Yl.device))
    total, cnt_t = Yo[..., 0].sum(-1), om.sum(-1)
    if split:
        total, cnt_t = comm.all_reduce(torch.stack([total, cnt_t]), "time")
    M = total / torch.clamp(cnt_t, min=1.0)
    return M, (cnt_t > 0).to(M.dtype)


def warm_init_sharded(Y: Sharded, params, *, structure: str,
                      cov_init_scale: float, n_power_iters: int, probe,
                      generator, obs_mask) -> Sharded:
    """:func:`tame_torch.inference.cavi.warm_init_state` on a sharded
    ``Y`` (see the module docstring); ``obs_mask`` the whole mask."""
    mesh, comm = Y.mesh, Y.mesh.comm
    n, T = Y.sizes["nodes"], Y.sizes["time"]
    geo = Geometry(mesh, n, T)
    rows = geo.rows
    d = params.Phi.shape[0]
    r = (d - 2) // 2
    M, w = _time_average(Y, geo, obs_mask)
    row_mean = M.sum(1) / torch.clamp(w.sum(1), min=1.0)
    sums = comm.all_reduce(torch.cat([M.sum(0), w.sum(0), M.sum()[None],
                                      w.sum()[None]]), "nodes")
    col_mean = sums[:n] / torch.clamp(sums[n:2 * n], min=1.0)
    grand = sums[2 * n] / torch.clamp(sums[2 * n + 1], min=1.0)
    a = row_mean - grand / 2.0
    b = col_mean - grand / 2.0

    resid = (M - a[:, None] - b[None, :]) * w
    if probe is None:
        gen = (generator if generator is not None
               else torch.Generator().manual_seed(0))
        probe = torch.randn(n, r, generator=gen, device=gen.device)
    Z = geo.gather_rows(resid @ probe.to(M))
    for _ in range(n_power_iters):
        G = comm.all_reduce(resid.T @ Z[rows], "nodes")
        Z, _ = torch.linalg.qr(geo.gather_rows(resid @ G))
    u_s, sing, vt = torch.linalg.svd(
        comm.all_reduce(Z[rows].T @ resid, "nodes"), full_matrices=False)
    scale = torch.sqrt(torch.clamp(sing, min=1e-12))
    U = (Z @ u_s) * scale[None, :]
    V = vt.T * scale[None, :]

    centroid = torch.cat([a[:, None], b[rows][:, None], U[rows], V[rows]],
                         -1)
    m, t_local = centroid.shape[0], Y.local.shape[2]
    var = {"diag": 0.5, "full": cov_init_scale + 0.1,
           "block": cov_init_scale + 0.05}[structure]
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    local = cavi.CaviState(
        X_mean=centroid[:, None, :].expand(m, t_local, d).clone(),
        X_cov=(eye * var).expand(m, t_local, d, d).clone())
    return Sharded(local, mesh, Y.sizes,
                   {"X_mean": state_sharding(mesh).spec,
                    "X_cov": cov_sharding(mesh).spec})


def warm_init_smoothed_sharded(Y: Sharded, params, *, obs_mask, probe,
                               generator) -> Sharded:
    """:func:`tame_torch.inference.smoothed.warm_init_smoothed_state` on a
    sharded ``Y``: the sharded centroid decomposition with each rank's
    nodes' deterministic covariances, placed as
    :func:`~tame_torch.parallel.mesh.shard_smoothed_inputs` places a
    state."""
    nodes_only(Y.mesh)
    warm = warm_init_sharded(Y, params, structure="full",
                             cov_init_scale=0.5, n_power_iters=4,
                             probe=probe, generator=generator,
                             obs_mask=obs_mask)
    X = warm.local.X_mean
    local = sm.SmoothedState(X, *sm._fresh_covariances(
        *X.shape, X.dtype, X.device))
    return Sharded(local, Y.mesh, Y.sizes, smoothed_spec(local))
