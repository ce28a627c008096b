"""The EM moments and the exact ELBO on a sharded network (the port's
counterpart of GSPMD partitioning :func:`tame.inference.em.em_update_params`
and :func:`tame.inference.evidence.exact_elbo`).

A sharded smoothed state holds each rank's nodes (means, marginal and
lag-1 cross-covariances, log-determinants).  Every M-step moment is a sum
over nodes, so each rank sums its own and one all-reduce over the mesh
completes them:

* the transition moments ``(A, B, Sxx, S00)`` of its nodes;
* the plug-in residual statistics of its rows (against the replicated
  means, one all-gather of them);
* the variance corrections' pair sums ``sum_ij m_ij x_i . z_j``: the
  rank's nodes i against every partner j.  Without a mask a pair sum is
  ``sum_i x_i . sum_j z_j - sum_i x_i . z_i``: the column sums of the
  rank's panels are all-reduced first, and one rank adds the product
  term.  Under a mask it is ``sum_i x_i . (M z)_i``: the rank's mask rows
  against the partner panels, whose covariance columns are all-gathered.

The d x d solves of the M-step run on the summed moments
(:func:`tame_torch.inference.em.m_step`), so the parameters come out the
same on every rank.  On one rank every sum is the plain function's, bit
for bit.
"""

from __future__ import annotations

import torch

from tame_torch.inference import em
from tame_torch.inference.smoothed import smoothed_prior_entropy
from tame_torch.parallel.mesh import Sharded
from tame_torch.parallel.sharded_cavi import (
    Geometry,
    _check,
    nodes_only,
    rank_observed,
    replicated_means,
    residual_partials,
)


def _corrections(S: torch.Tensor, X: torch.Tensor, geo: Geometry, r: int,
                 m):
    """This rank's shares of
    :func:`tame_torch.inference.em._residual_moment_corrections`: ``S``
    the covariances of its nodes, ``X`` the replicated means, ``m`` its
    mask rows (None: every pair i != j)."""
    comm = geo.mesh.comm
    own = em._own_panels(S, r)
    means, covs = em._mean_panels(X, r), em._cov_panels(S, r)
    if m is not None:
        gathered = geo.gather_rows(torch.cat(list(covs.values()), -1))
        covs = dict(zip(covs, gathered.split(
            [z.shape[-1] for z in covs.values()], -1)))
        panels = {**means, **covs}
        partners = {k: panels[k] for k in em._PARTNERS}
        return em._correction_sums(S, m.sum(1),
                                   em._masked_pair(m, partners, own))
    names = list(own) + list(covs)
    parts = [*own.values(), *covs.values()]
    sums = dict(zip(names, comm.all_reduce(
        torch.cat([z.sum(0) for z in parts], -1), "nodes").split(
            [z.shape[-1] for z in parts], -1)))
    col = {**{k: z.sum(0) for k, z in means.items()},
           **{k: sums[k] for k in covs}}
    rows = {**{k: z[geo.rows] for k, z in means.items()}, **covs}
    zero = S.new_zeros(())

    def pair(x, key):
        # sum_i x_i . sum_j z_j, added once over the mesh
        head = torch.sum(sums[x] * col[key]) if geo.k == 0 else zero
        return head - torch.sum(own[x] * rows[key])
    return em._correction_sums(S, float(geo.n - 1), pair)


def _reduced(Y: Sharded, state: Sharded, mask, head, with_resid: bool):
    """One all-reduce over the mesh of this rank's partial sums: the
    tensors ``head(local)`` of its nodes' state, then (``with_resid``) the
    residual
    statistics and their corrections.  Returns ``(geo, X, head sums,
    (sq, cross, count, var_corr, cross_corr) or None)``."""
    _check(Y, state)
    nodes_only(Y.mesh)
    geo = Geometry(Y.mesh, Y.sizes["nodes"], Y.sizes["time"])
    X = replicated_means(state)
    local = state.local
    r = (X.shape[-1] - 2) // 2
    parts = list(head(local))
    k, m = len(parts), None
    if with_resid:
        Yl, m = rank_observed(Y, mask)
        parts += [*residual_partials(Yl, X, geo, r, m),
                  *_corrections(local.X_cov, X, geo, r, m)]
        if m is not None:
            parts.append(m.sum())
    sizes = [p.numel() for p in parts]
    out = geo.mesh.comm.all_reduce(
        torch.cat([p.reshape(-1) for p in parts]), "mesh").split(sizes)
    out = [o.view(p.shape) for o, p in zip(out, parts)]
    resid = None
    if with_resid:
        sq, cross, var_corr, cross_corr = out[k:k + 4]
        count = (Y.local.new_tensor(float(geo.n * (geo.n - 1) * geo.T))
                 if m is None else out[-1])
        resid = (sq, cross, count, var_corr, cross_corr)
    return geo, X, out[:k], resid


def em_moments(Y: Sharded, state: Sharded, mask, with_resid: bool):
    """``(n, T, d, (A, B, Sxx, S00), resid)``: the M-step's moments of
    the whole network, summed over the mesh's ranks, and (with
    ``with_resid``) the residual statistics ``(sq, cross, count,
    var_corr, cross_corr)``; ``mask`` the whole mask."""
    geo, X, moments, resid = _reduced(
        Y, state, mask, em._transition_moments, with_resid)
    return geo.n, geo.T, X.shape[-1], tuple(moments), resid


def exact_elbo_terms(Y: Sharded, params, pri, state: Sharded, mask):
    """The terms of :func:`tame_torch.inference.evidence.
    elbo_from_moments` for the whole network: the residual statistics and
    their corrections, the count, and the smoothed prior terms and
    trajectory entropy of every rank's nodes, summed over the mesh."""
    _, _, (prior0, priort, entropy), resid = _reduced(
        Y, state, mask, lambda local: smoothed_prior_entropy(params, pri,
                                                             local), True)
    return (*resid, prior0, priort, entropy)
