"""Batched damped-CAVI engine for the temporal AME family, dense float32
path (counterpart of :mod:`tame.inference.cavi`).

One coordinate-ascent engine parameterized by a covariance-structure
policy: ``"diag"`` (naive mean field), ``"full"`` (good structured MF) and
``"block"`` (bad structured MF).  With R^-1 = [[p, q], [q, p]] the
observation terms of factor (i, t) collapse into global sufficient
statistics per time step (see the JAX module's docstring for the algebra):

    P_obs[i,t] = assembled from sU, sV, GUU, GVV, GVU minus node i's term
    eta_obs[i,t] = [ sum_j W0_ij, sum_j W1_ij, (W0 @ V)_i, (W1 @ U)_i ]

with W0 = p Y[...,0] + q Y[...,1] and W1 = q Y[...,0] + p Y[...,1].  The
``W @ Z`` contractions are plain batched matrix products (``torch.einsum``,
full float32: TF32 is off, see the package docstring).  The d x d solves and
the entropy's log-determinants go through :mod:`tame_torch.ops.cholesky`;
a whole small fit on the card goes through :mod:`tame_torch.ops.fused_fit`.

Missing-data fits (``mask``) assemble the observation terms from masked
partner statistics, one concatenated-panel contraction of the mask per
phase (:func:`_masked_obs_precision`); with ``TAME_PACKED_MASK=1`` those
contractions read the mask as int8 through K5
(:mod:`tame_torch.ops.masked_contract`).  ``mixed_precision`` stores the
dyad weights (and the mask) in bf16 with float32 sums
(:func:`_eta_contract`); ``diag_mode="stats"`` computes the ELBO/MSE from
sufficient statistics with no O(n^2 T) residual pass
(:func:`_residual_stats_from_moments`, :func:`_masked_residual_stats`).

PyTorch has no device ``while_loop``: :func:`fit_loop` is a Python loop
that reads each iteration's ELBO on the host and applies the JAX loop's
stopping rule in float32.  The port updates the state in place, block by
block, on its own copy of the initial state.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from tame_torch.inference import graphed
from tame_torch.models.params import AMEParams, _fields_as_tensors
from tame_torch.ops import dyad as dyad_ops
from tame_torch.ops import fused_fit
from tame_torch.ops import masked_contract
from tame_torch.ops.cholesky import (
    batched_logdet_spd,
    batched_spd_solve,
    batched_spd_solve_inv,
)
from tame_torch.utils import profiling

_LOG2PI = 1.8378770664093453  # log(2 * pi)


class ObsConstants(NamedTuple):
    """Data-dependent quantities that are constant across CAVI iterations."""

    W0: torch.Tensor     # (n, n, T)  p*y_ij + q*y_ji (f32 or bf16)
    W1: torch.Tensor     # (n, n, T)  q*y_ij + p*y_ji
    eta_a: torch.Tensor  # (n, T)     row-sums of W0
    eta_b: torch.Tensor  # (n, T)     row-sums of W1


class PriorMatrices(NamedTuple):
    """Precomputed prior/transition matrices (all (d, d)) and log-dets."""

    Sigma0_inv: torch.Tensor
    Q_inv: torch.Tensor
    Qinv_Phi: torch.Tensor        # Q^-1 Phi
    PhiT_Qinv_Phi: torch.Tensor   # Phi' Q^-1 Phi
    logdet_Sigma0: torch.Tensor
    logdet_Q: torch.Tensor
    logdet_R: torch.Tensor


class CaviState(NamedTuple):
    X_mean: torch.Tensor  # (n, T, d)
    X_cov: torch.Tensor   # (n, T, d, d)


class FitResult(NamedTuple):
    X_mean: torch.Tensor         # (n, T, d)
    X_cov: torch.Tensor          # (n, T, d, d)
    elbo_history: torch.Tensor   # (buf,) on the CPU, NaN past the stop
    mse_history: torch.Tensor    # (buf,)
    n_iter: int
    converged: bool
    diverged: bool               # ELBO went non-finite; fit halted
    last_elbo: float             # convergence carry for a follow-up fit
    pat_count: int


def state_from_numpy(s, device=None, dtype=torch.float32) -> CaviState:
    """Port's :class:`CaviState` from any object (or dict) holding
    ``X_mean``/``X_cov`` arrays (e.g. the JAX ``CaviState``)."""
    return CaviState(**_fields_as_tensors(s, CaviState._fields, device,
                                          dtype))


def precompute_obs_constants(Y: torch.Tensor, R_inv: torch.Tensor,
                             w_dtype=None) -> ObsConstants:
    """Dyad weights and their row sums; constant across CAVI iterations.
    ``w_dtype=torch.bfloat16`` stores the (n, n, T) weights in bf16; the
    row sums are taken before the rounding and stay float32."""
    p, q = R_inv[0, 0], R_inv[0, 1]
    W0 = p * Y[..., 0] + q * Y[..., 1]
    W1 = q * Y[..., 0] + p * Y[..., 1]
    eta_a, eta_b = W0.sum(1), W1.sum(1)
    if w_dtype is not None:
        W0, W1 = W0.to(w_dtype), W1.to(w_dtype)
    return ObsConstants(W0=W0, W1=W1, eta_a=eta_a, eta_b=eta_b)


def _eta_contract(W: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """``einsum("ijt,jtr->itr")``: the engine's dominant contraction,
    float32 out.

    float32 ``W``: a float32 product.  bf16 ``W`` (mixed precision, or a
    bf16 mask): ``Z`` is rounded to bf16 and the products are summed in
    float32, as the JAX package's ``preferred_element_type=float32``.  On
    the card that is one ``bmm`` with ``out_dtype=float32`` on the (t, i,
    j) view; the CPU has no such overload, so there the bf16 values are
    widened to float32 (each product of two bf16 values is exact in f32).
    """
    if W.dtype != torch.bfloat16:
        return torch.einsum("ijt,jtr->itr", W, Z)
    Zb = Z.to(torch.bfloat16)
    if W.is_cuda:
        return torch.bmm(W.permute(2, 0, 1), Zb.transpose(0, 1),
                         out_dtype=torch.float32).transpose(0, 1)
    return torch.einsum("ijt,jtr->itr", W.float(), Zb.float())


def precompute_priors(params: AMEParams) -> PriorMatrices:
    # each linalg.inv checks its result on the host
    profiling.count_syncs(params.Q, 2)
    Q_inv = torch.linalg.inv(params.Q)
    return PriorMatrices(
        Sigma0_inv=torch.linalg.inv(params.Sigma0),
        Q_inv=Q_inv,
        Qinv_Phi=Q_inv @ params.Phi,
        PhiT_Qinv_Phi=params.Phi.T @ Q_inv @ params.Phi,
        logdet_Sigma0=torch.linalg.slogdet(params.Sigma0)[1],
        logdet_Q=torch.linalg.slogdet(params.Q)[1],
        logdet_R=torch.linalg.slogdet(params.R)[1],
    )


# ---------------------------------------------------------------------------
# Sufficient-statistics diagnostics
# ---------------------------------------------------------------------------

class DiagConstants(NamedTuple):
    """Data statistics for the sufficient-statistics diagnostics path."""

    sum_y0_sq: torch.Tensor    # scalar  sum_{ij,t} y0^2       (diag(Y) = 0)
    sum_y0_y0T: torch.Tensor   # scalar  sum_{ij,t} y0_ij y0_ji
    row_y0: torch.Tensor       # (n, T)  sum_j y0_ij
    col_y0: torch.Tensor       # (n, T)  sum_i y0_ij


def precompute_diag_constants(Y: torch.Tensor) -> DiagConstants:
    y0 = Y[..., 0]
    return DiagConstants(sum_y0_sq=torch.sum(y0 * y0),
                         sum_y0_y0T=torch.sum(y0 * y0.transpose(0, 1)),
                         row_y0=y0.sum(1), col_y0=y0.sum(0))


def _data_mean_cross_terms(obs: ObsConstants, U: torch.Tensor,
                           V: torch.Tensor, R_inv: torch.Tensor,
                           rows=slice(None)):
    """Data-mean cross terms ``A = sum y0_ij u_ij`` and ``B = sum y0_ij
    u_ji`` (``u_ij = U_i . V_j``) from one pass over W0: reciprocity makes
    ``W1 = W0'``, so ``s1 = sum U . (W0 V) = p A + q B`` and ``s3 = sum V
    . (W0 U) = q A + p B`` ride one contraction against ``[V | U]``.
    ``obs`` may hold only the rows ``rows`` of the weights (a rank's):
    the terms are then those rows' share of the sums."""
    p, q = R_inv[0, 0], R_inv[0, 1]
    r = U.shape[-1]
    out = _eta_contract(obs.W0, torch.cat([V, U], -1))
    s1 = torch.sum(U[rows] * out[..., :r])
    s3 = torch.sum(V[rows] * out[..., r:])
    denom = p * p - q * q
    return (p * s1 - q * s3) / denom, (p * s3 - q * s1) / denom


def _residual_stats_from_moments(dc: DiagConstants, obs: ObsConstants,
                                 X_mean: torch.Tensor, r: int,
                                 R_inv: torch.Tensor, rows=slice(None),
                                 model_terms: bool = True):
    """``(sum_offdiag e0^2, sum_offdiag e0_ij e0_ji)`` with ``e0 = y0 -
    m``, ``m_ij = a_i + b_j + U_i . V_j``, expanded into data constants and
    global moments of the means: one W0 contraction
    (:func:`_data_mean_cross_terms`) and O(n T r^2) work, no O(n^2 T)
    pass (the JAX function's algebra).

    Under a mesh ``dc`` and ``obs`` hold the rows ``rows`` of a rank and
    the data terms are their share; the model-side moments are functions
    of the replicated means alone, so exactly one rank per time slice
    adds them (``model_terms``), lest the mesh count them once a rank."""
    a, b, U, V = dyad_ops.split_state(X_mean, r)
    A, B = _data_mean_cross_terms(obs, U, V, R_inv, rows)
    y_ab = torch.sum(a[rows] * dc.row_y0) + torch.sum(b[rows] * dc.col_y0)
    y_abT = torch.sum(a[rows] * dc.col_y0) + torch.sum(b[rows] * dc.row_y0)
    sq = dc.sum_y0_sq - 2.0 * (y_ab + A)
    cross = dc.sum_y0_y0T - 2.0 * (y_abT + B)
    if not model_terms:
        return sq, cross
    n = a.shape[0]
    alpha, beta = a.sum(0), b.sum(0)                       # (T,)
    Sa2, Sb2, Sab = (a * a).sum(0), (b * b).sum(0), (a * b).sum(0)
    sU, sV = U.sum(0), V.sum(0)                            # (T, r)
    wU = torch.einsum("it,itr->tr", a, U)
    wV = torch.einsum("it,itr->tr", a, V)
    zU = torch.einsum("it,itr->tr", b, U)
    zV = torch.einsum("it,itr->tr", b, V)
    GUU, GVV, GVU = _gram(U, U), _gram(V, V), _gram(V, U)
    m_ii = a + b + torch.sum(U * V, -1)
    Smii2 = torch.sum(m_ii * m_ii)

    sum_ab_sq = torch.sum(n * (Sa2 + Sb2) + 2.0 * alpha * beta)
    cross_m = torch.sum(wU * sV) + torch.sum(zV * sU)
    sum_m_sq = sum_ab_sq + 2.0 * cross_m + torch.sum(GUU * GVV) - Smii2
    sum_ab_cross = torch.sum(alpha * alpha + beta * beta + 2.0 * n * Sab)
    cross_mT = torch.sum(wV * sU) + torch.sum(zU * sV)
    SuuT = torch.sum(GVU * GVU.transpose(-1, -2))
    sum_m_mT = sum_ab_cross + 2.0 * cross_mT + SuuT - Smii2
    return sq + sum_m_sq, cross + sum_m_mT


def _masked_residual_stats(dc: DiagConstants, obs: ObsConstants,
                           X_mean: torch.Tensor, r: int, R_inv: torch.Tensor,
                           mask, rows=slice(None)):
    """Masked counterpart of :func:`_residual_stats_from_moments`: the
    residual statistics over OBSERVED dyads.  With ``Y`` zeroed at masked
    entries the data-side terms are as dense; the model-side moments
    become one mask contraction against a (4 + 5r + 2r^2)-column feature
    panel, ``sum_j M_ij f(i) . g(j) = f(i) . (M g)_i``.  Every term is a
    sum over rows i, so ``dc``, ``obs`` and ``mask`` may hold only the
    rows ``rows`` (a rank's): the statistics are then their share.

    CONTRACT: ``mask`` is symmetric (the cross-term re-summation uses it).
    """
    a_all, b_all, U_all, V = dyad_ops.split_state(X_mean, r)
    n, T = a_all.shape
    A, B = _data_mean_cross_terms(obs, U_all, V, R_inv, rows)
    a, b, U = a_all[rows], b_all[rows], U_all[rows]
    m = a.shape[0]
    y_ab = torch.sum(a * dc.row_y0) + torch.sum(b * dc.col_y0)
    y_abT = torch.sum(a * dc.col_y0) + torch.sum(b * dc.row_y0)

    VV = _outer(V, V).reshape(n, T, r * r)
    OVU = _outer(V, U_all).reshape(n, T, r * r)
    a1, b1 = a_all[..., None], b_all[..., None]
    Z = torch.cat([torch.ones_like(a1), a1, b1, b1 * b1, U_all, V, a1 * V,
                   b1 * V, b1 * U_all, VV, OVU], -1)       # (n, T, K)
    C = _mask_contract(mask, Z)                           # (m, T, K)
    cnt, Ma, Mb, Mb2 = C[..., 0], C[..., 1], C[..., 2], C[..., 3]
    MU, MV, MaV, MbV, MbU = C[..., 4:4 + 5 * r].split(r, -1)
    MVV, MOVU = C[..., 4 + 5 * r:].split(r * r, -1)

    UUo = _outer(U, U).reshape(m, T, r * r)
    OUV = _outer(U, V[rows]).reshape(m, T, r * r)
    U_MV = torch.sum(U * MV, -1)
    sum_m_sq = torch.sum(a * a * cnt + 2.0 * a * Mb + Mb2 + 2.0 * a * U_MV
                         + 2.0 * torch.sum(U * MbV, -1)
                         + torch.sum(UUo * MVV, -1))
    sum_m_mT = torch.sum(a * Ma + 2.0 * a * b * cnt + b * Mb
                         + a * torch.sum(V[rows] * MU, -1)
                         + torch.sum(V[rows] * MbU, -1)
                         + torch.sum(U * MaV, -1)
                         + b * U_MV + torch.sum(OUV * MOVU, -1))
    sq = dc.sum_y0_sq - 2.0 * (y_ab + A) + sum_m_sq
    cross = dc.sum_y0_y0T - 2.0 * (y_abT + B) + sum_m_mT
    return sq, cross


# ---------------------------------------------------------------------------
# Masked contractions
# ---------------------------------------------------------------------------

class PackedMask(NamedTuple):
    """Observation mask in K5's int8 layout
    (:func:`tame_torch.ops.masked_contract.pack_mask`): ``blocks`` is
    ``(num_blocks, T, bs_pad, n_pad) int8``, rows block-major."""

    blocks: torch.Tensor


class PackedRows(NamedTuple):
    """Mask rows in K5's int8 layout as stripes of any lengths
    (:func:`tame_torch.ops.masked_contract.pack_rows`) whose rows, in
    order, are the rows a contraction returns: under a mesh, a rank's
    share of each phase."""

    stripes: list


def _packed_contract_all(pm: PackedMask, Z: torch.Tensor) -> torch.Tensor:
    """Full-mask partner contraction through K5: every block stripe,
    concatenated back to node order.  Z: (n, T, K)."""
    nb = pm.blocks.shape[0]
    bs = Z.shape[0] // nb
    return torch.cat([masked_contract.packed_rows_contract(pm.blocks[k],
                                                           Z)[:bs]
                      for k in range(nb)])


def _mask_contract(mask, Z: torch.Tensor) -> torch.Tensor:
    """Masked partner contraction ``(m, T, K)``: a dense (m, n, T) mask
    through :func:`_eta_contract`, a :class:`PackedMask` or the stripes of
    a :class:`PackedRows` through K5."""
    if isinstance(mask, PackedMask):
        return _packed_contract_all(mask, Z)
    if isinstance(mask, PackedRows):
        return torch.cat([masked_contract.packed_rows_contract(s, Z)
                          [:s.shape[1]] for s in mask.stripes if s.shape[1]])
    return _eta_contract(mask, Z)


def make_block_mask_contract(mask, bs: int):
    """Closure contracting block ``b``'s mask rows against a feature panel
    (``(bs, T, K)``): one K5 stripe for a :class:`PackedMask`, rows
    ``b*bs:(b+1)*bs`` of a dense (n, n, T) mask otherwise.  Shared by the
    CAVI and smoothed block steps."""
    def contract(b: int, Z: torch.Tensor) -> torch.Tensor:
        if isinstance(mask, PackedMask):
            return masked_contract.packed_rows_contract(mask.blocks[b],
                                                        Z)[:bs]
        return _eta_contract(mask[b * bs:(b + 1) * bs], Z)
    return contract


# ---------------------------------------------------------------------------
# Observation-term assembly
# ---------------------------------------------------------------------------

def _gram(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``sum_j A_j B_j'`` per time step: (n, T, r) x (n, T, r) -> (T, r, r)."""
    return torch.einsum("jtk,jtl->tkl", A, B)


def _outer(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A[..., :, None] * B[..., None, :]


def _P_from_partner_stats(cnt, sU, sV, GUU, GVV, GVU,
                          R_inv: torch.Tensor) -> torch.Tensor:
    """Assemble the observation precision (m, T, d, d) from partner
    statistics — the one place the d x d slot layout lives."""
    m, T, r = sU.shape
    d = 2 + 2 * r
    p, q = R_inv[0, 0], R_inv[0, 1]
    P = sU.new_zeros((m, T, d, d))
    P[..., 0, 0] = p * cnt
    P[..., 1, 1] = p * cnt
    P[..., 0, 1] = q * cnt
    P[..., 1, 0] = q * cnt
    P[..., 0, 2:2 + r] = P[..., 2:2 + r, 0] = p * sV
    P[..., 0, 2 + r:] = P[..., 2 + r:, 0] = q * sU
    P[..., 1, 2:2 + r] = P[..., 2:2 + r, 1] = q * sV
    P[..., 1, 2 + r:] = P[..., 2 + r:, 1] = p * sU
    P[..., 2:2 + r, 2:2 + r] = p * GVV
    P[..., 2 + r:, 2 + r:] = p * GUU
    P[..., 2:2 + r, 2 + r:] = q * GVU
    P[..., 2 + r:, 2:2 + r] = q * GVU.transpose(-1, -2)
    return P


def _obs_precision(U: torch.Tensor, V: torch.Tensor,
                   R_inv: torch.Tensor) -> torch.Tensor:
    """Observation precision ``sum_{j != i} J' R^-1 J`` for every (i, t):
    U, V (n, T, r) -> (n, T, d, d)."""
    n = U.shape[0]
    sU = U.sum(0)[None] - U
    sV = V.sum(0)[None] - V
    GUU = _gram(U, U)[None] - _outer(U, U)
    GVV = _gram(V, V)[None] - _outer(V, V)
    GVU = _gram(V, U)[None] - _outer(V, U)
    return _P_from_partner_stats(float(n - 1), sU, sV, GUU, GVV, GVU, R_inv)


def _masked_panel(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """The (n, T, 1 + 2r + 3r^2) feature panel whose masked partner sums
    assemble the observation precision: ones (counts), U, V and the
    outer-product columns UU, VV, VU — one concatenated contraction, so
    the mask is read once per phase."""
    n, T, r = U.shape
    return torch.cat([torch.ones_like(U[..., :1]), U, V,
                      _outer(U, U).reshape(n, T, r * r),
                      _outer(V, V).reshape(n, T, r * r),
                      _outer(V, U).reshape(n, T, r * r)], -1)


def _masked_P_from_C(C: torch.Tensor, R_inv: torch.Tensor,
                     r: int) -> torch.Tensor:
    """Masked observation precision from the contracted panel ``C = mask @
    _masked_panel(U, V)``."""
    m, T = C.shape[:2]
    sU, sV = C[..., 1:1 + r], C[..., 1 + r:1 + 2 * r]
    GUU, GVV, GVU = (G.reshape(m, T, r, r)
                     for G in C[..., 1 + 2 * r:].split(r * r, -1))
    return _P_from_partner_stats(C[..., 0], sU, sV, GUU, GVV, GVU, R_inv)


def _masked_obs_precision(Mr, U: torch.Tensor, V: torch.Tensor,
                          R_inv: torch.Tensor) -> torch.Tensor:
    """Observation precision ``sum_{j observed} J' R^-1 J`` under a dyad
    mask: per-node masked counts, partner sums and partner Grams from one
    panel contraction of ``Mr`` ((m, n, T) mask rows, 1 = observed, zero
    diagonal, or a full-mask :class:`PackedMask`) -> (m, T, d, d)."""
    C = _mask_contract(Mr, _masked_panel(U, V))
    return _masked_P_from_C(C, R_inv, U.shape[-1])


def _offset_panel(c: torch.Tensor, dd: torch.Tensor, U: torch.Tensor,
                  V: torch.Tensor) -> torch.Tensor:
    """``[c, dd, c V, dd U]``: the panel whose masked partner sums are the
    corrected natural parameter's offset terms."""
    return torch.cat([c[..., None], dd[..., None], c[..., None] * V,
                      dd[..., None] * U], -1)


def _obs_nat_param(obs: ObsConstants, X_mean: torch.Tensor, r: int,
                   R_inv: torch.Tensor, corrected: bool,
                   mask=None) -> torch.Tensor:
    """Observation natural parameter for every (i, t): (n, T, d).

    ``corrected=False`` reproduces the reference's simplification (the other
    node's additive offsets are not subtracted from ``y``);
    ``corrected=True`` subtracts them — the exact coordinate update; under
    a ``mask`` the offset sums run over observed partners only (one mask
    pass).  The dyad weights in ``obs`` must have been masked.
    """
    a, b, U, V = dyad_ops.split_state(X_mean, r)
    eta_a, eta_b = obs.eta_a, obs.eta_b
    etaU = _eta_contract(obs.W0, V)
    etaV = _eta_contract(obs.W1, U)
    if corrected:
        p, q = R_inv[0, 0], R_inv[0, 1]
        c = p * b + q * a
        dd = q * b + p * a
        if mask is not None:
            C = _mask_contract(mask, _offset_panel(c, dd, U, V))
            eta_a = eta_a - C[..., 0]
            eta_b = eta_b - C[..., 1]
            etaU = etaU - C[..., 2:2 + r]
            etaV = etaV - C[..., 2 + r:]
        else:
            eta_a = eta_a - (c.sum(0)[None] - c)
            eta_b = eta_b - (dd.sum(0)[None] - dd)
            etaU = etaU - (torch.einsum("jt,jtr->tr", c, V)[None]
                           - c[..., None] * V)
            etaV = etaV - (torch.einsum("jt,jtr->tr", dd, U)[None]
                           - dd[..., None] * U)
    return torch.cat([eta_a[..., None], eta_b[..., None], etaU, etaV], -1)


def _prior_precision(pri: PriorMatrices, T: int) -> torch.Tensor:
    """Time-indexed prior precision terms: (T, d, d)."""
    t = torch.arange(T, device=pri.Q_inv.device)
    is0 = (t == 0)[:, None, None]
    has_prev = (t > 0)[:, None, None]
    has_next = (t < T - 1)[:, None, None]
    return (is0 * pri.Sigma0_inv + has_prev * pri.Q_inv
            + has_next * pri.PhiT_Qinv_Phi)


def _prior_nat_param(pri: PriorMatrices, X_mean: torch.Tensor) -> torch.Tensor:
    """Neighbor-mean coupling terms of the natural parameter: (n, T, d)."""
    T = X_mean.shape[1]
    zero = X_mean.new_zeros(X_mean[:, :1].shape)
    mu_prev = torch.cat([zero, X_mean[:, :-1]], 1)
    mu_next = torch.cat([X_mean[:, 1:], zero], 1)
    t = torch.arange(T, device=X_mean.device)
    has_prev = (t > 0)[None, :, None]
    has_next = (t < T - 1)[None, :, None]
    eta_prev = mu_prev @ pri.Qinv_Phi.T
    eta_next = mu_next @ pri.Qinv_Phi
    return has_prev * eta_prev + has_next * eta_next


# ---------------------------------------------------------------------------
# Structure policies
# ---------------------------------------------------------------------------

def _solve_diag(P: torch.Tensor, eta: torch.Tensor):
    """Naive-MF policy: full-precision mean solve, diagonal variances
    ``1 / (diag(P) + 1e-8)``."""
    mu = batched_spd_solve(P, eta)
    var = 1.0 / (torch.diagonal(P, dim1=-2, dim2=-1) + 1e-8)
    return mu, torch.diag_embed(var)


def _finalize_cov(cov: torch.Tensor) -> torch.Tensor:
    """Symmetrize + jitter."""
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    return cov + 1e-6 * torch.eye(cov.shape[-1], dtype=cov.dtype,
                                  device=cov.device)


def _solve_full(P: torch.Tensor, eta: torch.Tensor):
    """Good-SMF policy: Sigma = P^-1, mean from the projected covariance."""
    _, cov_raw = batched_spd_solve_inv(P, eta)
    cov = _finalize_cov(cov_raw)
    return (cov @ eta[..., None])[..., 0], cov


def _solve_block(P: torch.Tensor, eta: torch.Tensor):
    """Bad-SMF policy: invert, zero the additive x multiplicative cross
    blocks post-inversion, then symmetrize/jitter; mean from the truncated
    covariance."""
    _, cov_raw = batched_spd_solve_inv(P, eta)
    d = P.shape[-1]
    cross = torch.zeros(d, d, dtype=torch.bool, device=P.device)
    cross[:2, 2:] = True
    cross[2:, :2] = True
    cov = _finalize_cov(cov_raw.masked_fill(cross, 0.0))
    return (cov @ eta[..., None])[..., 0], cov


_SOLVERS = {"diag": _solve_diag, "full": _solve_full, "block": _solve_block}


# ---------------------------------------------------------------------------
# ELBO
# ---------------------------------------------------------------------------

def gated_mask(mask, Y: torch.Tensor) -> torch.Tensor:
    """An (n, n, T) observation mask as a tensor of ``Y``'s type and
    device, its diagonal zeroed (every masked entry point gates it so)."""
    mask = torch.as_tensor(mask, dtype=Y.dtype, device=Y.device)
    return mask * dyad_ops.offdiag_mask(Y.shape[0], Y.dtype,
                                        Y.device)[:, :, None]


def _observed(Y: torch.Tensor, obs_mask: torch.Tensor):
    """``(m, Y)``: the gated mask and ``Y`` with every unobserved entry
    replaced by 0 through ``where``, so NaN-coded missing entries are
    never read (0 * NaN would be NaN)."""
    m = gated_mask(obs_mask, Y)
    return m, torch.where(m[..., None] > 0, Y, torch.zeros((), dtype=Y.dtype,
                                                           device=Y.device))


def _mask_stats(mask: torch.Tensor):
    """``(observed unordered dyad-times, observed partners per (node,
    time))`` of a zero-diagonal symmetric mask."""
    return 0.5 * torch.sum(mask), mask.float().sum(1)


def compute_elbo(Y: torch.Tensor, params: AMEParams, pri: PriorMatrices,
                 state: CaviState, structure: str,
                 mu_dyadic: Optional[torch.Tensor] = None,
                 obs_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ELBO with the reference's exact term structure (plug-in likelihood
    at the means, the structured policies' trace correction, Gaussian
    priors with trace terms, Gaussian entropy); under ``obs_mask`` the
    likelihood runs over observed dyads only.

    ``Y`` and ``state`` sharded over a mesh (a sharded fit's result, or
    :func:`tame_torch.parallel.shard_fit_inputs`; ``obs_mask`` the whole
    mask) sum each rank's rows
    (:func:`tame_torch.parallel.sharded_cavi.compute_elbo_sharded`);
    ``mu_dyadic`` is then computed on the rows and may not be passed."""
    if _sharded(Y, state):
        from tame_torch.parallel.sharded_cavi import compute_elbo_sharded

        refuse_mu_dyadic(mu_dyadic)
        return compute_elbo_sharded(Y, params, pri, state, structure,
                                    obs_mask)
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    if obs_mask is None:
        m = dyad_ops.offdiag_mask(n, Y.dtype, Y.device)[:, :, None]
        mask_stats = None
    else:
        m, Y = _observed(Y, obs_mask)
        mask_stats = _mask_stats(m)
    if mu_dyadic is None:
        mu_dyadic = dyad_ops.dyadic_mean_temporal(state.X_mean, r)
    resid = Y - mu_dyadic
    p_, q_ = params.R_inv[0, 0], params.R_inv[0, 1]
    e0, e1 = resid[..., 0], resid[..., 1]
    quad = p_ * (e0 * e0 + e1 * e1) + 2.0 * q_ * (e0 * e1)
    quad_sum = 0.5 * torch.sum(quad * m)
    return _elbo_from_quad(quad_sum, params, pri, state, structure,
                           mask_stats=mask_stats)


def state_prior_terms(params: AMEParams, pri: PriorMatrices,
                      state: CaviState):
    """Expected initial-state and transition log-prior terms
    ``(prior0, priort)``."""
    n, T, d = state.X_mean.shape
    mu0 = state.X_mean[:, 0]
    quad0 = torch.einsum("ia,ab,ib->i", mu0, pri.Sigma0_inv, mu0)
    trace0 = torch.einsum("ab,iba->i", pri.Sigma0_inv, state.X_cov[:, 0])
    prior0 = -0.5 * torch.sum(quad0 + trace0 + pri.logdet_Sigma0
                              + d * _LOG2PI)
    if T == 1:
        return prior0, torch.zeros((), dtype=prior0.dtype,
                                   device=prior0.device)
    residt = state.X_mean[:, 1:] - state.X_mean[:, :-1] @ params.Phi.T
    quadt = torch.einsum("ita,ab,itb->it", residt, pri.Q_inv, residt)
    tracet = torch.einsum("ab,itba->it", pri.Q_inv, state.X_cov[:, 1:])
    priort = -0.5 * torch.sum(quadt + tracet + pri.logdet_Q + d * _LOG2PI)
    return prior0, priort


def gaussian_entropy(state: CaviState) -> torch.Tensor:
    """Entropy of the per-(node, time) Gaussian factors."""
    d = state.X_mean.shape[-1]
    logdets = batched_logdet_spd(state.X_cov)
    return 0.5 * torch.sum(logdets + d * (1.0 + _LOG2PI))


def _elbo_from_quad(quad_sum: torch.Tensor, params: AMEParams,
                    pri: PriorMatrices, state: CaviState,
                    structure: str, mask_stats=None) -> torch.Tensor:
    """ELBO given ``sum_{i<j,t} resid' R^-1 resid``; every other term
    depends only on the variational state.  ``mask_stats``
    (:func:`_mask_stats`) restricts the likelihood normalization and the
    structured trace correction to observed dyads."""
    n, T, d = state.X_mean.shape
    n_dyads = (n * (n - 1) // 2 * T if mask_stats is None
               else mask_stats[0])
    wsum = None
    if structure in ("full", "block"):
        tr_cov = torch.diagonal(state.X_cov, dim1=-2, dim2=-1).sum(-1)
        # sum_{i<j observed} (tr S_i + tr S_j) = sum_i cnt_i tr S_i
        wsum = ((n - 1) * torch.sum(tr_cov) if mask_stats is None
                else torch.sum(mask_stats[1] * tr_cov))
    prior0, priort = state_prior_terms(params, pri, state)
    return elbo_from_terms(quad_sum, n_dyads, wsum, prior0, priort,
                           gaussian_entropy(state), params, pri, d)


def elbo_from_terms(quad_sum, n_dyads, wsum, prior0, priort, entropy,
                    params: AMEParams, pri: PriorMatrices,
                    d: int) -> torch.Tensor:
    """The ELBO from its sums: the likelihood's quadratic form over
    ``n_dyads`` dyad-times, the structured trace correction's weighted
    covariance trace ``wsum`` (None for the naive policy), the prior terms
    and the entropy (a sharded fit all-reduces these first)."""
    log_lik = -0.5 * (quad_sum + n_dyads * (pri.logdet_R + 2.0 * _LOG2PI))
    if wsum is not None:
        trR = params.R_inv[0, 0] + params.R_inv[1, 1]
        log_lik = log_lik - 0.5 * (0.1 * trR / d * wsum)
    return log_lik + prior0 + priort + entropy


# ---------------------------------------------------------------------------
# One CAVI step
# ---------------------------------------------------------------------------

def cavi_step_jacobi(state: CaviState, obs: ObsConstants, pri: PriorMatrices,
                     params: AMEParams, structure: str, lr: float,
                     corrected: bool = False, mask=None) -> CaviState:
    """Simultaneous (Jacobi) update of every q(X_i^t) factor under the
    damped update ``new = lr * closed_form + (1 - lr) * old``.  ``mask``
    ((n, n, T), symmetric, zero diagonal, or a :class:`PackedMask`)
    restricts the observation terms to observed dyads; the weights in
    ``obs`` must have been masked."""
    n, T, d = state.X_mean.shape
    r = (d - 2) // 2
    _, _, U, V = dyad_ops.split_state(state.X_mean, r)
    P_obs = (_obs_precision(U, V, params.R_inv) if mask is None
             else _masked_obs_precision(mask, U, V, params.R_inv))
    P = P_obs + _prior_precision(pri, T)[None]
    eta = (_obs_nat_param(obs, state.X_mean, r, params.R_inv, corrected,
                          mask=mask)
           + _prior_nat_param(pri, state.X_mean))
    mu_new, cov_new = _SOLVERS[structure](P, eta)
    return CaviState(X_mean=lr * mu_new + (1.0 - lr) * state.X_mean,
                     X_cov=lr * cov_new + (1.0 - lr) * state.X_cov)


def _block_obs_terms(X_mean: torch.Tensor, obs: ObsConstants,
                     R_inv: torch.Tensor, blk: int, bs: int, corrected: bool,
                     contract=None):
    """Observation precision (bs, T, d, d) and natural parameter (bs, T, d)
    of node block ``blk``, from fresh statistics of ``X_mean``: global
    ones (O(n T r^2) besides the two ``W @ Z`` contractions), or masked
    partner sums through ``contract`` (:func:`make_block_mask_contract`),
    one mask pass for the precision and one for the corrected offsets."""
    sl = slice(blk * bs, (blk + 1) * bs)
    return rows_obs_terms(
        X_mean, sl, obs.W0[sl], obs.W1[sl], obs.eta_a[sl], obs.eta_b[sl],
        R_inv, corrected,
        None if contract is None else lambda Z: contract(blk, Z))


def rows_obs_terms(X_mean: torch.Tensor, sl: slice, W0: torch.Tensor,
                   W1: torch.Tensor, eta_a: torch.Tensor, eta_b: torch.Tensor,
                   R_inv: torch.Tensor, corrected: bool, contract=None):
    """Observation precision (m, T, d, d) and natural parameter (m, T, d)
    of the m nodes ``X_mean[sl]``, given their rows ``W0``/``W1`` (m, n,
    T) of the dyad weights and the weights' row sums: :func:`_block_obs_terms`
    for any slice of rows (a rank's share of a block under a mesh), the
    masked partner sums through the one-argument ``contract``."""
    n, T, d = X_mean.shape
    r = (d - 2) // 2
    p, q = R_inv[0, 0], R_inv[0, 1]
    a_all, b_all, U, V = dyad_ops.split_state(X_mean, r)
    Ub, Vb = U[sl], V[sl]
    if contract is not None:
        P = _masked_P_from_C(contract(_masked_panel(U, V)), R_inv, r)
    else:
        sU = U.sum(0)[None] - Ub
        sV = V.sum(0)[None] - Vb
        GUU = _gram(U, U)[None] - _outer(Ub, Ub)
        GVV = _gram(V, V)[None] - _outer(Vb, Vb)
        GVU = _gram(V, U)[None] - _outer(Vb, Ub)
        P = _P_from_partner_stats(float(n - 1), sU, sV, GUU, GVV, GVU, R_inv)

    etaU = _eta_contract(W0, V)
    etaV = _eta_contract(W1, U)
    if corrected:
        cc = p * b_all + q * a_all
        ddc = q * b_all + p * a_all
        if contract is not None:
            C = contract(_offset_panel(cc, ddc, U, V))
            eta_a = eta_a - C[..., 0]
            eta_b = eta_b - C[..., 1]
            etaU = etaU - C[..., 2:2 + r]
            etaV = etaV - C[..., 2 + r:]
        else:
            cb, db = cc[sl], ddc[sl]
            eta_a = eta_a - (cc.sum(0)[None] - cb)
            eta_b = eta_b - (ddc.sum(0)[None] - db)
            etaU = etaU - (torch.einsum("jt,jtr->tr", cc, V)[None]
                           - cb[..., None] * Vb)
            etaV = etaV - (torch.einsum("jt,jtr->tr", ddc, U)[None]
                           - db[..., None] * Ub)
    eta = torch.cat([eta_a[..., None], eta_b[..., None], etaU, etaV], -1)
    return P, eta


def _block_mask_contract(mask, num_blocks: int, bs: int):
    """:func:`make_block_mask_contract` for a block step, or None without
    a mask; a :class:`PackedMask` must be packed with ``num_blocks``."""
    if mask is None:
        return None
    if isinstance(mask, PackedMask) and mask.blocks.shape[0] != num_blocks:
        raise ValueError("PackedMask block count must match num_blocks")
    return make_block_mask_contract(mask, bs)


def cavi_step_block(state: CaviState, obs: ObsConstants, pri: PriorMatrices,
                    params: AMEParams, structure: str, lr: float,
                    num_blocks: int, corrected: bool = False,
                    mask=None) -> CaviState:
    """Block Gauss-Seidel: nodes split into ``num_blocks`` groups updated in
    sequence, each group reading the freshest global state; all (node,
    time) factors within a group update simultaneously.  ``mask`` as in
    :func:`cavi_step_jacobi` (a :class:`PackedMask` packed with
    ``num_blocks``).

    Works on a copy of ``state`` and updates it block by block in place.
    """
    n, T, d = state.X_mean.shape
    if n % num_blocks != 0:
        raise ValueError(f"num_blocks={num_blocks} must divide n={n}")
    bs = n // num_blocks
    solver = _SOLVERS[structure]
    prior_P = _prior_precision(pri, T)[None]
    contract = _block_mask_contract(mask, num_blocks, bs)
    X_mean, X_cov = state.X_mean.clone(), state.X_cov.clone()

    for blk in range(num_blocks):
        sl = slice(blk * bs, (blk + 1) * bs)
        P, eta = _block_obs_terms(X_mean, obs, params.R_inv, blk, bs,
                                  corrected, contract)
        eta = eta + _prior_nat_param(pri, X_mean[sl])
        mu_new, cov_new = solver(P + prior_P, eta)
        X_mean[sl] = lr * mu_new + (1.0 - lr) * X_mean[sl]
        X_cov[sl] = lr * cov_new + (1.0 - lr) * X_cov[sl]
    return CaviState(X_mean=X_mean, X_cov=X_cov)


def node_obs_eta(obs: ObsConstants, i: int, U: torch.Tensor,
                 V: torch.Tensor) -> torch.Tensor:
    """Node ``i``'s (T, d) observation natural parameter from row ``i`` of
    ``obs`` and the partners' means ``U``, ``V`` (n, T, r)."""
    return torch.cat([obs.eta_a[i][:, None], obs.eta_b[i][:, None],
                      torch.einsum("jt,jtr->tr", obs.W0[i], V),
                      torch.einsum("jt,jtr->tr", obs.W1[i], U)], -1)


def seq_sweep(X_mean: torch.Tensor, pri: PriorMatrices, params: AMEParams,
              structure: str, lr: float, node_eta, keep_cov) -> None:
    """The seq sweep on the means ``X_mean``, in place: nodes in order,
    times in order within a node.  ``node_eta(i, U, V)`` gives node i's
    (T, d) observation natural parameter from the state as it stands
    before node i; step t then adds the prior coupling to the just-updated
    step t-1 and the not yet updated step t+1 and solves (one K1 launch
    each on the card); ``keep_cov(i, t, cov)`` takes the new covariance."""
    n, T, d = X_mean.shape
    r = (d - 2) // 2
    solver = _SOLVERS[structure]
    prior_P = _prior_precision(pri, T)                        # (T, d, d)
    for i in range(n):
        _, _, U, V = dyad_ops.split_state(X_mean, r)
        Ui, Vi = U[i], V[i]                                   # (T, r)
        P = _P_from_partner_stats(
            float(n - 1), (U.sum(0) - Ui)[None], (V.sum(0) - Vi)[None],
            (_gram(U, U) - _outer(Ui, Ui))[None],
            (_gram(V, V) - _outer(Vi, Vi))[None],
            (_gram(V, U) - _outer(Vi, Ui))[None], params.R_inv)[0] + prior_P
        eta_obs = node_eta(i, U, V)
        for t in range(T):
            eta = eta_obs[t]
            if t > 0:
                eta = eta + X_mean[i, t - 1] @ pri.Qinv_Phi.T
            if t < T - 1:
                eta = eta + X_mean[i, t + 1] @ pri.Qinv_Phi
            mu_new, cov_new = solver(P[t], eta)
            X_mean[i, t] = lr * mu_new + (1.0 - lr) * X_mean[i, t]
            keep_cov(i, t, cov_new)


def cavi_step_seq(state: CaviState, obs: ObsConstants, pri: PriorMatrices,
                  params: AMEParams, structure: str, lr: float) -> CaviState:
    """Gauss-Seidel sweep in the reference's order (:func:`seq_sweep`),
    each update reading the freshest means, so the n T solves run one at
    a time.  Works on a copy of ``state``, updated in place."""
    X_mean, X_cov = state.X_mean.clone(), state.X_cov.clone()

    def keep_cov(i, t, cov_new):
        X_cov[i, t] = lr * cov_new + (1.0 - lr) * X_cov[i, t]

    seq_sweep(X_mean, pri, params, structure, lr,
              lambda i, U, V: node_obs_eta(obs, i, U, V), keep_cov)
    return CaviState(X_mean=X_mean, X_cov=X_cov)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def init_state(generator: torch.Generator, n: int, T: int, d: int,
               structure: str, init_scale: float, cov_init_scale: float,
               device=None) -> CaviState:
    """Variational-parameter initialization per structure (the JAX
    package's scheme; draws from ``generator`` on its device, then moves
    to ``device``)."""
    gdev = generator.device
    X_mean = torch.randn(n, T, d, generator=generator, device=gdev) * init_scale
    eye = torch.eye(d, device=gdev)
    if structure == "diag":
        X_cov = (eye * 0.5).expand(n, T, d, d).clone()
    else:
        noise = torch.randn(n, T, d, d, generator=generator, device=gdev) * 0.01
        noise = 0.5 * (noise + noise.transpose(-1, -2))
        if structure == "full":
            X_cov = eye * cov_init_scale + noise + eye * 0.1
        else:  # block
            cross = torch.zeros(d, d, dtype=torch.bool, device=gdev)
            cross[:2, 2:] = True
            cross[2:, :2] = True
            X_cov = ((eye * cov_init_scale + noise).masked_fill(cross, 0.0)
                     + eye * 0.05)
    profiling.count_copies((X_mean, X_cov), device or gdev)
    return CaviState(X_mean=X_mean.to(device or gdev),
                     X_cov=X_cov.to(device or gdev))


def warm_init_state(Y: torch.Tensor, params: AMEParams, *,
                    structure: str = "full", cov_init_scale: float = 0.5,
                    n_power_iters: int = 4,
                    probe: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    obs_mask=None) -> CaviState:
    """Data-driven initialization (dense path of the JAX
    ``warm_init_state``): a two-way fit of the time-averaged network for
    the additive effects plus the top-r singular pairs of its residual for
    U/V, broadcast over T, with deterministic per-structure covariances.

    * additive: ``a_i = rowmean_i - grand/2``, ``b_j = colmean_j -
      grand/2`` over off-diagonal entries;
    * multiplicative: subspace iteration (power iterations + QR) from the
      (n, r) ``probe`` for the top-r singular triplets of the additive
      residual; ``U = u sqrt(s)``, ``V = v sqrt(s)``.

    ``probe`` defaults to a standard-normal draw from ``generator`` (a CPU
    generator seeded 0 when that is None too).  The JAX function draws it
    from ``PRNGKey(0)``, so the two agree only when handed one probe.

    ``obs_mask`` (n, n, T) restricts every average to observed dyads: time
    averages divide by per-entry observed counts and row/col/grand means
    by observed-partner counts; masked entries of ``Y`` are never read.

    A sharded ``Y`` (:func:`tame_torch.parallel.shard_fit_inputs` or
    ``shard_smoothed_inputs``; ``obs_mask`` the whole mask) returns the
    state sharded as ``shard_fit_inputs`` places one, computed from each
    rank's rows (:func:`tame_torch.parallel.sharded_init.warm_init_sharded`).
    """
    if is_sharded(Y):
        from tame_torch.parallel.sharded_init import warm_init_sharded

        return warm_init_sharded(Y, params, structure=structure,
                                 cov_init_scale=cov_init_scale,
                                 n_power_iters=n_power_iters, probe=probe,
                                 generator=generator, obs_mask=obs_mask)
    n, _, T, _ = Y.shape
    d = params.Phi.shape[0]
    r = (d - 2) // 2
    if obs_mask is None:
        w = dyad_ops.offdiag_mask(n, Y.dtype, Y.device)
        M = Y[..., 0].mean(-1) * w
    else:
        om, Yo = _observed(Y, obs_mask)
        cnt_t = om.sum(-1)                                  # (n, n)
        M = Yo[..., 0].sum(-1) / torch.clamp(cnt_t, min=1.0)
        w = (cnt_t > 0).to(M.dtype)
    row_mean = M.sum(1) / torch.clamp(w.sum(1), min=1.0)
    col_mean = M.sum(0) / torch.clamp(w.sum(0), min=1.0)
    grand = M.sum() / torch.clamp(w.sum(), min=1.0)
    a = row_mean - grand / 2.0
    b = col_mean - grand / 2.0

    resid = (M - a[:, None] - b[None, :]) * w
    if probe is None:
        gen = (generator if generator is not None
               else torch.Generator().manual_seed(0))
        probe = torch.randn(n, r, generator=gen, device=gen.device)
    profiling.count_copies((probe,), M.device)
    Z = resid @ probe.to(M)
    for _ in range(n_power_iters):
        Z, _ = torch.linalg.qr(resid @ (resid.T @ Z))
    # linalg.svd checks its result on the host (two syncs, CUDA's sync debug
    # mode reports); linalg.qr does not wait
    profiling.count_syncs(M, 2)
    u_s, sing, vt = torch.linalg.svd(Z.T @ resid, full_matrices=False)
    scale = torch.sqrt(torch.clamp(sing, min=1e-12))
    U = (Z @ u_s) * scale[None, :]
    V = vt.T * scale[None, :]

    centroid = torch.cat([a[:, None], b[:, None], U, V], -1)
    X_mean = centroid[:, None, :].expand(n, T, d).clone()
    var = {"diag": 0.5, "full": cov_init_scale + 0.1,
           "block": cov_init_scale + 0.05}[structure]
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    return CaviState(X_mean=X_mean, X_cov=(eye * var).expand(n, T, d, d)
                     .clone())


# ---------------------------------------------------------------------------
# Full fit
# ---------------------------------------------------------------------------

class _StopRule:
    """The JAX loop's tolerance x patience and divergence rule, evaluated
    in float32 on the host so the stop iteration matches bit for bit."""

    def __init__(self, carry_elbo, carry_patience: int, tolerance: float,
                 patience: int):
        self.prev = np.float32(-np.inf if carry_elbo is None else carry_elbo)
        self.pat = int(carry_patience)
        self.tol = np.float32(tolerance)
        self.patience = patience
        self.converged = self.diverged = False

    @property
    def running(self) -> bool:
        return not (self.converged or self.diverged)

    def update(self, elbo: Optional[float]) -> None:
        """Record one iteration; ``elbo`` is None where it was not
        evaluated."""
        if elbo is not None:
            e = np.float32(elbo)
            with np.errstate(invalid="ignore", over="ignore"):
                rel = np.abs(e - self.prev) / (np.abs(self.prev)
                                               + np.float32(1e-8))
            small = bool(np.isfinite(self.prev)) and bool(rel < self.tol)
            self.pat = self.pat + 1 if small else 0
            self.prev = e
        self.converged = self.pat >= self.patience
        self.diverged = elbo is not None and not math.isfinite(elbo)


def history_buffer(max_iter: int) -> int:
    """The JAX loops' history length: the next power of two >=
    max(max_iter, 64)."""
    buf = 64
    while buf < max_iter:
        buf *= 2
    return buf


class FitInputs(NamedTuple):
    """The loop-invariant inputs of a fit, shared by the CAVI and smoothed
    loops (:func:`fit_inputs`)."""

    Y: torch.Tensor           # unobserved entries zeroed (never read)
    obs: ObsConstants
    dc: Optional[DiagConstants]   # diag_mode="stats" only
    mask: Optional[torch.Tensor]  # float (n, n, T), zero diagonal
    mask_c: object            # what the contractions read: the mask, its
    #                           bf16 copy or a PackedMask
    mask_stats: object        # _mask_stats(mask), or None
    mse_norm: object          # ordered dyad-times the MSE averages over


def packed_mask_requested() -> bool:
    """``TAME_PACKED_MASK=1`` routes masked contractions through K5 (opt
    in, as in the JAX package, which measured it slower on its TPU)."""
    return os.environ.get("TAME_PACKED_MASK") == "1"


def fit_inputs(Y: torch.Tensor, R_inv: torch.Tensor, mask, *,
               mixed_precision: bool, diag_mode: str, packed_mask: bool,
               num_blocks: int) -> FitInputs:
    """Dyad weights (bf16 under ``mixed_precision``), stats-diagnostics
    constants and the mask in the layout the contractions read: packed
    for K5 with ``num_blocks`` stripes when ``packed_mask``, bf16 under
    ``mixed_precision`` (0/1 is exact in bf16), else as given.  ``Y`` is
    zeroed at masked entries with ``where`` first, so NaN-coded hidden
    dyads never reach the weights or the diagnostics."""
    n, _, T, _ = Y.shape
    mask_c = mask
    if mask is not None:
        Y = torch.where(mask[..., None] > 0, Y,
                        torch.zeros((), dtype=Y.dtype, device=Y.device))
        if packed_mask:
            mask_c = PackedMask(masked_contract.pack_mask(mask, num_blocks))
        elif mixed_precision:
            mask_c = mask.to(torch.bfloat16)
    return FitInputs(
        Y=Y,
        obs=precompute_obs_constants(
            Y, R_inv, w_dtype=torch.bfloat16 if mixed_precision else None),
        dc=precompute_diag_constants(Y) if diag_mode == "stats" else None,
        mask=mask, mask_c=mask_c,
        mask_stats=None if mask is None else _mask_stats(mask),
        mse_norm=(n * (n - 1) * T if mask is None
                  else torch.clamp(mask.sum(), min=1.0)))


def residual_stats(fi: FitInputs, X_mean: torch.Tensor, R_inv: torch.Tensor,
                   diag_mode: str):
    """``(sq, cross)`` dyadic residual statistics for the diagnostics:
    the stats expansion or the exact residual pass, dense or masked."""
    r = (X_mean.shape[-1] - 2) // 2
    if diag_mode == "stats" and fi.mask is not None:
        return _masked_residual_stats(fi.dc, fi.obs, X_mean, r, R_inv,
                                      fi.mask_c)
    if diag_mode == "stats":
        return _residual_stats_from_moments(fi.dc, fi.obs, X_mean, r, R_inv)
    fwd = dyad_ops.dyadic_fwd_temporal(X_mean, r)
    if fi.mask is None:
        return dyad_ops.residual_stats_from_fwd(fi.Y, fwd)
    e0 = (fi.Y[..., 0] - fwd) * fi.mask
    return torch.sum(e0 * e0), torch.sum(e0 * e0.transpose(0, 1))


def fit_loop(Y: torch.Tensor, params: AMEParams, init: CaviState, *,
             structure: str, update_mode: str, num_blocks: Optional[int],
             max_iter: int, learning_rate: float, tolerance: float,
             patience: int, corrected: bool, elbo_every: int, buf_size: int,
             carry_elbo=None, carry_patience: int = 0,
             mixed_precision: bool = False, diag_mode: str = "exact",
             mask=None, packed_mask: bool = False) -> FitResult:
    """The unfused fit: one step, one diagnostics pass and one host check
    of the stopping rule per iteration; on the card the steps and
    diagnostics after the first are CUDA graph replays
    (:mod:`tame_torch.inference.graphed`).  ``mask`` must already have a
    zero diagonal (:func:`fit_cavi`)."""
    fi = fit_inputs(Y, params.R_inv, mask, mixed_precision=mixed_precision,
                    diag_mode=diag_mode, packed_mask=packed_mask,
                    num_blocks=num_blocks if update_mode == "block" else 1)
    pri = precompute_priors(params)
    p_, q_ = params.R_inv[0, 0], params.R_inv[0, 1]
    lr = float(learning_rate)
    eh = np.full(buf_size, np.nan, np.float32)
    mh = np.full(buf_size, np.nan, np.float32)
    rule = _StopRule(carry_elbo, carry_patience, tolerance, patience)

    # the step functions are looked up by name at each call (a wrapper set
    # on the module from outside sees every eager call and the capture)
    def step(state):
        if update_mode == "jacobi":
            return cavi_step_jacobi(state, fi.obs, pri, params, structure,
                                    lr, corrected, mask=fi.mask_c)
        if update_mode == "seq":
            return cavi_step_seq(state, fi.obs, pri, params, structure, lr)
        return cavi_step_block(state, fi.obs, pri, params, structure, lr,
                               num_blocks, corrected, mask=fi.mask_c)

    def diagnostics(state):
        sq, cross = residual_stats(fi, state.X_mean, params.R_inv, diag_mode)
        elbo_t = _elbo_from_quad(p_ * sq + q_ * cross, params, pri, state,
                                 structure, mask_stats=fi.mask_stats)
        return torch.stack([elbo_t, 2.0 * sq / fi.mse_norm])

    it = 0
    with graphed.LoopRunner(step, diagnostics, init,
                            graphed.engages(Y.device, max_iter)) as loop:
        while it < max_iter and rule.running:
            with profiling.span("loop.step"):
                loop.step()
            elbo = None
            if (it + 1) % elbo_every == 0 or it + 1 == max_iter:
                out = loop.diagnostics()
                with profiling.span("loop.readback"):
                    elbo, mse = out.tolist()
                    profiling.count(profiling.SYNCS)
                eh[it], mh[it] = elbo, mse
            rule.update(elbo)
            it += 1
    state = loop.state
    return FitResult(X_mean=state.X_mean, X_cov=state.X_cov,
                     elbo_history=torch.from_numpy(eh),
                     mse_history=torch.from_numpy(mh), n_iter=it,
                     converged=rule.converged, diverged=rule.diverged,
                     last_elbo=float(rule.prev), pat_count=rule.pat)


def check_fit_options(update_mode: str, diag_mode: str, mask,
                      corrected: bool, mixed_precision: bool) -> None:
    """The option checks of :func:`fit_cavi`, sharded or not."""
    if diag_mode not in ("exact", "stats"):
        raise ValueError(f"unknown diag_mode: {diag_mode!r}")
    if mask is not None and update_mode not in ("jacobi", "block"):
        raise ValueError(
            "mask is supported with update_mode 'jacobi' or 'block'")
    if corrected and update_mode == "seq":
        raise ValueError(
            "corrected=True is not supported with update_mode='seq' "
            "(seq exists for reference-trajectory parity)")
    if mixed_precision and update_mode == "seq":
        raise ValueError(
            "mixed_precision=True is not supported with update_mode='seq' "
            "(seq exists for reference-trajectory parity)")
    if update_mode not in ("jacobi", "block", "seq"):
        raise ValueError(f"unknown update_mode: {update_mode!r}")


def is_sharded(x) -> bool:
    """Whether ``x`` is a value sharded over a mesh
    (:class:`tame_torch.parallel.mesh.Sharded`)."""
    from tame_torch.parallel.mesh import Sharded

    return isinstance(x, Sharded)


def refuse_mu_dyadic(mu_dyadic) -> None:
    if mu_dyadic is not None:
        raise ValueError("mu_dyadic: a sharded ELBO computes the means of "
                         "each rank's rows itself; pass None")


def _sharded(Y, init) -> bool:
    """Whether a fit's inputs are sharded over a mesh (both, or neither:
    a mix raises ``TypeError``)."""
    sharded = is_sharded(Y), is_sharded(init)
    if sharded[0] != sharded[1]:
        raise TypeError("Y and the initial state must both be sharded "
                        "(tame_torch.parallel.shard_fit_inputs) or both "
                        "be tensors")
    return sharded[0]


@profiling.spanned("fit.run")
def fit_cavi(Y: torch.Tensor, params: AMEParams, init: CaviState, *,
             structure: str = "full", update_mode: str = "jacobi",
             max_iter: int = 100, learning_rate=1.0, tolerance=1e-4,
             patience: int = 3, num_blocks=None, corrected: bool = False,
             elbo_every: int = 1, mixed_precision: bool = False,
             diag_mode: str = "exact", fused="auto", carry_elbo=None,
             carry_patience: int = 0, mask=None) -> FitResult:
    """Run damped CAVI to convergence (the JAX ``fit_cavi`` contract).

    PRECONDITION: ``Y`` follows the reciprocal layout
    ``Y[i, j, t, 1] == Y[j, i, t, 0]`` with zero diagonal.

    Stop once the relative ELBO change stays below ``tolerance`` for
    ``patience`` consecutive evaluations, or when the ELBO goes non-finite
    (``diverged``).  Histories are NaN-padded buffers whose length is the
    next power of two >= max(max_iter, 64).  ``elbo_every=k`` evaluates the
    diagnostics every k-th iteration (and at the last).

    ``mixed_precision=True`` stores the (n, n, T) dyad weights (and the
    mask) in bf16 and sums their products in float32
    (:func:`_eta_contract`); everything else stays float32.
    ``diag_mode="stats"`` computes the ELBO/MSE from sufficient statistics
    (:func:`residual_stats`) instead of an O(n^2 T) residual pass.

    ``mask`` enables missing-data fits: an (n, n, T) dyad observation mask
    (1 = observed; symmetric — both directions of a dyad live in one
    ``Y[i, j, t]`` entry; its diagonal is zeroed here).  Masked entries of
    ``Y`` are never read (NaN coding is safe); the observation terms and
    diagnostics run over observed dyads.  ``TAME_PACKED_MASK=1`` sends
    every masked contraction through K5
    (:mod:`tame_torch.ops.masked_contract`, its twin on the CPU).

    ``fused`` selects K3 (:mod:`tame_torch.ops.fused_fit`): ``"auto"`` uses
    it exactly when ``Y`` is on a CUDA device,
    :func:`~tame_torch.ops.fused_fit.fused_fit_supported` holds (never
    under a mask) and ``TAME_DISABLE_FUSED_FIT`` is unset; ``True`` forces
    it (its plain twin on the CPU) unless that switch is set, and raises
    outside the envelope; ``False`` disables it.
    ``carry_elbo``/``carry_patience`` seed the stopping rule from a
    previous segment's ``last_elbo``/``pat_count``.

    ``update_mode``: ``"jacobi"`` (:func:`cavi_step_jacobi`), ``"block"``
    (:func:`cavi_step_block`) or ``"seq"`` (:func:`cavi_step_seq`, the
    reference's node-by-node order, for small n; never K3, and not with
    ``corrected``, ``mixed_precision`` or a mask).

    ``Y`` and ``init`` from :func:`tame_torch.parallel.shard_fit_inputs`
    run the fit sharded over the mesh's ranks
    (:func:`tame_torch.parallel.sharded_cavi.fit_cavi_sharded`, every
    option above but K3; ``mask`` the whole (n, n, T) mask, of which each
    rank keeps its rows) and return a
    :class:`~tame_torch.parallel.mesh.Sharded` result.
    """
    if _sharded(Y, init):
        from tame_torch.parallel.sharded_cavi import fit_cavi_sharded

        return fit_cavi_sharded(
            Y, params, init, structure=structure, update_mode=update_mode,
            max_iter=max_iter, learning_rate=learning_rate,
            tolerance=tolerance, patience=patience, num_blocks=num_blocks,
            corrected=corrected, elbo_every=elbo_every,
            mixed_precision=mixed_precision, diag_mode=diag_mode,
            fused=fused, carry_elbo=carry_elbo,
            carry_patience=carry_patience, mask=mask)
    check_fit_options(update_mode, diag_mode, mask, corrected,
                      mixed_precision)
    if mask is not None:
        fused = False  # K3 assembles complete-network statistics
        mask = gated_mask(mask, Y)
    buf = history_buffer(max_iter)
    n, _, T, _ = Y.shape
    d = init.X_mean.shape[-1]
    if update_mode == "block" and num_blocks is None:
        # Largest divisor of n that is <= 16.
        num_blocks = next(k for k in range(min(16, n), 0, -1) if n % k == 0)
    if fused not in (False, None):
        supported = fused_fit.fused_fit_supported(
            n, T, d, structure=structure, update_mode=update_mode,
            diag_mode=diag_mode, mixed_precision=mixed_precision,
            elbo_every=elbo_every, num_blocks=num_blocks)
        if fused is True and not supported:
            raise ValueError(
                "fused=True requires update_mode 'jacobi' or 'block', "
                "diag_mode='exact', mixed_precision=False, elbo_every=1, "
                "d in (4, 6, 8, 10, 12) and a shared-memory-sized problem")
        # TAME_DISABLE_FUSED_FIT (any non-empty value) keeps K3 off, as in
        # the JAX package, under fused=True too
        disabled = bool(os.environ.get("TAME_DISABLE_FUSED_FIT"))
        if not disabled and (fused is True or (supported and Y.is_cuda)):
            out = fused_fit.fused_fit(
                Y, params.R_inv, params.Sigma0, params.Q, params.Phi,
                init.X_mean, init.X_cov, max_iter, learning_rate, tolerance,
                carry_elbo, carry_patience, r=(d - 2) // 2, buf_size=buf,
                patience=patience, corrected=corrected, structure=structure,
                num_blocks=num_blocks if update_mode == "block" else 1)
            return FitResult(*out)
    return fit_loop(Y, params, init, structure=structure,
                    update_mode=update_mode, num_blocks=num_blocks,
                    max_iter=max_iter, learning_rate=learning_rate,
                    tolerance=tolerance, patience=patience,
                    corrected=corrected, elbo_every=elbo_every,
                    buf_size=buf, carry_elbo=carry_elbo,
                    carry_patience=carry_patience,
                    mixed_precision=mixed_precision, diag_mode=diag_mode,
                    mask=mask,
                    packed_mask=mask is not None and packed_mask_requested())
