"""The reference's replay of a Good structured mean-field fit at the
production flags (traffic kind ``smf_prod_fits``): the engines' random
start from the fit's seed, then damped block coordinate ascent over a
masked network with bf16 dyad weights, and the ELBO after every
iteration.

The replay applies the roundings the configuration states
(``mixed_precision``), and only those:

* the dyad weights ``W0 = p y_ij + q y_ji`` and ``W1 = q y_ij + p y_ji``
  are formed in float32, from the float32 network and R^-1, and stored in
  bf16; their row sums (the natural parameter's additive entries) are
  taken before the rounding;
* every panel an update step contracts against the weights or the mask
  is rounded to bf16 first: the partners' ``V`` and ``U`` in ``W0 V`` and
  ``W1 U``, and the partner panel (the entries of ``J0' J0``, ``J1' J1``
  and ``J0' J1``: ones, ``U``, ``V`` and their products) whose masked
  sums give the observation precision; the products are summed in the
  replay's precision;
* the diagnostics' panels, ``[V | U]`` against ``W0`` and the moment
  panel against the mask, go in as two bf16 halves, the panel's bf16
  rounding and the bf16 rounding of the rest (:func:`halves`);
* everything else is computed in the replay's precision: float64 to
  judge.

The control (``"tf32"``) computes in float32 with every product's
operands rounded to TF32 and, below the configuration's float32 sums,
rounds every contraction's sums to bf16 (:func:`sums`).  TF32 keeps 10
bits of mantissa and bf16 7, so TF32 leaves every bf16 operand as it is:
the contractions, where nearly all the work is, come out of TF32 as out
of float32, and TF32 alone read within 1.1 - 2 times the program's own
gaps at n=2000 on an H100.

Its ELBO after each iteration is the masked ELBO of
:func:`tbench.reference.fits.smf_elbo` with the likelihood's quadratic
sum formed as the configuration's diagnostics (``diag_mode="stats"``)
form it, from sufficient statistics, whose data-mean cross terms read the
bf16 weights (:func:`stats_quad`); with exact weights it is the exact
sum.  The fits' stops read that expansion, and the weights' fixed
rounding sets it 2e-5 from the exact ELBO at n=2000 but 3e-5 - 1.7e-3 at
n = 8 - 48 (H100 and CPU readings), so the exact ELBO would need limits
per size.  Only masked fits without the corrected offsets are replayed.
"""

from typing import NamedTuple

import torch

from tbench.reference import fits
from tbench.reference.judge import refuse_unless
from tbench.reference.model import random_init
from tbench.roofline.counts import fit_flops

# The settings the replay implements; a cell that states another is refused.
REPLAYS = {"fit": {"dtype": ("float32",), "tf32": (False,),
                   "mixed_precision": (True,), "diag_mode": ("stats",),
                   "update_mode": ("block",)},
           "traffic": {"init": ("random",), "corrected": (False,)}}


def check(config: dict, traffic: dict) -> None:
    refuse_unless(config, traffic, REPLAYS)
    if not traffic.get("mask_frac", 0) > 0:
        raise ValueError("the reference replays masked fits (mask_frac > "
                         f"0), the cell states mask_frac "
                         f"{traffic.get('mask_frac')!r}")
    n, blocks = config["model"]["n_nodes"], config["fit"]["num_blocks"]
    # the Good-SMF engine takes no block count: its fit splits the nodes
    # into the largest divisor of n that is at most 16
    default = next(k for k in range(min(16, n), 0, -1) if n % k == 0)
    if blocks != default:
        raise ValueError(f"num_blocks {blocks}: a Good-SMF fit at n={n} "
                         f"runs {default} blocks")


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest, ties to even), kept in its
    dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def halves(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the diagnostics carry it: its bf16 rounding plus the bf16
    rounding of what that leaves (~16 bits), kept in its dtype."""
    hi = bf16(x)
    return hi + bf16(x - hi)


def sums(x: torch.Tensor, prec) -> torch.Tensor:
    """A contraction's sums as the precision ``prec`` keeps them: rounded
    to bf16 in the control's TF32, as computed otherwise."""
    return bf16(x) if prec.tf32 else x


class Weights(NamedTuple):
    W0: torch.Tensor      # (T, n, n) p y_ij + q y_ji, bf16
    W1: torch.Tensor      # (T, n, n) q y_ij + p y_ji, bf16
    eta_a: torch.Tensor   # (n, T) row sums of the float32 W0
    eta_b: torch.Tensor   # (n, T) and of W1


def weights(data: fits.Data, params) -> Weights:
    """The dyad weights as the configuration stores them, from the
    float32 network (``data`` holds it, hidden entries 0, in the replay's
    dtype)."""
    R_inv = params.R_inv.to(torch.float32)
    p, q = R_inv[0, 0], R_inv[0, 1]
    Y0, Y1 = data.Y0.to(torch.float32), data.Y1.to(torch.float32)
    W0, W1 = p * Y0 + q * Y1, q * Y0 + p * Y1
    dt = data.Y0.dtype
    return Weights(W0=W0.to(torch.bfloat16), W1=W1.to(torch.bfloat16),
                   eta_a=W0.to(dt).sum(-1).T.contiguous(),
                   eta_b=W1.to(dt).sum(-1).T.contiguous())


def obs_terms(X, rows: slice, data: fits.Data, w, params, prec):
    """``(P_obs (m, T, d, d), eta_obs (m, T, d))`` of the nodes ``rows``
    against the partners' means ``X``, with the bf16 roundings of the
    weights ``w`` (None: no rounding, :func:`fits.obs_terms`)."""
    if w is None:
        return fits.obs_terms(X, rows, data, params, prec, False)
    n, T, d = X.shape
    p, q = params.R_inv[0, 0], params.R_inv[0, 1]
    J0, J1 = fits.jacobian_rows(X)
    outer = lambda A, B: (A[..., :, None] * B[..., None, :]).reshape(  # noqa
        n, T, d * d)
    S = sums(fits.partner_sum(data, rows, bf16(torch.cat(
        [outer(J0, J0), outer(J1, J1), outer(J0, J1)], -1)), prec), prec)
    m = S.shape[0]
    A00, A11, A01 = (s.reshape(m, T, d, d) for s in S.split(d * d, -1))
    P = p * (A00 + A11) + q * (A01 + A01.transpose(-1, -2))
    _, _, U, V = fits._split(X)
    W0, W1 = (W[:, rows].to(X.dtype) for W in (w.W0, w.W1))
    etaU = sums(prec.mm(W0, bf16(V).transpose(0, 1)), prec).transpose(0, 1)
    etaV = sums(prec.mm(W1, bf16(U).transpose(0, 1)), prec).transpose(0, 1)
    eta = torch.cat([w.eta_a[rows, :, None], w.eta_b[rows, :, None], etaU,
                     etaV], -1)
    return P, eta


def stats_quad(X, data: fits.Data, w: Weights, params, prec,
               chunk: int = 5) -> torch.Tensor:
    """The likelihood's quadratic sum over observed unordered dyad-times,
    ``p S + q S'`` with ``S = sum m_ij e_ij^2`` and ``S' = sum m_ij e_ij
    e_ji`` over ordered pairs (``e = y - mu``, ``mu_ij = a_i + b_j + U_i .
    V_j``), expanded in sufficient statistics:

        S  = sum y_ij^2     - 2 (sum_i a_i r_i + b_i c_i + A) + sum m mu_ij^2
        S' = sum y_ij y_ji  - 2 (sum_i a_i c_i + b_i r_i + B)
             + sum m mu_ij mu_ji

    with row and column sums ``r``, ``c`` of y, ``A = sum y_ij U_i . V_j``
    and ``B = sum y_ij U_j . V_i`` solved from the bf16 weights'
    contraction against ``[V | U]`` (``W1 = W0'``, so ``sum U . (W0 V) = p
    A + q B`` and ``sum V . (W0 U) = q A + p B``), and the mean terms from
    the mask's partner sums of the moment panel ``[1, a, b, b^2, U, V, a V, b V, b U, V V',
    V U']`` (the mask is symmetric, so ``sum m a_j b_j = sum m a_i
    b_i``); both panels in their two bf16 halves."""
    n, T, d = X.shape
    r = (d - 2) // 2
    p, q = params.R_inv[0, 0], params.R_inv[0, 1]
    a, b, U, V = fits._split(X)
    row, col = data.Y0.sum(2).T, data.Y0.sum(1).T          # (n, T)
    s1 = s3 = X.new_zeros(())
    VU = halves(torch.cat([V, U], -1).transpose(0, 1))      # (T, n, 2r)
    Ut, Vt = U.transpose(0, 1), V.transpose(0, 1)
    for t0 in range(0, T, chunk):
        s = slice(t0, t0 + chunk)
        out = sums(prec.mm(w.W0[s].to(X.dtype), VU[s]), prec)  # (tc, n, 2r)
        s1 = s1 + torch.sum(Ut[s] * out[..., :r])
        s3 = s3 + torch.sum(Vt[s] * out[..., r:])
    A = (p * s1 - q * s3) / (p * p - q * q)
    B = (p * s3 - q * s1) / (p * p - q * q)

    a1, b1 = a[..., None], b[..., None]
    outer = lambda P, Q: (P[..., :, None] * Q[..., None, :]).reshape(  # noqa
        n, T, r * r)
    C = sums(fits.partner_sum(data, slice(None), halves(torch.cat(
        [torch.ones_like(a1), a1, b1, b1 * b1, U, V, a1 * V, b1 * V, b1 * U,
         outer(V, V), outer(V, U)], -1)), prec), prec)      # (n, T, K)
    cnt, Ma, Mb, Mb2 = C[..., 0], C[..., 1], C[..., 2], C[..., 3]
    MU, MV, MaV, MbV, MbU = C[..., 4:4 + 5 * r].split(r, -1)
    MVV, MVU = C[..., 4 + 5 * r:].split(r * r, -1)
    dot = lambda P, Q: torch.sum(P * Q, -1)  # noqa: E731
    m_sq = torch.sum(a * a * cnt + 2.0 * a * Mb + Mb2 + 2.0 * a * dot(U, MV)
                     + 2.0 * dot(U, MbV) + dot(outer(U, U), MVV))
    m_mT = torch.sum(a * Ma + 2.0 * a * b * cnt + b * Mb + a * dot(V, MU)
                     + dot(V, MbU) + dot(U, MaV) + b * dot(U, MV)
                     + dot(outer(U, V), MVU))
    S = (torch.sum(data.Y0 * data.Y0)
         - 2.0 * (torch.sum(a * row + b * col) + A) + m_sq)
    S_T = (torch.sum(data.Y0 * data.Y1)
           - 2.0 * (torch.sum(a * col + b * row) + B) + m_mT)
    return p * S + q * S_T


def smf_elbo(X, cov, data, w, params, pri, prec) -> torch.Tensor:
    """:func:`tbench.reference.fits.smf_elbo` with :func:`stats_quad` in
    place of the exact quadratic sum (``w`` None: the exact ELBO)."""
    elbo = fits.smf_elbo(X, cov, data, params, pri, prec)
    if w is None:
        return elbo
    return elbo + 0.5 * (fits.quad_sum(X, data, params, prec)
                         - stats_quad(X, data, w, params, prec))


def smf_step(X, cov, data, w, params, pri, prec, lr: float,
             num_blocks: int) -> None:
    """One iteration of block coordinate ascent, in place
    (:func:`tbench.reference.fits.smf_step` with :func:`obs_terms`)."""
    n, T, d = X.shape
    bs = n // num_blocks
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    zero = X.new_zeros(X[:, :1].shape)
    for blk in range(num_blocks):
        rows = slice(blk * bs, (blk + 1) * bs)
        P_obs, eta = obs_terms(X, rows, data, w, params, prec)
        Xb = X[rows]
        prev = torch.cat([zero[rows], Xb[:, :-1]], 1)
        nxt = torch.cat([Xb[:, 1:], zero[rows]], 1)
        eta = (eta + fits._mv(pri.Qinv_Phi, prev, prec)
               + fits._mv(pri.Qinv_Phi.T, nxt, prec))
        inv = torch.linalg.inv(P_obs + pri.P)
        new_cov = 0.5 * (inv + inv.transpose(-1, -2)) + 1e-6 * eye
        new_mean = fits._mv(new_cov, eta, prec)
        X[rows] = lr * new_mean + (1.0 - lr) * Xb
        cov[rows] = lr * new_cov + (1.0 - lr) * cov[rows]


def start(data, params, pri, prec, config, traffic, engine_seed,
          rounded: bool = True):
    """``(X, step)``: the means, updated in place, and one iteration that
    returns the ELBO after it; ``rounded=False`` replays the fit without
    its bf16 roundings."""
    fit = config["fit"]
    T, n, _ = data.Y0.shape
    mean, cov = random_init(engine_seed, n, T, params.d, fit["init_scale"],
                            fit["cov_init_scale"])
    dev = data.Y0.device
    X = mean.to(prec.dtype).to(dev)
    cov = cov.to(prec.dtype).to(dev)
    w = weights(data, params) if rounded else None

    def step():
        smf_step(X, cov, data, w, params, pri, prec, fit["learning_rate"],
                 fit["num_blocks"])
        return smf_elbo(X, cov, data, w, params, pri, prec)
    return X, step


def iteration_flops(n: int, T: int, d: int, num_blocks: int) -> float:
    """A masked Good-SMF iteration at the production flags
    (:func:`tbench.roofline.counts.fit_flops`'s count of it unmasked):
    each block's three partner Grams over all nodes replaced by the mask's
    partner sums of the (1 + 2r + 3r^2)-column partner panel, and the
    exact residual pass (n^2 T (2r + 6)) by the stats diagnostics' masked
    contraction against the (4 + 5r + 2r^2)-column moment panel and the
    weights' contraction against [V | U] (the data-mean cross terms), each
    diagnostics panel in its two bf16 halves (twice the columns)."""
    r = (d - 2) // 2
    grams = num_blocks * 3 * 2 * n * T * r * r
    partner = 2 * n * n * T * (1 + 2 * r + 3 * r * r)
    exact = n * n * T * (2 * r + 6)
    stats = 2 * (2 * n * n * T * (4 + 5 * r + 2 * r * r)
                 + 2 * n * n * T * 2 * r)
    return fit_flops(n, T, d, num_blocks, 1) - grams + partner - exact + stats
