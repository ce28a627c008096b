"""K3's arithmetic on the CPU: a numpy emulation of the kernel held to the
port's twins and to the JAX package.

K3 (``tame_torch/csrc/fused_fit.cu``) runs only on the card.  What it
computes per factor — a G-lane group holding the precision row by row,
padded to the group's width, inverted by a Gauss-Jordan sweep without
pivoting, then the diag/full/block policy and, for the entropy, the sum of
the sweep's log pivots — is emulated here in float32 numpy and held to
``spd_solve_inv_twin``/``logdet_spd_twin``, the ``cavi`` policies and the
JAX megakernel's ``_plane_chol_solve``/``_plane_logdet``.  A whole fit is
emulated too, with the kernel's index arithmetic (the moment table of
``moment_pair``, the entries of ``zval``, the rows assembled from
(feature, kind) pairs, the corrected offsets), and held to
``fused_fit_twin``.  The layout rule mirrored from ``choose_layout`` is
checked against the envelope ``fused_fit_supported`` keeps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tame.ops import fused_fit as jff
from tame_torch.inference import cavi
from tame_torch.models import TemporalAMEModel
from tame_torch.ops import cholesky as tchol
from tame_torch.ops import fused_fit as tff

torch.set_num_threads(1)

f32 = np.float32
# One factor's algebra in float32 against the twins: a few ulps times the
# condition number (<= ~10 for these systems).
RTOL = 1e-5
ATOL = 1e-6
# A whole fit against the twin: the card test's bounds.
ELBO_RTOL = 1e-4
STATE_ATOL = 1e-4


def group_width(d):
    return 4 if d <= 4 else (8 if d <= 8 else 16)


def sweep(A, rhs=None):
    """The kernel's in-place Gauss-Jordan sweep without pivoting on a
    batch (B, m, m), lane k holding row k: each step broadcasts the pivot
    row; returns (A^-1, A^-1 rhs, sum of log pivots), a pivot that is not
    positive turned into NaN."""
    A = A.astype(f32).copy()
    B, m, _ = A.shape
    rhs = np.zeros((B, m), f32) if rhs is None else rhs.astype(f32).copy()
    logdet = np.zeros(B, f32)
    for k in range(m):
        pr, prh = A[:, k, :].copy(), rhs[:, k].copy()
        piv = pr[:, k]
        with np.errstate(invalid="ignore"):
            piv = np.where(piv > 0, piv, f32(np.nan)).astype(f32)
            logdet += np.log(piv)
        inv = (f32(1) / piv).astype(f32)
        g = A[:, :, k] * inv[:, None]
        A -= g[:, :, None] * pr[:, None, :]
        rhs -= g * prh[:, None]
        A[:, :, k] = -g
        A[:, k, :] = pr * inv[:, None]
        A[:, k, k] = inv
        rhs[:, k] = prh * inv
    return A, rhs, logdet


def group_solve(P, e, structure):
    """One G-lane group per factor: the d x d precision padded to the
    group's width with the identity (rows k >= d zero but for their
    diagonal), swept, then the structure policy of ``cavi._SOLVERS``.
    Returns (mean, covariance, log det of P) of the d x d system."""
    B, d, _ = P.shape
    G = group_width(d)
    Pg = np.broadcast_to(np.eye(G, dtype=f32), (B, G, G)).copy()
    Pg[:, :d, :d] = P
    eg = np.zeros((B, G), f32)
    eg[:, :d] = e
    inv, mu, logdet = sweep(Pg, eg)
    # the padding leaves the real block's results as they are
    np.testing.assert_array_equal(inv[:, d:, d:],
                                  np.broadcast_to(np.eye(G - d), (B, G - d,
                                                                  G - d)))
    assert not inv[:, :d, d:].any() and not inv[:, d:, :d].any()
    inv, mu = inv[:, :d, :d], mu[:, :d]
    if structure == "diag":
        var = f32(1) / (np.diagonal(P, axis1=1, axis2=2) + f32(1e-8))
        return mu, np.einsum("bk,kl->bkl", var, np.eye(d, dtype=f32)), logdet
    if structure == "block":
        cross = np.zeros((d, d), bool)
        cross[:2, 2:] = cross[2:, :2] = True
        inv = np.where(cross, f32(0), inv)
    cov = f32(0.5) * (inv + inv.transpose(0, 2, 1)) + f32(1e-6) * np.eye(
        d, dtype=f32)
    return np.einsum("bkl,bl->bk", cov, e), cov, logdet


def _spd_system(rng, B, d):
    A = rng.standard_normal((B, d, d)).astype(f32)
    P = A @ A.transpose(0, 2, 1) / d + np.eye(d, dtype=f32)
    return P.astype(f32), rng.standard_normal((B, d)).astype(f32)


@pytest.mark.parametrize("d", tff.FUSED_DIMS)
def test_group_sweep_matches_twins_and_jax(d):
    rng = np.random.default_rng(d)
    B = 29
    P, e = _spd_system(rng, B, d)
    inv, mu, logdet = sweep(P, e)
    mu_t, cov_t = tchol.spd_solve_inv_twin(torch.from_numpy(P),
                                           torch.from_numpy(e))
    ld_t = tchol.logdet_spd_twin(torch.from_numpy(P))
    np.testing.assert_allclose(mu, mu_t.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(inv, cov_t.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logdet, ld_t.numpy(), rtol=RTOL, atol=ATOL)
    # the JAX megakernel's plane Cholesky: every entry is a (B,) plane
    Pp = [[jnp.asarray(P[:, i, j]) for j in range(d)] for i in range(d)]
    solve, mu_j = jff._plane_chol_solve(Pp, [jnp.asarray(e[:, i])
                                             for i in range(d)], d)
    unit = [[jnp.full(B, 1.0 if i == j else 0.0, jnp.float32)
             for i in range(d)] for j in range(d)]
    inv_j = np.stack([np.stack([np.asarray(c) for c in solve(u)], -1)
                      for u in unit], -1)
    np.testing.assert_allclose(mu, np.stack([np.asarray(m) for m in mu_j],
                                            -1), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(inv, inv_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logdet, np.asarray(jff._plane_logdet(Pp, d)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("structure", ["diag", "full", "block"])
@pytest.mark.parametrize("d", tff.FUSED_DIMS)
def test_group_policies_match_cavi_solvers(d, structure):
    rng = np.random.default_rng(10 * d + len(structure))
    P, e = _spd_system(rng, 31, d)
    mu, cov, logdet = group_solve(P, e, structure)
    mu_t, cov_t = cavi._SOLVERS[structure](torch.from_numpy(P),
                                           torch.from_numpy(e))
    np.testing.assert_allclose(mu, mu_t.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cov, cov_t.numpy(), rtol=RTOL, atol=ATOL)
    # the entropy's log-determinant: the same sweep on the covariance
    ld_cov = sweep(cov)[2]
    np.testing.assert_allclose(
        ld_cov, tchol.logdet_spd_twin(torch.from_numpy(cov)).numpy(),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        logdet, np.asarray(jff._plane_logdet(
            [[jnp.asarray(P[:, i, j]) for j in range(d)] for i in range(d)],
            d)), rtol=RTOL, atol=ATOL)


def forward_logdet(A):
    """``sweep_logdet``: the sum of the sweep's log pivots by forward
    elimination alone, each step updating only the columns after the
    pivot."""
    A = A.astype(f32).copy()
    B, m, _ = A.shape
    logdet = np.zeros(B, f32)
    for k in range(m):
        piv = A[:, k, k].copy()
        with np.errstate(invalid="ignore"):
            piv = np.where(piv > 0, piv, f32(np.nan)).astype(f32)
            logdet += np.log(piv)
        g = A[:, :, k] * (f32(1) / piv)[:, None]
        A[:, :, k + 1:] -= g[:, :, None] * A[:, k, None, k + 1:]
    return logdet


@pytest.mark.parametrize("d", tff.FUSED_DIMS)
def test_forward_elimination_gives_the_sweeps_pivots(d):
    P, _ = _spd_system(np.random.default_rng(d + 1), 41, d)
    np.testing.assert_array_equal(forward_logdet(P), sweep(P)[2])


def test_sweep_turns_an_indefinite_system_into_nan():
    P, e = _spd_system(np.random.default_rng(0), 3, 6)
    P[1] = -P[1]
    inv, mu, logdet = sweep(P, e)
    assert np.isnan(inv[1]).all() and np.isnan(mu[1]).all()
    assert np.isnan(logdet[1]) and np.isfinite(logdet[[0, 2]]).all()


# ---------------------------------------------------------------------------
# The whole fit, with the kernel's index arithmetic
# ---------------------------------------------------------------------------

def moment_pair(s, D):
    """``moment_pair<D>``: moment s as two indices into z = [1, V, U, c,
    dd]; the pairs a <= b of the partner features g = [1, V, U] come first,
    then the corrected update's offsets (c, 1), (dd, 1), (c, V_k),
    (dd, U_k)."""
    S, R = D - 1, (D - 2) // 2
    TRI = S * (S + 1) // 2
    a = sum(s >= m * S - m * (m - 1) // 2 for m in range(1, S))
    b = s - (a * S - a * (a - 1) // 2) + a
    e = s - TRI
    with_c = e == 0 or 2 <= e < 2 + R
    if s < TRI:
        return a, b
    return (D - 1 if with_c else D), (0 if e < 2 else e - 1)


def zcoef(z, D, p, q):
    """``zcoef<D>``: entry z of [1, V, U, c, dd] of a mean row x as
    al x[ia] + be x[ib] + ga."""
    R = (D - 2) // 2
    lin = z in (D - 1, D)
    ia = 1 if lin or z == 0 else (R + 1 + z if z <= R else z + 1 - R)
    al = 0 if z == 0 else (p if z == D - 1 else (q if z == D else 1))
    be = q if z == D - 1 else (p if z == D else 0)
    return ia, 0, f32(al), f32(be), f32(z == 0)


def zvals(X, p, q):
    """``zval`` for every entry: (..., D) means -> (..., D + 1)."""
    D = X.shape[-1]
    out = []
    for z in range(D + 1):
        ia, ib, al, be, ga = zcoef(z, D, p, q)
        out.append(al * X[..., ia] + (be * X[..., ib] + ga))
    return np.stack(out, -1).astype(f32)


def kernel_emulation(Y, R_inv, Sigma0, Q, Phi, Xm0, Xc0, max_iter, lr, tol,
                     *, structure, corrected, num_blocks, buf, patience=3):
    """K3's fit in float32 numpy: the prologue's priors by the sweep, per
    phase the moment table over all nodes and each factor's rows built as
    the lanes build them, the sweep and policy, the damped write-back; the
    exact diagnostics, the ELBO and the stopping rule."""
    n, _, T, _ = Y.shape
    D = Xm0.shape[-1]
    R, S = (D - 2) // 2, D - 1
    TRI = S * (S + 1) // 2
    pairs = [moment_pair(s, D) for s in range(TRI + D)]
    p, q = f32(R_inv[0, 0]), f32(R_inv[0, 1])
    y0, y1 = Y[..., 0], Y[..., 1]
    W0, W1 = p * y0 + q * y1, q * y0 + p * y1            # (n, n, T)
    S0i, _, ldS0 = sweep(Sigma0[None])
    Qi, _, ldQ = sweep(Q[None])
    S0i, Qi, ldS0, ldQ = S0i[0], Qi[0], ldS0[0], ldQ[0]
    QP = Qi @ Phi
    PtQP = Phi.T @ QP
    t_idx = np.arange(T)
    prior = (np.where(t_idx[:, None, None] == 0, S0i, 0)
             + np.where(t_idx[:, None, None] > 0, Qi, 0)
             + np.where(t_idx[:, None, None] < T - 1, PtQP, 0)).astype(f32)
    prior = np.tril(prior) + np.tril(prior, -1).transpose(0, 2, 1)
    feat = [0] * 2 + list(range(1, S))             # row k -> g index
    fwd = [k == 0 or 2 <= k < 2 + R for k in range(D)]  # row k's kind
    Xm, Xc = Xm0.astype(f32).copy(), Xc0.astype(f32).copy()
    eh = np.full(buf, np.nan, f32)
    mh = np.full(buf, np.nan, f32)
    bs = n // num_blocks
    prev, pat, conv, div, n_done = f32(-np.inf), 0, False, False, 0
    keep = f32(1) - f32(lr)
    for it in range(max_iter):
        if conv or div:
            break
        for blk in range(num_blocks):
            rows = slice(blk * bs, (blk + 1) * bs)
            Z = zvals(Xm, p, q)                              # (n, T, D + 1)
            sums = [(Z[..., za] * Z[..., zb]).sum(0) for za, zb in pairs]
            # the symmetric (S, S) moment matrix, then the D offsets
            st = np.empty((T, S * S + D), f32)
            for s_, (za, zb) in enumerate(pairs):
                if s_ < TRI:
                    st[:, za * S + zb] = st[:, zb * S + za] = sums[s_]
                else:
                    st[:, S * S + s_ - TRI] = sums[s_]
            x = Xm[rows]
            g = np.concatenate([np.ones_like(x[..., :1]), x[..., 2 + R:],
                                x[..., 2:2 + R]], -1)      # (bs, T, S)
            A = np.empty((bs, T, D, D), f32)
            for k in range(D):
                for c in range(D):
                    mom = st[:, feat[k] * S + feat[c]]
                    w = p if fwd[k] == fwd[c] else q
                    A[..., k, c] = w * (mom - g[..., feat[k]]
                                        * g[..., feat[c]])
            A += prior
            e = np.concatenate([
                W0[rows].sum(1)[..., None], W1[rows].sum(1)[..., None],
                np.einsum("ijt,jtm->itm", W0[rows], Xm[..., 2 + R:]),
                np.einsum("ijt,jtm->itm", W1[rows], Xm[..., 2:2 + R])], -1)
            if corrected:
                ci = p * x[..., 1] + q * x[..., 0]
                di = q * x[..., 1] + p * x[..., 0]
                for k in range(D):
                    own = (ci if fwd[k] else di) * (1 if k < 2
                                                    else g[..., feat[k]])
                    e[..., k] -= st[:, S * S + k] - own
            xp = np.concatenate([x[:, :1], x[:, :-1]], 1)
            xn = np.concatenate([x[:, 1:], x[:, -1:]], 1)
            e += ((t_idx > 0)[:, None] * (xp @ QP.T)
                  + (t_idx < T - 1)[:, None] * (xn @ QP))
            mu, cov, _ = group_solve(A.reshape(-1, D, D), e.reshape(-1, D),
                                     structure)
            Xm[rows] = f32(lr) * mu.reshape(x.shape) + keep * x
            Xc[rows] = f32(lr) * cov.reshape(Xc[rows].shape) + keep * Xc[rows]
        # exact diagnostics over the ordered dyads i != j
        a, b, U, V = Xm[..., 0], Xm[..., 1], Xm[..., 2:2 + R], Xm[..., 2 + R:]
        m = (a[:, None] + b[None, :]) + np.einsum("itk,jtk->ijt", U, V)
        off = ~np.eye(n, dtype=bool)[:, :, None]
        r0 = y0 - m
        r1 = y0.transpose(1, 0, 2) - m.transpose(1, 0, 2)
        sq, cross = (r0 * r0)[np.broadcast_to(off, r0.shape)].sum(), \
            (r0 * r1)[np.broadcast_to(off, r0.shape)].sum()
        n_dyads = f32(n * (n - 1) // 2 * T)
        logdet_R = -np.log(abs(R_inv[0, 0] * R_inv[1, 1]
                               - R_inv[0, 1] * R_inv[1, 0]))
        log_lik = f32(-0.5) * ((p * sq + q * cross)
                               + n_dyads * (logdet_R + 2 * jff._LOG2PI))
        if structure != "diag":
            tr = np.trace(Xc, axis1=-2, axis2=-1).sum()
            log_lik -= f32(0.5) * (f32(0.1) * (R_inv[0, 0] + R_inv[1, 1])
                                   / D * (n - 1) * tr)
        x0 = Xm[:, 0]
        v3 = (np.einsum("ia,ab,ib->", x0, S0i, x0)
              + np.einsum("ab,iba->", S0i, Xc[:, 0]))
        res = Xm[:, 1:] - Xm[:, :-1] @ Phi.T
        v4 = (np.einsum("ita,ab,itb->", res, Qi, res)
              + np.einsum("ab,itba->", Qi, Xc[:, 1:]))
        prior0 = f32(-0.5) * (v3 + n * (ldS0 + D * jff._LOG2PI))
        priort = f32(-0.5) * (v4 + n * (T - 1) * (ldQ + D * jff._LOG2PI))
        entropy = f32(0.5) * (sweep(Xc.reshape(-1, D, D))[2].sum()
                              + n * T * D * (1 + jff._LOG2PI))
        elbo = f32(log_lik + prior0 + priort + entropy)
        eh[it], mh[it] = elbo, f32(2 * sq / (n * (n - 1) * T))
        with np.errstate(invalid="ignore", over="ignore"):
            rel = np.abs(elbo - prev) / (np.abs(prev) + f32(1e-8))
        pat = pat + 1 if (np.isfinite(prev) and rel < f32(tol)) else 0
        conv, div = pat >= patience, not np.isfinite(elbo)
        prev, n_done = elbo, n_done + 1
    return Xm, Xc, eh, mh, n_done, conv, div


@pytest.mark.parametrize("corrected", [False, True])
@pytest.mark.parametrize("structure", ["diag", "full", "block"])
@pytest.mark.parametrize("num_blocks", [1, 3])
@pytest.mark.parametrize("d", tff.FUSED_DIMS)
def test_kernel_emulation_matches_twin(d, num_blocks, structure, corrected):
    r = (d - 2) // 2
    n, T, iters = 6, 3, 4
    model = TemporalAMEModel(n_nodes=n, n_time=T, latent_dim=r, seed=d,
                             device="cpu")
    Y = model.generate_data(generator=torch.Generator().manual_seed(d))
    prm = model.params
    init = cavi.init_state(torch.Generator().manual_seed(1), n, T, d,
                           structure, 0.1, 0.5)
    twin = tff.fused_fit_twin(Y, prm.R_inv, prm.Sigma0, prm.Q, prm.Phi,
                              init.X_mean, init.X_cov, iters, 0.7, 0.0,
                              r=r, buf_size=8, structure=structure,
                              corrected=corrected, num_blocks=num_blocks)
    np_ = [x.numpy().astype(f32) for x in (Y, prm.R_inv, prm.Sigma0, prm.Q,
                                           prm.Phi, init.X_mean, init.X_cov)]
    Xm, Xc, eh, mh, n_done, conv, div = kernel_emulation(
        *np_, iters, 0.7, 0.0, structure=structure, corrected=corrected,
        num_blocks=num_blocks, buf=8)
    assert (n_done, conv, div) == (twin.n_iter, twin.converged, twin.diverged)
    np.testing.assert_allclose(eh, twin.elbo_history.numpy(), rtol=ELBO_RTOL,
                               atol=0, equal_nan=True)
    np.testing.assert_allclose(mh, twin.mse_history.numpy(), rtol=ELBO_RTOL,
                               atol=0, equal_nan=True)
    np.testing.assert_allclose(Xm, twin.X_mean.numpy(), rtol=0,
                               atol=STATE_ATOL)
    np.testing.assert_allclose(Xc, twin.X_cov.numpy(), rtol=0,
                               atol=STATE_ATOL)


def test_kernel_emulation_stops_and_freezes_like_twin():
    model = TemporalAMEModel(n_nodes=8, n_time=4, latent_dim=2, seed=3,
                             device="cpu")
    Y = model.generate_data(generator=torch.Generator().manual_seed(3))
    prm = model.params
    init = cavi.init_state(torch.Generator().manual_seed(2), 8, 4, 6, "full",
                           0.1, 0.5)
    args = (Y, prm.R_inv, prm.Sigma0, prm.Q, prm.Phi, init.X_mean,
            init.X_cov)
    twin = tff.fused_fit_twin(*args, 100, 0.7, 1e-3, r=2, buf_size=128,
                              num_blocks=4)
    got = kernel_emulation(*[x.numpy().astype(f32) for x in args], 100, 0.7,
                           1e-3, structure="full", corrected=False,
                           num_blocks=4, buf=128)
    assert twin.converged and twin.n_iter < 100
    assert got[4:] == (twin.n_iter, True, False)
    assert np.isnan(got[2][twin.n_iter:]).all()


# ---------------------------------------------------------------------------
# Layout and envelope
# ---------------------------------------------------------------------------

def _largest_admitted_T(n, d, nb):
    """The largest T whose fit ``fused_fit_supported`` admits (0: none)."""
    r = (d - 2) // 2
    per_T = (n + n // nb) * (d + d * d) + 2 + 4 * r + 3 * r * r
    return (tff.SMEM_LIMIT_BYTES // 4 - 5 * d * d - 49) // per_T


@pytest.mark.parametrize("d", tff.FUSED_DIMS)
def test_every_admitted_shape_has_a_layout(d):
    """Every shape inside the envelope has a layout (shared memory grows
    with T, so the largest admitted T of each (n, num_blocks) decides):
    every block count for n <= 240, and one node per block and one
    Jacobi block, the two extremes, up to the envelope's largest n."""
    kw = dict(structure="full", update_mode="block", diag_mode="exact",
              elbo_every=1)
    checked = 0
    for n in range(1, 4000):
        for nb in (range(1, n + 1) if n <= 240 else (1, n)):
            T = _largest_admitted_T(n, d, nb) if n % nb == 0 else 0
            if T < 1:
                continue
            assert tff.fused_fit_supported(n, T, d, num_blocks=nb, **kw)
            assert not tff.fused_fit_supported(n, T + 1, d, num_blocks=nb,
                                               **kw)
            assert tff.fused_fit_layout(n, T, d, nb) >= 0, (n, T, d, nb)
            checked += 1
    assert checked > 1000


def test_layouts_of_the_documented_shapes():
    # the demo fits keep W0, W1 and y0 on chip, with the odd pitch
    both = tff.STAGED | tff.PADDED
    assert tff.fused_fit_layout(15, 10, 6, 15) == both
    assert tff.fused_fit_layout(15, 10, 6, 1) == both
    assert tff.fused_fit_layout(8, 4, 12, 1) == both
    # n=100, T=10 in 10 blocks reads them from device memory
    assert tff.fused_fit_layout(100, 10, 6, 10) == tff.PADDED
    assert tff.fused_fit_smem_bytes(100, 10, 6, 10, tff.PADDED) <= \
        tff.SMEM_LIMIT_BYTES < tff.fused_fit_smem_bytes(100, 10, 6, 10,
                                                         tff.STAGED)
    assert tff.fused_fit_layout(15, 10, 6, 4) == -1  # 4 does not divide 15
    assert tff.fused_fit_layout(2000, 50, 10, 16) == -1


def fast_div(x, d):
    """``FastDiv``: x // d for 0 <= x < 2^31 by a multiply and a shift."""
    s = 0
    while (1 << s) < d:
        s += 1
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    assert m < 1 << 32
    return (((x * m) >> 32) + x) >> s


@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 10, 15, 21, 36, 100, 225,
                               1000, 2897, 10000, 65537, 2**30 + 1])
def test_fast_division_is_exact(d):
    rng = np.random.default_rng(d)
    xs = np.concatenate([np.arange(4 * d + 3), [2**31 - 1, 2**31 - 2],
                         rng.integers(0, 2**31, 2000)]) if d < 10**5 else \
        np.concatenate([[0, 1, d - 1, d, d + 1, 2**31 - 1],
                        rng.integers(0, 2**31, 2000)])
    for x in xs.tolist():
        assert fast_div(x, d) == x // d, (x, d)


def test_probe_runs_on_the_cpu(capsys):
    import json

    from tame_torch.scripts import fused_fit_probe

    res = fused_fit_probe.main(["--device", "cpu", "--n-fits", "1",
                                "--repeats", "1", "--demo-iters", "2",
                                "--bench-iters", "3"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == res
    assert [s["n_iter"] for s in res["shapes"].values()] == [2, 3]
    assert res["bench_it_per_s"] > 0


def test_probe_stamps_every_barrier_of_the_kernel():
    import pathlib

    from tame_torch.scripts import fused_fit_probe

    src = (pathlib.Path(tff.__file__).parents[1] / "csrc"
           / "fused_fit.cu").read_text()
    out, lines = fused_fit_probe.instrumented_source(src)
    body = src[src.index("fused_fit_kernel(FusedFitArgs a) {"):]
    assert len(lines) == body.count("__syncthreads();") >= 5
    assert all("__syncthreads" in src.splitlines()[k - 1] for k in lines)
    store = out.index("eh[a.max_iter + _k]")
    assert store < out.index("stats[0] =", store)
    assert out.count("clock64()") == len(lines) + 1


def reduce_scatter(v):
    """``reduce_scatter<G>`` over the G lanes of a group, lane k holding
    the row v[k]: recursive halving by xor partners; returns what each lane
    returns."""
    G = v.shape[0]
    v = v.astype(f32).copy()
    h = G // 2
    while h >= 1:
        lanes = np.arange(G)
        upper = (lanes & h) != 0
        send = np.where(upper[:, None], v[:, :h], v[:, h:2 * h])
        keep = np.where(upper[:, None], v[:, h:2 * h], v[:, :h])
        v[:, :h] = keep + send[lanes ^ h]
        h //= 2
    return v[:, 0]


@pytest.mark.parametrize("G", [4, 8, 16])
def test_reduce_scatter_leaves_row_k_sum_in_lane_k(G):
    v = np.random.default_rng(G).standard_normal((G, G)).astype(f32)
    np.testing.assert_allclose(reduce_scatter(v), v.sum(0), rtol=1e-6,
                               atol=1e-6)


def test_bad_smf_at_d12_is_float32_exact_over_ten_iterations():
    """The card test runs the Bad-SMF fits at d = 12 over 10 iterations:
    that fit grows its means fastest, and over 10 iterations its own
    float32 rounding (the float32 twin against a float64 run) stays within
    half the 1e-4 state bound the kernel is held to."""
    model = TemporalAMEModel(n_nodes=12, n_time=5, latent_dim=5, seed=24,
                             device="cpu")
    Y = model.generate_data(generator=torch.Generator().manual_seed(24))
    prm = model.params
    init = cavi.init_state(torch.Generator().manual_seed(24), 12, 5, 12,
                           "block", 0.1, 0.5)
    args = (Y, prm.R_inv, prm.Sigma0, prm.Q, prm.Phi, init.X_mean,
            init.X_cov)
    kw = dict(r=5, buf_size=64, structure="block", num_blocks=4)
    t32 = tff.fused_fit_twin(*args, 10, 0.7, 0.0, **kw)
    t64 = tff.fused_fit_twin(*[x.double() for x in args], 10, 0.7, 0.0, **kw)
    gap = (t32.X_mean.double() - t64.X_mean).abs().max().item()
    assert gap <= 0.5 * STATE_ATOL
