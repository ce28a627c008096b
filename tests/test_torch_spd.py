"""K1 and K2's arithmetic on the CPU: a numpy emulation of the kernels held
to the port's twins, to the reference kernel's order and to the JAX
package.

K1 ``spd_solve_inv`` and K2 ``logdet_spd`` (``tame_torch/csrc/spd.cu``)
run only on the card.  What they compute per system is emulated here in
float32 numpy, lane by lane: a group of G lanes (``spd_geometry``, wide
for K1 with the inverse, narrow for K2 and K1 without it) holds the rows
padded to the column capacity, row i in lane i % G (slot i / G), read up
to the diagonal; a right-looking Cholesky takes each pivot and each L_jk
from the lane that holds its row; K2 sums the log pivots; K1 solves the
columns of [I | eta], lane c the columns c, c + G, ..., by forward and
backward substitution.  Each FMA rounds once and roots, reciprocals and
logs are IEEE float32, as on the card.  The emulation is held bitwise to
a direct transcription of the reference kernel's order (the JAX kernel's
left-looking loops, one system at a time, which the one-thread CUDA kernel
ran), within stated tolerances to ``spd_solve_inv_twin`` and
``logdet_spd_twin`` at every even d from 4 to 48, and to JAX's Pallas
kernels in interpret mode at d <= 12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tame.ops import cholesky as jchol
from tame_torch.ops import cholesky as tchol

torch.set_num_threads(1)

f32 = np.float32
EVEN_D = tuple(range(4, tchol.MAX_KERNEL_D + 1, 2))
# Emulation against the twins: the same Cholesky in float32 against
# LAPACK's blocked one, a few ulps times d times the condition number
# (<= ~5 for these systems): max |error| was 6.6e-7 of max |twin| at
# d = 48 and 2e-7 at d = 10.
REL = 2e-6
# Emulation against JAX's Pallas kernels (d <= 12), which round each
# product before the subtraction: as the K1/K2 twins' own parity tests
# (tests/test_torch_ops.py).
RTOL = 1e-5
ATOL = 1e-6


def _spd(rng, B, d):
    """``chip_smoke.spd_batch``'s systems, A A' / d + I: eigenvalues in
    ~[1, 5], the hardest well-posed case at d = 48."""
    A = rng.standard_normal((B, d, d)).astype(f32)
    P = (A @ A.transpose(0, 2, 1) / f32(d) + np.eye(d, dtype=f32)).astype(f32)
    return P, rng.standard_normal((B, d)).astype(f32)


def _fma(x, y, z):
    """float32 fused multiply-add: the product is exact in float64, so the
    sum rounds once (to float64, then float32)."""
    return (np.asarray(x, np.float64) * np.asarray(y, np.float64)
            + np.asarray(z, np.float64)).astype(f32)


def _positive_or_nan(x):
    with np.errstate(invalid="ignore"):
        return np.where(x > 0, x, f32(np.nan)).astype(f32)


def _inv_root(acc):
    with np.errstate(invalid="ignore", divide="ignore"):
        return (f32(1) / np.sqrt(acc).astype(f32)).astype(f32)


def _log(acc):
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.log(acc).astype(f32)


def load_lanes(P, narrow):
    """The lane array a (B, G, R, DC) the kernel loads: lane k, slot r
    holds row i = k + G r, zero past column d and for i >= d.  Entries up
    to the diagonal come from row i in V-float loads, so the load that
    holds the diagonal also brings up to V - 1 entries past it (never
    read)."""
    B, d, _ = P.shape
    dc, G, _ = tchol.spd_geometry(d, narrow)
    R, V = -(-dc // G), (4 if dc <= 16 and dc % 4 == 0 else 2)
    a = np.zeros((B, G, R, dc), f32)
    for k in range(G):
        for r in range(R):
            i = k + G * r
            if i < d:
                top = min(d, (i // V + 1) * V)  # the loads with c <= i
                a[:, k, r, :top] = P[:, i, :top]
    return a


def _rows(G, R):
    return np.arange(G)[:, None] + G * np.arange(R)[None, :]  # (G, R)


def group_cholesky(a, d):
    """``group_cholesky``: right-looking, the pivot and each L_jm shuffled
    from the lane that holds its row.  Returns (a holding L below the
    diagonal, inv_diag (B, d), sum of log pivots)."""
    a = a.copy()
    B, G, R, _ = a.shape
    rows = _rows(G, R)
    inv_diag = np.zeros((B, d), f32)
    logdet = np.zeros(B, f32)
    for m in range(d):
        acc = _positive_or_nan(a[:, m % G, m // G, m])
        logdet = (logdet + _log(acc)).astype(f32)
        inv_diag[:, m] = _inv_root(acc)
        below = rows > m
        a[:, below, m] = (a[:, below, m] * inv_diag[:, m, None]).astype(f32)
        for j in range(m + 1, d):
            ljm = a[:, j % G, j // G, m]
            a[..., j] = _fma(-a[..., m], ljm[:, None, None], a[..., j])
    return a, inv_diag, logdet


def emulate_solve(P, eta, with_inverse=True):
    """``spd_solve_inv_kernel``: mu (B, d)[, cov (B, d, d)]; without the
    inverse in the narrow geometry with every lane solving eta, as the
    kernel runs it."""
    B, d, _ = P.shape
    a, inv_diag, _ = group_cholesky(load_lanes(P, not with_inverse), d)
    G = a.shape[1]
    L = lambda i, m: a[:, i % G, i // G, m]  # noqa: E731  (shuffled)
    cols = list(range(d + 1)) if with_inverse else [d]
    # lane c's slots: columns c, c + G, ... of [I | eta]
    x = np.zeros((B, len(cols), d), f32)
    for n, c in enumerate(cols):
        x[:, n] = eta if c == d else np.eye(d, dtype=f32)[c]
    if with_inverse:  # left-looking, each lane its columns
        for i in range(d):
            for m in range(i):
                x[:, :, i] = _fma(-L(i, m)[:, None], x[:, :, m], x[:, :, i])
            x[:, :, i] = (x[:, :, i] * inv_diag[:, i, None]).astype(f32)
    else:  # right-looking: row j's sum takes y_i as each y_i is final
        for i in range(d):
            x[:, 0, i] = (x[:, 0, i] * inv_diag[:, i]).astype(f32)
            for j in range(i + 1, d):
                x[:, 0, j] = _fma(-L(j, i), x[:, 0, i], x[:, 0, j])
    for i in range(d - 1, -1, -1):
        for m in range(i + 1, d):
            x[:, :, i] = _fma(-L(m, i)[:, None], x[:, :, m], x[:, :, i])
        x[:, :, i] = (x[:, :, i] * inv_diag[:, i, None]).astype(f32)
    mu = x[:, -1]
    if not with_inverse:
        return mu
    return mu, x[:, :d].transpose(0, 2, 1).copy()  # column c of P^-1


def emulate_logdet(P):
    """``logdet_spd_kernel``: the narrow group's Cholesky, its log pivots
    summed in step order (up to d = 12 the kernel runs the reference order
    on one thread: the same bits, which
    ``test_lane_groups_keep_the_reference_order_bitwise`` checks)."""
    return group_cholesky(load_lanes(P, True), P.shape[1])[2]


def reference_order(P, eta):
    """The reference kernel's order, one system at a time: the JAX kernel's
    left-looking Cholesky (``chol_factor``), then one forward and backward
    substitution per column of [I | eta] (``chol_solve``), each product
    fused into its subtraction as the CUDA kernel compiled it.  Returns
    (mu, cov, logdet)."""
    B, d, _ = P.shape
    L = np.zeros((B, d, d), f32)
    inv_diag = np.zeros((B, d), f32)
    logdet = np.zeros(B, f32)
    for k in range(d):
        acc = P[:, k, k].copy()
        for m in range(k):
            acc = _fma(-L[:, k, m], L[:, k, m], acc)
        acc = _positive_or_nan(acc)
        logdet = (logdet + _log(acc)).astype(f32)
        inv_diag[:, k] = _inv_root(acc)
        for i in range(k + 1, d):
            a2 = P[:, i, k].copy()
            for m in range(k):
                a2 = _fma(-L[:, i, m], L[:, k, m], a2)
            L[:, i, k] = (a2 * inv_diag[:, k]).astype(f32)

    def solve(rhs):
        y = np.zeros((B, d), f32)
        for i in range(d):
            acc = rhs[:, i].copy()
            for m in range(i):
                acc = _fma(-L[:, i, m], y[:, m], acc)
            y[:, i] = (acc * inv_diag[:, i]).astype(f32)
        x = np.zeros((B, d), f32)
        for i in range(d - 1, -1, -1):
            acc = y[:, i].copy()
            for m in range(i + 1, d):
                acc = _fma(-L[:, m, i], x[:, m], acc)
            x[:, i] = (acc * inv_diag[:, i]).astype(f32)
        return x

    eye = np.broadcast_to(np.eye(d, dtype=f32), (B, d, d))
    cov = np.stack([solve(eye[:, :, j]) for j in range(d)], -1)
    return solve(eta), cov, logdet


def _twins(P, eta):
    mu, cov = tchol.spd_solve_inv_twin(torch.from_numpy(P),
                                       torch.from_numpy(eta))
    ld = tchol.logdet_spd_twin(torch.from_numpy(P))
    return mu.numpy(), cov.numpy(), ld.numpy()


def _close(got, ref, rel=REL):
    """max |got - ref| <= rel * max |ref| (the card tests' form)."""
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("d", EVEN_D)
def test_emulation_matches_the_twins(d):
    P, eta = _spd(np.random.default_rng(d), 13, d)
    mu, cov = emulate_solve(P, eta)
    ld = emulate_logdet(P)
    mu_t, cov_t, ld_t = _twins(P, eta)
    _close(mu, mu_t)
    _close(cov, cov_t)
    _close(ld, ld_t)


@pytest.mark.parametrize("d", EVEN_D)
def test_lane_groups_keep_the_reference_order_bitwise(d):
    """The right-looking group factorization and the per-lane column
    solves give the reference kernel's bits: every entry sees the same
    operations in the same order."""
    P, eta = _spd(np.random.default_rng(100 + d), 5, d)
    mu, cov = emulate_solve(P, eta)
    mu_r, cov_r, ld_r = reference_order(P, eta)
    np.testing.assert_array_equal(mu, mu_r)
    np.testing.assert_array_equal(cov, cov_r)
    np.testing.assert_array_equal(emulate_logdet(P), ld_r)


@pytest.mark.parametrize("d", [4, 6, 8, 10, 12])
def test_emulation_matches_jax_pallas(d):
    P, eta = _spd(np.random.default_rng(50 + d), 37, d)
    mu, cov = emulate_solve(P, eta)
    # op by op: compiling the unrolled kernel body costs minutes at d = 12
    with jax.disable_jit():
        mu_j, cov_j = jchol._pallas_spd_solve_inv(
            jnp.asarray(P), jnp.asarray(eta), interpret=True)
        ld_j = jchol._pallas_logdet(jnp.asarray(P), interpret=True)
    np.testing.assert_allclose(mu, np.asarray(mu_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cov, np.asarray(cov_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(emulate_logdet(P), np.asarray(ld_j),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [6, 14, 34, 48])
def test_mu_only_solve_gives_the_full_solves_mu_bitwise(d):
    """Without the inverse every lane of a narrow group solves eta alone,
    its forward pass right-looking: mu depends neither on the other
    columns, nor on the lane that holds a row, nor on the loop order, as
    each sum takes its terms in the same order."""
    # the two runs below lay the rows out on different lanes
    assert tchol.spd_geometry(d, True)[1] != tchol.spd_geometry(d)[1]
    P, eta = _spd(np.random.default_rng(d + 7), 9, d)
    np.testing.assert_array_equal(emulate_solve(P, eta, False),
                                  emulate_solve(P, eta)[0])


@pytest.mark.parametrize("d", [4, 10, 14, 34, 48])
@pytest.mark.parametrize("garbage", ["nan", "random"])
def test_only_the_lower_triangle_is_read(d, garbage):
    rng = np.random.default_rng(d + 3)
    P, eta = _spd(rng, 7, d)
    upper = np.triu(np.ones((d, d), bool), 1)
    Pg = P.copy()
    Pg[:, upper] = (np.nan if garbage == "nan" else
                    rng.standard_normal((7, int(upper.sum()))).astype(f32))
    mu, cov = emulate_solve(Pg, eta)
    ld = emulate_logdet(Pg)
    assert np.isfinite(mu).all() and np.isfinite(cov).all()
    mu_t, cov_t, ld_t = _twins(P, eta)
    _close(mu, mu_t)
    _close(cov, cov_t)
    _close(ld, ld_t)
    # the twins read the lower triangle too
    mu_g, cov_g, ld_g = _twins(Pg, eta)
    np.testing.assert_array_equal(mu_g, mu_t)
    np.testing.assert_array_equal(cov_g, cov_t)
    np.testing.assert_array_equal(ld_g, ld_t)


@pytest.mark.parametrize("d", [6, 14, 48])
@pytest.mark.parametrize("where", ["first pivot", "later pivot"])
def test_an_indefinite_system_comes_out_nan_alone(d, where):
    P, eta = _spd(np.random.default_rng(d), 5, d)
    if where == "first pivot":
        P[2] = -P[2]
    else:  # leading minors positive up to the third pivot
        P[2] = np.eye(d, dtype=f32)
        P[2, 2, 2] = -1.0
    mu, cov = emulate_solve(P, eta)
    ld = emulate_logdet(P)
    assert np.isnan(mu[2]).all() and np.isnan(cov[2]).all()
    assert np.isnan(ld[2])
    keep = [0, 1, 3, 4]
    mu_t, cov_t, ld_t = _twins(P, eta)
    assert np.isnan(mu_t[2]).all() and np.isnan(cov_t[2]).all()
    assert np.isnan(ld_t[2])
    _close(mu[keep], mu_t[keep])
    _close(cov[keep], cov_t[keep])
    _close(ld[keep], ld_t[keep])


def test_padding_past_d_leaves_the_results_exact():
    """At a capacity above d (d = 18 in 24) the padding rows and columns
    are zero and take no step: the d x d results are the twins'."""
    P, eta = _spd(np.random.default_rng(0), 6, 18)
    assert tchol.spd_geometry(18)[0] == 24
    a = load_lanes(P, narrow=False)
    assert not a[..., 18:].any()
    G = a.shape[1]
    rows = np.arange(G)[:, None] + G * np.arange(a.shape[2])[None, :]
    assert not a[:, rows >= 18].any()  # the padding rows are zero
    mu, cov = emulate_solve(P, eta)
    mu_t, cov_t, _ = _twins(P, eta)
    _close(mu, mu_t)
    _close(cov, cov_t)


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("d", EVEN_D)
def test_geometry_mirrors_the_kernels_rule(d, narrow):
    """``spd_geometry`` against the rule ``spd.cu`` states: the capacity is
    exact up to 16, then 24, 32, 48; a group of G lanes holds every row,
    R = ceil(capacity / G) per lane (one up to d = 32 for K1); 256 threads
    a block, 64 where the rows take more than 64 floats a lane."""
    dc, G, systems = tchol.spd_geometry(d, narrow)
    assert dc == (d if d <= 16 else min(c for c in (24, 32, 48) if c >= d))
    assert G == tchol.spd_group(dc, narrow) and G in (4, 8, 16, 32)
    if not narrow:
        assert G >= min(dc, 32)
    rows_per_lane = -(-dc // G)
    assert G * rows_per_lane >= dc > G * (rows_per_lane - 1)
    threads = 64 if rows_per_lane * dc > 64 else 256
    assert G * systems == threads


def test_geometry_outside_the_envelope():
    for d in (2, 5, 50, 0):
        for narrow in (False, True):
            assert tchol.spd_geometry(d, narrow) == (0, 0, 0)


def test_aligned_copies_only_a_misaligned_view():
    base = torch.arange(1 + 2 * 16, dtype=torch.float32)
    P = base[1:].view(2, 4, 4)
    assert P.data_ptr() % 16 != 0
    Q = tchol._aligned(P)
    assert Q.data_ptr() % 16 == 0 and torch.equal(Q, P)
    R = base[:32].view(2, 4, 4)
    assert tchol._aligned(R).data_ptr() == R.data_ptr()
