"""Port parity for the block-tridiagonal smoother: the K4 twin
(``tame_torch.ops.tridiag.block_tridiag_smoother``, reached through
``tame_torch.ops.fused_smoother``) against ``tame``'s ``vmap``-ed scan
solver and its Pallas kernel in interpret mode, on the same numpy systems.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tame.config
from tame.inference import cavi as jcavi
from tame.models.params import build_params as jax_build_params
from tame.ops.fused_smoother import fused_smoother as jax_fused_smoother
from tame.ops.tridiag import block_tridiag_smoother as jax_smoother
from tame.ops.tridiag import dense_precision as jax_dense_precision
from tame_torch.ops import fused_smoother as tfs
from tame_torch.ops import tridiag as ttri

torch.set_num_threads(1)

# Mean, covariances and cross terms: the same f32 recursion with batched
# LAPACK factors in another operation order (measured <= 1.1e-6).
ATOL = 1e-5
# logdet: a sum of T d f32 logarithms taken in another order.
LOGDET_RTOL = 1e-5


def _system(n, T, d, seed):
    """The smoothed fit's systems: D_t = an SPD observation precision
    (A A'/d + I) + the prior precision, O = -(Q^-1 Phi)', b ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    jp = jax_build_params(tame.config.ModelConfig(
        n_nodes=n, n_time=T, latent_dim=(d - 2) // 2))
    pri = jcavi.precompute_priors(jp)
    A = rng.standard_normal((n, T, d, d))
    D = (A @ A.swapaxes(-1, -2) / d + np.eye(d)
         + np.asarray(jcavi._prior_precision(pri, T))[None])
    O = -np.asarray(pri.Qinv_Phi).T
    b = rng.standard_normal((n, T, d))
    return (D.astype(np.float32), O.astype(np.float32),
            b.astype(np.float32))


def _assert_matches(got, ref):
    for name in ("mean", "cov", "cross_cov"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(got.logdet.numpy(), np.asarray(ref.logdet),
                               rtol=LOGDET_RTOL)


@pytest.mark.parametrize("T", [1, 2, 7])
@pytest.mark.parametrize("d", [4, 6, 10])
def test_twin_matches_jax_scan_smoother(d, T):
    D, O, b = _system(5, T, d, seed=10 * d + T)
    ref = jax.vmap(lambda Di, bi: jax_smoother(Di, jnp.asarray(O), bi))(
        jnp.asarray(D), jnp.asarray(b))
    got = tfs.fused_smoother(torch.from_numpy(D), torch.from_numpy(O),
                             torch.from_numpy(b))
    assert got.cross_cov.shape == (5, T - 1, d, d)
    _assert_matches(got, ref)


def test_twin_matches_dense_inverse():
    """Against the float64 inverse of the materialized T d x T d
    precision: marginal and lag-1 blocks, mean and log det."""
    D, O, b = _system(2, 3, 6, seed=4)
    got = ttri.block_tridiag_smoother(torch.from_numpy(D),
                                      torch.from_numpy(O),
                                      torch.from_numpy(b))
    for i in range(2):
        P = ttri.dense_precision(torch.from_numpy(D[i]).double(),
                                 torch.from_numpy(O).double()).numpy()
        np.testing.assert_array_equal(
            P.astype(np.float32),
            np.asarray(jax_dense_precision(jnp.asarray(D[i]),
                                           jnp.asarray(O))))
        Sigma = np.linalg.inv(P)
        for t in range(3):
            blk = slice(6 * t, 6 * t + 6)
            np.testing.assert_allclose(got.cov[i, t].numpy(),
                                       Sigma[blk, blk], atol=ATOL)
            if t < 2:
                nxt = slice(6 * t + 6, 6 * t + 12)
                np.testing.assert_allclose(got.cross_cov[i, t].numpy(),
                                           Sigma[blk, nxt], atol=ATOL)
        np.testing.assert_allclose(got.mean[i].numpy().ravel(),
                                   Sigma @ b[i].ravel(), atol=ATOL)
        np.testing.assert_allclose(got.logdet[i].item(),
                                   np.linalg.slogdet(P)[1],
                                   rtol=LOGDET_RTOL)


def test_twin_matches_jax_kernel_in_interpret_mode():
    D, O, b = _system(3, 3, 4, seed=1)
    ref = jax_fused_smoother(jnp.asarray(D), jnp.asarray(O), jnp.asarray(b),
                             interpret=True)
    got = tfs.fused_smoother_twin(torch.from_numpy(D), torch.from_numpy(O),
                                  torch.from_numpy(b))
    _assert_matches(got, ref)


def test_non_spd_pivot_gives_nan_not_an_exception():
    D, O, b = _system(3, 4, 4, seed=2)
    D[1, 2] = -np.eye(4, dtype=np.float32)
    out = tfs.fused_smoother(torch.from_numpy(D), torch.from_numpy(O),
                             torch.from_numpy(b))
    assert torch.isnan(out.logdet[1]) and torch.isnan(out.mean[1]).any()
    assert torch.isfinite(out.logdet[[0, 2]]).all()
    assert torch.isfinite(out.cov[[0, 2]]).all()


# The card test's bounds on K4 against its twin: mean/cov/cross within
# 1e-4 of max|twin| (f32 operation order), logdet to 1e-5 relative.
SMOOTHER_REL = 1e-4


def _k4_emulation(D, O, b):
    """K4's arithmetic in float32 numpy, step for step: each product is
    the lanes' row-per-lane accumulation in k order, S_t^-1 the in-place
    Gauss-Jordan sweep without pivoting, logdet the sum of the pivots'
    logs, and a pivot that is not positive turned into NaN."""
    f32 = np.float32
    n, T, d, _ = D.shape
    O = O.astype(f32)

    def prod(A, B):  # rows of A (own) times B's rows (broadcast)
        acc = np.zeros((A.shape[0], d, d), f32)
        for k in range(d):
            acc += A[:, :, k, None] * B[:, None, k, :]
        return acc

    def matvec(A, x):
        acc = np.zeros((A.shape[0], d), f32)
        for k in range(d):
            acc += A[:, :, k] * x[:, None, k]
        return acc

    def gauss_jordan(S):
        A = S.copy()
        logdet = np.zeros(n, f32)
        for k in range(d):
            piv = A[:, k, k].copy()
            with np.errstate(invalid="ignore"):
                piv = np.where(piv > 0, piv, f32(np.nan)).astype(f32)
                logdet += np.log(piv)
            inv = (f32(1) / piv).astype(f32)
            pr, g = A[:, k, :].copy(), A[:, :, k] * inv[:, None]
            A -= g[:, :, None] * pr[:, None, :]
            A[:, :, k] = -g
            A[:, k, :] = pr * inv[:, None]
            A[:, k, k] = inv
        return A, logdet

    Ob = np.broadcast_to(O, (n, d, d))
    OtB = np.broadcast_to(O.T, (n, d, d))
    Sinv = np.empty((n, T, d, d), f32)
    c = np.empty((n, T, d), f32)
    logdet = np.zeros(n, f32)
    for t in range(T):
        if t == 0:
            S, c[:, 0] = D[:, 0], b[:, 0]
        else:
            M = prod(OtB, Sinv[:, t - 1])
            c[:, t] = b[:, t] - matvec(M, c[:, t - 1])
            acc = -D[:, t]  # M O accumulated onto -D_t, then negated
            for k in range(d):
                acc += M[:, :, k, None] * Ob[:, None, k, :]
            S = -acc
        Sinv[:, t], ld = gauss_jordan(S)
        logdet += ld
    mean = np.empty((n, T, d), f32)
    cov = np.empty((n, T, d, d), f32)
    cross = np.empty((n, max(T - 1, 0), d, d), f32)
    mean[:, T - 1], cov[:, T - 1] = matvec(Sinv[:, T - 1], c[:, T - 1]), \
        Sinv[:, T - 1]
    for t in range(T - 2, -1, -1):
        rhs = c[:, t] - matvec(Ob, mean[:, t + 1])
        G = prod(Sinv[:, t], Ob)
        mean[:, t] = matvec(Sinv[:, t], rhs)
        GS = prod(G, cov[:, t + 1])
        sig = Sinv[:, t].copy()  # GS G' accumulated onto S_t^-1
        for k in range(d):
            sig += GS[:, :, k, None] * G[:, None, :, k]
        cov[:, t] = sig
        cross[:, t] = -GS
    return tfs.FusedSmootherOut(*(torch.from_numpy(x) for x in
                                  (mean, cov, cross, logdet)))


def _assert_within_card_bounds(got, ref):
    for name in ("mean", "cov", "cross_cov"):
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        if r.size:
            assert np.abs(g - r).max() <= SMOOTHER_REL * np.abs(r).max(), name
    np.testing.assert_allclose(got.logdet.numpy(), np.asarray(ref.logdet),
                               rtol=LOGDET_RTOL)


@pytest.mark.parametrize("T", [1, 2, 50])
@pytest.mark.parametrize("d", [4, 10, 14, 48])
def test_kernel_arithmetic_matches_twin_and_jax(d, T):
    """K4's per-step algorithm (row-per-lane products, Gauss-Jordan
    inverse, logdet from the pivots) against the twin and JAX's scan
    smoother, within the bounds the card test holds K4 to."""
    D, O, b = _system(3, T, d, seed=7 * d + T)
    got = _k4_emulation(D, O, b)
    _assert_within_card_bounds(got, tfs.fused_smoother_twin(
        torch.from_numpy(D), torch.from_numpy(O), torch.from_numpy(b)))
    _assert_within_card_bounds(got, jax.vmap(
        lambda Di, bi: jax_smoother(Di, jnp.asarray(O), bi))(
            jnp.asarray(D), jnp.asarray(b)))


def test_kernel_arithmetic_indefinite_node_is_nan():
    D, O, b = _system(3, 6, 10, seed=5)
    D[1, 2] = -np.eye(10, dtype=np.float32)
    got = _k4_emulation(D, O, b)
    ref = tfs.fused_smoother_twin(torch.from_numpy(D), torch.from_numpy(O),
                                  torch.from_numpy(b))
    for name in ("mean", "cov", "cross_cov", "logdet"):
        g = getattr(got, name)
        assert torch.isnan(g[1]).all(), name
        assert torch.isnan(getattr(ref, name)[1]).all(), name
    keep = [0, 2]
    _assert_within_card_bounds(
        tfs.FusedSmootherOut(*(x[keep] for x in got)),
        tfs.FusedSmootherOut(*(x[keep] for x in ref)))


def test_cpu_dispatch_and_envelope():
    D, O, b = _system(2, 3, 6, seed=3)
    before = tfs.fused_smoother_kernel.launches
    tfs.fused_smoother(torch.from_numpy(D), torch.from_numpy(O),
                       torch.from_numpy(b))
    assert tfs.fused_smoother_kernel.launches == before  # CPU: the twin
    assert tfs.fused_smoother_supported(2000, 50, 10)
    assert tfs.fused_smoother_supported(3, 2, 4)
    assert tfs.fused_smoother_supported(3, 1, 4)          # T = 1: no cross
    assert tfs.fused_smoother_supported(3, 5, 14)         # runtime d
    assert tfs.fused_smoother_supported(3, 5, 48)
    assert not tfs.fused_smoother_supported(3, 5, 50)     # past every build
    assert not tfs.fused_smoother_supported(3, 5, 5)      # odd d
    assert tfs.fused_smoother_smem_bytes(10) == 3120
    assert tfs.fused_smoother_smem_bytes(14) == 7040
    assert tfs.fused_smoother_smem_bytes(34) == \
        tfs.fused_smoother_smem_bytes(48) == 60864       # opts in > 48 KB
    assert [tfs.fused_smoother_pitch(c) for c in (4, 6, 10, 12, 14, 48)] \
        == [4, 12, 12, 12, 20, 52]
    assert tfs.fused_smoother_smem_bytes(48, 4) <= tfs.MAX_SMEM_BYTES
    # one node per block up to 132 nodes, then up to four
    assert [tfs.fused_smoother_warps(n, 10)
            for n in (3, 125, 132, 133, 2000)] == [1, 1, 1, 2, 4]
