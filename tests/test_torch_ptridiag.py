"""Port parity for the time-parallel smoother (``tame_torch.ops.ptridiag``)
and ``fit_cavi_smoothed(smoother="parallel")``: the same numpy systems go
through ``tame.ops.ptridiag`` (JAX, CPU, ``vmap``-ed over nodes) and the
port's batched smoother, and the port is held to its own sequential
solver at long T, where the associative scan has 9-11 levels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tame.config
from tame.inference import smoothed as jsm
from tame.models.params import build_params as jax_build_params
from tame.ops.ptridiag import parallel_block_tridiag_smoother as jax_ptri
from tame_torch.inference import cavi as tcavi
from tame_torch.inference import smoothed as tsm
from tame_torch.models import params_from_numpy
from tame_torch.ops import fused_smoother as tfs
from tame_torch.ops import ptridiag as tptri
from tame_torch.ops.tridiag import block_tridiag_smoother

torch.set_num_threads(1)

ATOL_JAX = 1e-5     # same combine tree, f32 solves in another library
RTOL_LOGDET = 1e-5
ATOL_SEQ = 5e-4     # against the sequential solver (tame's own bound)
RTOL_LOGDET_SEQ = 1e-4
RTOL_ELBO = 1e-4    # fit histories, every iteration


def _system(T, d=6, n=4, phi=0.8, pscale=0.5, seed=0):
    """tame's ``TestParallelSmoother`` systems with a node axis, numpy
    float32: Pobs = A A' + 2 pscale I, eta ~ N(0, 1), the AR(1) prior."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, T, d, d)) * pscale
    Pobs = (np.einsum("ntij,ntkj->ntik", A, A)
            + max(2 * pscale, 1e-3) * np.eye(d))
    eta = rng.standard_normal((n, T, d))
    Phi = phi * np.eye(d)
    Q = (1 - phi ** 2) * 0.1 * (np.eye(d) + 0.2 * np.ones((d, d)))
    Sigma0 = np.eye(d) * 0.7 + 0.1
    return tuple(x.astype(np.float32) for x in (Pobs, eta, Phi, Q, Sigma0))


def _sequential(Pobs, eta, Phi, Q, Sigma0):
    """The port's sequential solver on the implied full blocks."""
    T = Pobs.shape[1]
    Q_inv, S0_inv = torch.linalg.inv(Q), torch.linalg.inv(Sigma0)
    t = torch.arange(T)
    D = (Pobs + (t == 0)[:, None, None] * S0_inv
         + (t > 0)[:, None, None] * Q_inv
         + (t < T - 1)[:, None, None] * (Phi.T @ Q_inv @ Phi))
    return block_tridiag_smoother(D, -Phi.T @ Q_inv, eta)


@pytest.mark.parametrize("T", [1, 2, 3, 8, 33])
def test_matches_tame_smoother(T):
    Pobs, eta, Phi, Q, Sigma0 = _system(T)
    ref = jax.jit(jax.vmap(lambda P, e: jax_ptri(P, e, Phi, Q, Sigma0)))(
        Pobs, eta)
    got = tptri.parallel_block_tridiag_smoother(
        *(torch.from_numpy(x) for x in (Pobs, eta, Phi, Q, Sigma0)))
    for name in ("mean", "cov", "cross_cov"):
        assert getattr(got, name).shape == np.asarray(
            getattr(ref, name)).shape
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=ATOL_JAX, err_msg=name)
    np.testing.assert_allclose(got.logdet.numpy(), np.asarray(ref.logdet),
                               rtol=RTOL_LOGDET)


@pytest.mark.parametrize("T,phi,pscale,seed", [
    (512, 0.8, 0.5, 0), (512, 0.97, 0.05, 1), (2048, 0.8, 0.5, 0),
    (2048, 0.97, 0.05, 2)])
def test_matches_sequential_at_long_T(T, phi, pscale, seed):
    """Through 9 and 11 combine levels, the weak-information / high-phi
    corner included (where a transfer-matrix formulation blows up)."""
    sys_ = [torch.from_numpy(x)
            for x in _system(T, n=2, phi=phi, pscale=pscale, seed=seed)]
    got = tptri.parallel_block_tridiag_smoother(*sys_)
    ref = _sequential(*sys_)
    for name in ("mean", "cov", "cross_cov"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=ATOL_SEQ, msg=name)
    torch.testing.assert_close(got.logdet, ref.logdet, rtol=RTOL_LOGDET_SEQ,
                               atol=0)


@pytest.mark.parametrize("length", [1, 2, 5, 8, 13])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_is_jax_recursion(length, reverse):
    """A non-commutative combine (2 x 2 matrix products) scanned by the
    port and by ``lax.associative_scan``: the same combine tree gives the
    same products, in both directions, at odd and even lengths."""
    rng = np.random.default_rng(length)
    M = rng.standard_normal((3, length, 2, 2)).astype(np.float32)
    ref = jax.lax.associative_scan(lambda a, b: (jnp.matmul(
        a[0], b[0], precision="highest"),), (jnp.asarray(M),),
        reverse=reverse, axis=1)[0]
    got = tptri.associative_scan(lambda a, b: (a[0] @ b[0],),
                                 (torch.from_numpy(M),), reverse=reverse)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("T", [1, 4])
def test_indefinite_system_gives_nan_not_an_exception(T):
    """A node whose system is not positive definite comes out NaN (as the
    sequential solver and K4 give), the others unchanged."""
    Pobs, eta, Phi, Q, Sigma0 = (torch.from_numpy(x) for x in _system(T))
    bad = Pobs.clone()
    bad[1, T // 2] = -50.0 * torch.eye(6)
    out = tptri.parallel_block_tridiag_smoother(bad, eta, Phi, Q, Sigma0)
    ref = tptri.parallel_block_tridiag_smoother(Pobs, eta, Phi, Q, Sigma0)
    assert torch.isnan(out.logdet[1]) and torch.isnan(out.mean[1]).all()
    keep = [0, 2, 3]
    assert torch.equal(out.mean[keep], ref.mean[keep])
    assert torch.equal(out.logdet[keep], ref.logdet[keep])


# ---------------------------------------------------------------------------
# fit_cavi_smoothed(smoother="parallel")
# ---------------------------------------------------------------------------

def _data(n, T, r, seed):
    rng = np.random.default_rng(seed)
    d = 2 + 2 * r
    X = 0.8 * rng.standard_normal((n, T, d))
    fwd = (X[:, None, :, 0] + X[None, :, :, 1]
           + np.einsum("itr,jtr->ijt", X[..., 2:2 + r], X[..., 2 + r:]))
    y = fwd + 0.3 * rng.standard_normal((n, n, T))
    y[np.arange(n), np.arange(n)] = 0.0
    Y = np.stack([y, y.transpose(1, 0, 2)], -1).astype(np.float32)
    jp = jax_build_params(tame.config.ModelConfig(n_nodes=n, n_time=T,
                                                  latent_dim=r))
    init = jsm.SmoothedState(
        X_mean=jnp.asarray((0.1 * rng.standard_normal((n, T, d)))
                           .astype(np.float32)),
        X_cov=jnp.broadcast_to(0.5 * jnp.eye(d), (n, T, d, d)),
        X_cross=jnp.zeros((n, T - 1, d, d)),
        logdets=jnp.full((n,), -T * d * np.log(0.5), jnp.float32))
    mask = (rng.random((n, n, T)) > 0.3).astype(np.float32)
    mask = np.triu(mask.transpose(2, 0, 1), 1).transpose(1, 2, 0)
    return Y, jp, init, mask + mask.transpose(1, 0, 2)


@pytest.mark.parametrize("mode", ["jacobi", "block", "masked"])
def test_parallel_fit_matches_tame(mode):
    """Jacobi, block and masked fits with the parallel smoother: the
    relative ELBO within 1e-4 at every iteration and the same stop."""
    Y, jp, init, mask = _data(8, 5, 1, seed=3)
    kw = dict(max_iter=150, learning_rate=0.9, tolerance=1e-4,
              smoother="parallel",
              update_mode="jacobi" if mode == "jacobi" else "block",
              num_blocks=None if mode == "jacobi" else 4)
    if mode == "masked":
        Y = np.where(mask[..., None] > 0, Y, np.nan).astype(np.float32)
    jm = None if mode != "masked" else jnp.asarray(mask)
    tm = None if mode != "masked" else torch.from_numpy(mask)
    ref = jsm.fit_cavi_smoothed(jnp.asarray(Y), jp, init, mask=jm, **kw)
    got = tsm.fit_cavi_smoothed(torch.from_numpy(Y), params_from_numpy(jp),
                                tsm.smoothed_state_from_numpy(init),
                                mask=tm, **kw)
    n = int(ref.n_iter)
    assert got.n_iter == n and got.converged == bool(ref.converged)
    assert 3 < n < 150
    t = got.elbo_history.numpy()[:n]
    j = np.asarray(ref.elbo_history)[:n]
    assert np.all(np.isfinite(t))
    assert np.max(np.abs(t - j) / np.abs(j)) < RTOL_ELBO
    np.testing.assert_allclose(got.mse_history.numpy()[:n],
                               np.asarray(ref.mse_history)[:n], rtol=RTOL_ELBO)


def test_parallel_step_matches_sequential_step():
    """One Jacobi and one block step: the parallel branch solves the
    same systems as the K4 branch (its twin here), from the observation
    terms and the prior."""
    Y, jp, init, _ = _data(8, 6, 1, seed=4)
    tp = params_from_numpy(jp)
    obs = tcavi.precompute_obs_constants(torch.from_numpy(Y), tp.R_inv)
    pri = tcavi.precompute_priors(tp)
    st = tsm.smoothed_state_from_numpy(init)
    for step in (lambda par: tsm.smoothed_step(st, obs, pri, tp, 0.7, True,
                                               par),
                 lambda par: tsm.smoothed_step_block(st, obs, pri, tp, 0.8,
                                                     4, True, par)):
        seq, par = step(False), step(True)
        for name in tsm.SmoothedState._fields:
            torch.testing.assert_close(getattr(par, name),
                                       getattr(seq, name), rtol=1e-4,
                                       atol=1e-5, msg=name)


def test_solver_selection():
    """``fused=True`` with the parallel smoother raises (a user forcing
    the kernel must not get the scan); ``fused="auto"`` yields; the
    parallel fit launches no K4 and ``"auto"`` resolves to sequential."""
    Y, jp, init, _ = _data(6, 3, 1, seed=5)
    tY, tp = torch.from_numpy(Y), params_from_numpy(jp)
    st = tsm.smoothed_state_from_numpy(init)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tsm.fit_cavi_smoothed(tY, tp, st, max_iter=2, fused=True,
                              smoother="parallel")
    before = tfs.fused_smoother_kernel.launches
    par = tsm.fit_cavi_smoothed(tY, tp, st, max_iter=3, smoother="parallel")
    assert par.n_iter == 3
    assert tfs.fused_smoother_kernel.launches == before
    auto = tsm.fit_cavi_smoothed(tY, tp, st, max_iter=3, smoother="auto")
    seq = tsm.fit_cavi_smoothed(tY, tp, st, max_iter=3,
                                smoother="sequential")
    torch.testing.assert_close(auto.elbo_history, seq.elbo_history, rtol=0,
                               atol=0, equal_nan=True)
    np.testing.assert_allclose(par.elbo_history[:3].numpy(),
                               seq.elbo_history[:3].numpy(), rtol=1e-5)
