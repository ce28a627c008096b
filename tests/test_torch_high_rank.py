"""Port parity at a rank past the unrolled kernels: an r = 6 (d = 14)
Good-SMF fit and smoothed fit go through ``tame`` (JAX, CPU) and
``tame_torch`` from the same numpy data, parameters and initial state, and
must stop on the same iteration with ELBO and MSE histories within 1e-4
relative (f32 reductions in another order, compounded over the fit; the
bound of the other fit parity tests).

On the card these fits run through the runtime-d K1/K2 and K4
(``tests/test_torch_kernels.py``, ``chip_smoke.py``); here both sides run
plain float32 code.  K3 keeps the JAX envelope d <= 12 in both packages.
"""

import jax.numpy as jnp
import numpy as np
import torch

import tame.config
from tame.inference import cavi as jcavi
from tame.inference import smoothed as jsm
from tame.models.params import build_params as jax_build_params
from tame.ops import fused_fit as jff
from tame.ops import fused_smoother as jfs
from tame_torch.inference import cavi as tcavi
from tame_torch.inference import smoothed as tsm
from tame_torch.models import params_from_numpy
from tame_torch.ops import cholesky as tchol
from tame_torch.ops import fused_fit as tff
from tame_torch.ops import fused_smoother as tfs

torch.set_num_threads(1)

R, D = 6, 14
RTOL_HIST = 1e-4


def _data(n, T, seed):
    """Numpy data in the reciprocal layout from rank-6 latents, JAX params
    and a numpy random init of the means."""
    rng = np.random.default_rng(seed)
    X = 0.8 * rng.standard_normal((n, T, D))
    fwd = (X[:, None, :, 0] + X[None, :, :, 1]
           + np.einsum("itr,jtr->ijt", X[..., 2:2 + R], X[..., 2 + R:]))
    y = fwd + 0.3 * rng.standard_normal((n, n, T))
    y[np.arange(n), np.arange(n)] = 0.0
    Y = np.stack([y, y.transpose(1, 0, 2)], -1).astype(np.float32)
    jp = jax_build_params(tame.config.ModelConfig(n_nodes=n, n_time=T,
                                                  latent_dim=R))
    X_mean = (0.1 * rng.standard_normal((n, T, D))).astype(np.float32)
    return Y, jp, X_mean


def _assert_fits_agree(tres, jres):
    assert tres.n_iter == int(jres.n_iter)
    assert tres.converged == bool(jres.converged)
    assert tres.diverged == bool(jres.diverged)
    for name in ("elbo_history", "mse_history"):
        t = getattr(tres, name).numpy()
        j = np.asarray(getattr(jres, name))
        assert np.isnan(t).tolist() == np.isnan(j).tolist(), name
        assert np.nanmax(np.abs(t - j) / np.abs(j)) < RTOL_HIST, name


def test_good_smf_fit_matches_jax():
    n, T = 16, 5
    Y, jp, X_mean = _data(n, T, seed=1)
    X_cov = np.broadcast_to(0.6 * np.eye(D, dtype=np.float32),
                            (n, T, D, D)).copy()
    js = jcavi.CaviState(X_mean=jnp.asarray(X_mean), X_cov=jnp.asarray(X_cov))
    kw = dict(structure="full", update_mode="block", num_blocks=4,
              max_iter=60, learning_rate=0.5, tolerance=1e-3)
    jres = jcavi.fit_cavi(jnp.asarray(Y), jp, js, **kw)
    tres = tcavi.fit_cavi(torch.from_numpy(Y), params_from_numpy(jp),
                          tcavi.state_from_numpy(js), **kw)
    assert tres.converged and tres.n_iter < 60
    _assert_fits_agree(tres, jres)


def test_smoothed_fit_matches_jax():
    """The JAX fit leaves its Pallas smoother for the scan at d > 12; the
    port's fit keeps K4 (its twin here), which solves the same system."""
    n, T = 8, 4
    Y, jp, X_mean = _data(n, T, seed=2)
    js = jsm.SmoothedState(
        X_mean=jnp.asarray(X_mean),
        X_cov=jnp.broadcast_to(0.5 * jnp.eye(D), (n, T, D, D)),
        X_cross=jnp.zeros((n, T - 1, D, D)),
        logdets=jnp.full((n,), -T * D * np.log(0.5), jnp.float32))
    kw = dict(max_iter=60, learning_rate=0.8, tolerance=1e-3,
              update_mode="block", num_blocks=2)
    jres = jsm.fit_cavi_smoothed(jnp.asarray(Y), jp, js, **kw)
    tres = tsm.fit_cavi_smoothed(torch.from_numpy(Y), params_from_numpy(jp),
                                 tsm.smoothed_state_from_numpy(js), **kw)
    assert tres.converged and tres.n_iter < 60
    _assert_fits_agree(tres, jres)


def test_envelopes_at_d14():
    """K3 stays at d <= 12 in both packages; K1, K2 and K4 take d = 14 in
    the port (the JAX solve and logdet kernels unroll for any d; its
    smoother envelope stops at 12, where its fit takes the scan)."""
    kw = dict(structure="full", update_mode="block", diag_mode="exact",
              mixed_precision=False, elbo_every=1, num_blocks=5)
    assert not jff.fused_fit_supported(10, 4, D, **kw)
    assert not tff.fused_fit_supported(10, 4, D, **kw)
    assert tff.fused_fit_supported(10, 4, 12, **kw)
    assert tchol.kernel_supports_d(D)
    assert tfs.fused_smoother_supported(2000, 50, D)
    assert not jfs.fused_smoother_supported(2000, 50, D)
