"""Port parity for the guarded Poisson CVI engine
(``tame_torch.inference.poisson_cavi`` against
``tame.inference.poisson_cavi``): the exact natural gradient (autograd in
float64), whole fits from one numpy init (dense and masked: the same stop,
the same rejected iterations, the ELBO within 1e-4 at every iteration),
the guard rescuing a fit the unguarded update loses, NaN-coded hidden
dyads, the engine class, warm init, forecasts and checkpointed fits (bit
for bit within the port, a ``tame`` checkpoint and a ``tame`` carry
resumed by the port).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tame.config import ModelConfig as JaxModelConfig
from tame.inference import TemporalAMEPoissonVI as JaxPoissonVI
from tame.inference import cavi as jcavi
from tame.inference import poisson_cavi as jpc
from tame.models import TemporalAMEModel as JaxModel
from tame.models import build_params as jax_build_params
from tame.models import random_dyad_mask as jax_random_dyad_mask
from tame.models import sample as jax_sample
from tame.models import sample_observations as jax_sample_observations
from tame.ops import dyad as jdyad
from tame_torch.config import ModelConfig
from tame_torch.inference import TemporalAMEPoissonVI, fit_cavi_poisson
from tame_torch.inference import binary_cavi as tbc
from tame_torch.inference import cavi as tcavi
from tame_torch.inference import poisson_cavi as tpc
from tame_torch.models import (TemporalAMEModel, build_params,
                               params_from_numpy, random_dyad_mask, sample,
                               sample_observations)
from tame_torch.ops import dyad as tdyad

torch.set_num_threads(1)

# Whole fits: the ELBO at every iteration, relative, and the dyadic means,
# against max |.|.
ELBO_RTOL = 1e-4
MEAN_REL = 1e-4
# The natural gradient against autograd, float64, relative to max |g|.
GRAD_REL = 1e-8


def jax_data(n=12, T=4, seed=2):
    p = jax_build_params(JaxModelConfig(n_nodes=n, n_time=T, latent_dim=1,
                                        seed=seed))
    Y, _ = jax_sample(p, jax.random.PRNGKey(seed), n, T, family="poisson")
    init = jcavi.init_state(jax.random.PRNGKey(1), n, T, 4, "full", 0.1,
                            0.5)
    return p, np.asarray(Y), init


def rejected(deviance_history, k):
    return np.flatnonzero(np.isnan(np.asarray(deviance_history)[:k]))


def assert_fits_agree(got, ref):
    """The same stop and rejected iterations, the ELBO within ELBO_RTOL at
    every iteration, the dyadic means within MEAN_REL."""
    k = int(ref.n_iter)
    assert (got.n_iter, got.converged, got.diverged) == (
        k, bool(ref.converged), bool(ref.diverged))
    np.testing.assert_array_equal(rejected(got.deviance_history, k),
                                  rejected(ref.deviance_history, k))
    np.testing.assert_allclose(got.elbo_history[:k].numpy(),
                               np.asarray(ref.elbo_history)[:k],
                               rtol=ELBO_RTOL)
    m_ref = np.asarray(jdyad.dyadic_fwd_temporal(ref.X_mean, 1))
    m_got = tdyad.dyadic_fwd_temporal(got.X_mean, 1).numpy()
    assert np.abs(m_got - m_ref).max() <= MEAN_REL * np.abs(m_ref).max()


def test_poisson_gradient_matches_autograd():
    """``eta - P mu`` of the CVI update is the exact gradient of the ELBO
    with respect to the means (the second-order partner-covariance terms
    of ``weighted_obs_terms`` included): the port of
    ``TestWeightedUpdateGradientExactness``, autograd in float64."""
    n, T, r = 10, 3, 1
    f64 = torch.float64
    p = build_params(ModelConfig(n_nodes=n, n_time=T, latent_dim=r, seed=0))
    Y, _ = sample(p, torch.Generator().manual_seed(0), n, T,
                  family="poisson")
    p = p.to(dtype=f64)
    rng = np.random.default_rng(0)
    X_mean = torch.tensor(0.3 * rng.normal(size=(n, T, 4)), dtype=f64)
    A = torch.tensor(0.2 * rng.normal(size=(n, T, 4, 4)), dtype=f64)
    X_cov = A @ A.transpose(-1, -2) + 0.3 * torch.eye(4, dtype=f64)
    fi = tbc.family_inputs(Y.to(f64))
    logyfac = torch.lgamma(fi.y0 + 1.0)
    pri = tcavi.precompute_priors(p)

    mu = X_mean.clone().requires_grad_(True)
    elbo = tpc._evaluate(tcavi.CaviState(mu, X_cov), fi.y0, logyfac,
                         fi.offd, pri, p)[0]
    g, = torch.autograd.grad(elbo, mu)

    st = tcavi.CaviState(X_mean, X_cov)
    _, _, m, var = tpc._evaluate(st, fi.y0, logyfac, fi.offd, pri, p)
    w = tpc._weights(m, var, fi.offd)
    P, eta = tbc.weighted_obs_terms(X_mean, r, w,
                                    (fi.y0 - w + w * m) * fi.offd,
                                    cov=X_cov)
    P = P + tcavi._prior_precision(pri, T)[None]
    eta = eta + tcavi._prior_nat_param(pri, X_mean)
    implied = eta - torch.einsum("ntab,ntb->nta", P, X_mean)
    assert (implied - g).abs().max() < GRAD_REL * g.abs().max()


@pytest.mark.parametrize("masked", [False, True])
def test_fit_matches_tame(masked):
    p, Y, init = jax_data()
    mask = (np.asarray(jax_random_dyad_mask(jax.random.PRNGKey(5), 12, 4,
                                            0.3)) if masked else None)
    kw = dict(max_iter=120, learning_rate=0.7, tolerance=1e-5)
    ref = jpc.fit_cavi_poisson(jnp.asarray(Y), p, init, mask=None
                               if mask is None else jnp.asarray(mask), **kw)
    got = fit_cavi_poisson(torch.from_numpy(Y), params_from_numpy(p),
                           tcavi.state_from_numpy(init), mask=None
                           if mask is None else torch.from_numpy(mask), **kw)
    assert_fits_agree(got, ref)
    assert len(rejected(got.deviance_history, got.n_iter)) > 0


def test_guard_rescues_jacobi_divergence():
    """``TestPoissonCVI::test_guard_rescues_jacobi_divergence``'s data, on
    which the unguarded damped update diverges: the port's guarded loop
    converges as ``tame``'s does, rejecting the same iterations, with the
    ELBO within ELBO_RTOL at every iteration both run.

    The stop iteration is not compared here: at tolerance 1e-6 the last
    hundred iterations gain ~1e-6 of the ELBO each, the float32 rounding of
    its sum, so the two packages' sums in another order stop at different
    iterations (measured: 436 and 464, final ELBOs 3e-5 apart)."""
    p, Y, init = jax_data(n=14, T=4, seed=2)
    kw = dict(max_iter=500, learning_rate=0.7, tolerance=1e-6)
    ref = jpc.fit_cavi_poisson(jnp.asarray(Y), p, init, **kw)
    got = fit_cavi_poisson(torch.from_numpy(Y), params_from_numpy(p),
                           tcavi.state_from_numpy(init), **kw)
    assert got.converged and not got.diverged and bool(ref.converged)
    assert np.isfinite(got.elbo_history[:got.n_iter].numpy()).all()
    k = min(got.n_iter, int(ref.n_iter))
    np.testing.assert_array_equal(rejected(got.deviance_history, k),
                                  rejected(ref.deviance_history, k))
    np.testing.assert_allclose(got.elbo_history[:k].numpy(),
                               np.asarray(ref.elbo_history)[:k],
                               rtol=ELBO_RTOL)
    assert got.last_elbo == pytest.approx(float(ref.last_elbo),
                                          rel=ELBO_RTOL)
    # the unguarded update from the same init collapses the ELBO by five
    # orders of magnitude (measured -1.6e4 -> -7.1e9; the exp clamp keeps
    # it finite): the step the guard rejects
    fi = tbc.family_inputs(torch.from_numpy(Y))
    pp = params_from_numpy(p)
    pri = tcavi.precompute_priors(pp)
    logyfac = torch.lgamma(fi.y0 + 1.0)
    st, e0, _ = tpc.poisson_step(tcavi.state_from_numpy(init), fi.y0,
                                 logyfac, fi.offd, pri, pp, 0.7)
    _, e1, _ = tpc.poisson_step(st, fi.y0, logyfac, fi.offd, pri, pp, 0.7)
    assert float(e1) < 1e3 * float(e0)


def test_masked_entries_never_read():
    p, Y, init = jax_data()
    mask = random_dyad_mask(torch.Generator().manual_seed(5), 12, 4, 0.3)
    Yg = np.where(mask.numpy()[..., None] == 0, np.nan, Y)
    kw = dict(max_iter=30, learning_rate=0.7, tolerance=0.0, mask=mask)
    args = (params_from_numpy(p), tcavi.state_from_numpy(init))
    a = fit_cavi_poisson(torch.from_numpy(Y), *args, **kw)
    b = fit_cavi_poisson(torch.from_numpy(Yg), *args, **kw)
    assert torch.equal(a.X_mean, b.X_mean) and torch.equal(a.X_cov, b.X_cov)


def port_model(n, T, seed, data_seed):
    model = TemporalAMEModel(n_nodes=n, n_time=T, latent_dim=1, seed=seed,
                             device="cpu")
    model.generate_data(generator=torch.Generator().manual_seed(seed))
    model.Y = sample_observations(model.params,
                                  torch.Generator().manual_seed(data_seed),
                                  model.X, family="poisson")
    return model


def test_warm_init_beats_random():
    model = port_model(12, 4, 0, 1)
    hw = TemporalAMEPoissonVI(model, init_mode="warm").fit(
        max_iter=40, tolerance=0.0, verbose=False)
    hr = TemporalAMEPoissonVI(model, init_mode="random").fit(
        max_iter=40, tolerance=0.0, verbose=False)
    assert hw["elbo"][-1] >= hr["elbo"][-1] - 1.0
    assert hw["elbo"][5] > hr["elbo"][5]


def test_engine_class_and_forecasts():
    """The engine's surface and the forecast surface of
    ``test_nongaussian_forecast_surface``."""
    model = port_model(12, 4, 7, 8)
    vi = TemporalAMEPoissonVI(model)
    h = vi.fit(max_iter=60, verbose=False)
    assert set(h) == {"elbo", "deviance"}
    assert np.isfinite(h["elbo"]).all()
    rate = vi.predict_rate().numpy()
    assert rate.shape == (12, 12, 4) and np.all(rate >= 0)
    y0 = model.Y[..., 0].numpy()
    off = ~np.eye(12, dtype=bool)
    assert np.corrcoef(rate[off].ravel(), y0[off].ravel())[0, 1] > 0.5
    Xf = vi.predict_forward(3).numpy()
    assert Xf.shape == (12, 3, 4)
    assert np.linalg.norm(Xf[:, 2]) < np.linalg.norm(Xf[:, 0]) + 1e-6
    rf = vi.predict_rate_forward(3).numpy()
    assert rf.shape == (12, 12, 3) and np.all(rf >= 0)


def test_predict_rate_matches_tame():
    p, Y, init = jax_data()
    jm = types.SimpleNamespace(Y=Y, params=p, n=12, T=4, d=4, r=1)
    ref = JaxPoissonVI(jm, init_mode="random")
    ref.X_mean, ref.X_cov = init.X_mean, init.X_cov
    pm = types.SimpleNamespace(Y=torch.from_numpy(Y),
                               params=params_from_numpy(p), n=12, T=4, d=4,
                               r=1)
    vi = TemporalAMEPoissonVI(pm, init_mode="random")
    vi.X_mean = torch.from_numpy(np.asarray(init.X_mean))
    vi.X_cov = torch.from_numpy(np.asarray(init.X_cov))
    np.testing.assert_allclose(vi.predict_rate().numpy(),
                               np.asarray(ref.predict_rate()), rtol=1e-5)
    np.testing.assert_allclose(vi.predict_rate_forward(2).numpy(),
                               np.asarray(ref.predict_rate_forward(2)),
                               rtol=1e-5)


def test_segmented_checkpoint_resume_is_bitwise(tmp_path):
    """The checkpoint carries the guarded loop's proposal and step scale:
    a fit killed after 15 iterations and resumed is the uninterrupted fit,
    bit for bit."""
    model = port_model(10, 4, 3, 4)
    a = TemporalAMEPoissonVI(model, seed=3)
    ha = a.fit(max_iter=40, tolerance=1e-5, verbose=False)
    td = tmp_path / "ck"
    TemporalAMEPoissonVI(model, seed=3).fit(
        max_iter=15, tolerance=1e-5, verbose=False, checkpoint_every=7,
        ckpt_dir=td)
    c = TemporalAMEPoissonVI(model, seed=3)
    c.fit(max_iter=40, tolerance=1e-5, verbose=False, checkpoint_every=7,
          ckpt_dir=td, resume=True)
    np.testing.assert_array_equal(c.history["elbo"], ha["elbo"])
    np.testing.assert_array_equal(c.history["deviance"], ha["deviance"])
    assert torch.equal(a.X_mean, c.X_mean) and torch.equal(a.X_cov, c.X_cov)
    for x, y in zip(a._carry, c._carry):
        assert (torch.equal(x.X_mean, y.X_mean)
                and torch.equal(x.X_cov, y.X_cov)
                if isinstance(x, tcavi.CaviState) else x == y)


def test_port_continues_tame_segments(tmp_path):
    """A ``tame`` checkpoint (14 iterations) resumed by the port engine,
    and a ``tame`` carry passed to the port's ``fit_cavi_poisson``: both
    follow ``tame``'s uninterrupted fit."""
    jm = JaxModel(n_nodes=10, n_time=4, latent_dim=1, seed=3)
    jm.generate_data()
    jm.Y = np.asarray(jax_sample_observations(
        jm.params, jax.random.PRNGKey(4), jm.X, family="poisson"))
    ref = JaxPoissonVI(jm, seed=3)
    href = ref.fit(max_iter=40, tolerance=1e-5, verbose=False)
    td = tmp_path / "ck"
    JaxPoissonVI(jm, seed=3).fit(max_iter=14, tolerance=1e-5,
                                 verbose=False, checkpoint_every=7,
                                 ckpt_dir=str(td))
    pm = types.SimpleNamespace(Y=torch.from_numpy(jm.Y),
                               params=params_from_numpy(jm.params), n=10,
                               T=4, d=4, r=1)
    vi = TemporalAMEPoissonVI(pm, seed=3)
    h = vi.fit(max_iter=40, tolerance=1e-5, verbose=False,
               checkpoint_every=7, ckpt_dir=td, resume=True)
    assert len(h["elbo"]) == len(href["elbo"])
    np.testing.assert_allclose(h["elbo"], href["elbo"], rtol=ELBO_RTOL)
    m_ref = np.asarray(jdyad.dyadic_fwd_temporal(ref.X_mean, 1))
    m_got = tdyad.dyadic_fwd_temporal(vi.X_mean, 1).numpy()
    assert np.abs(m_got - m_ref).max() <= MEAN_REL * np.abs(m_ref).max()

    # the same through the functions and resume_carry
    Y = jnp.asarray(jm.Y)
    st = jcavi.init_state(jax.random.PRNGKey(1), 10, 4, 4, "full", 0.1, 0.5)
    one = jpc.fit_cavi_poisson(Y, jm.params, st, max_iter=30,
                               tolerance=0.0)
    seg = jpc.fit_cavi_poisson(Y, jm.params, st, max_iter=12,
                               tolerance=0.0)
    got = fit_cavi_poisson(torch.from_numpy(jm.Y), pm.params,
                           tcavi.state_from_numpy(seg), max_iter=18,
                           tolerance=0.0,
                           carry=tpc.resume_carry_from_numpy(
                               seg.resume_carry()))
    np.testing.assert_allclose(got.elbo_history[:18].numpy(),
                               np.asarray(one.elbo_history)[12:30],
                               rtol=ELBO_RTOL)
    assert got.step_scale == pytest.approx(float(one.step_scale))
