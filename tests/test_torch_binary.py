"""Port parity for the JJ-bound binary engine
(``tame_torch.inference.binary_cavi`` against ``tame.inference.binary_cavi``):
the predictor moments and the weighted observation terms on the same numpy
state, the exact natural gradient (autograd in float64), whole fits from
one numpy init (dense and masked: the same stop, the bound within 1e-4 at
every iteration), NaN-coded hidden dyads, the engine class, warm init,
forecasts and checkpointed fits (bit for bit within the port, and a
``tame`` checkpoint resumed by the port).  The engine keeps its (n, n, T)
quantities time-major, (T, n, n); the tests permute ``tame``'s.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tame.config import ModelConfig as JaxModelConfig
from tame.inference import TemporalAMEBernoulliVI as JaxBernoulliVI
from tame.inference import binary_cavi as jbc
from tame.inference import cavi as jcavi
from tame.models import TemporalAMEModel as JaxModel
from tame.models import build_params as jax_build_params
from tame.models import random_dyad_mask as jax_random_dyad_mask
from tame.models import sample as jax_sample
from tame.models import sample_observations as jax_sample_observations
from tame.ops import dyad as jdyad
from tame_torch.config import ModelConfig
from tame_torch.inference import TemporalAMEBernoulliVI, fit_cavi_bernoulli
from tame_torch.inference import binary_cavi as tbc
from tame_torch.inference import cavi as tcavi
from tame_torch.models import (TemporalAMEModel, build_params,
                               params_from_numpy, random_dyad_mask,
                               sample, sample_observations)
from tame_torch.ops import dyad as tdyad

torch.set_num_threads(1)

# Sums over n = 12 partners in float32, in another order.
TERMS_RTOL = 1e-5
# Whole fits: the bound at every iteration, relative, and the dyadic
# means, against max |.|.
ELBO_RTOL = 1e-4
MEAN_REL = 1e-4
# The natural gradient against autograd, float64, relative to max |g|.
GRAD_REL = 1e-8


def random_state(n, T, r, seed, dtype=np.float32):
    """A mean-field state with SPD covariances, as numpy."""
    rng = np.random.default_rng(seed)
    d = 2 + 2 * r
    X_mean = 0.3 * rng.normal(size=(n, T, d))
    A = 0.2 * rng.normal(size=(n, T, d, d))
    X_cov = np.einsum("ntab,ntcb->ntac", A, A) + 0.3 * np.eye(d)
    return X_mean.astype(dtype), X_cov.astype(dtype)


def to_port(X_mean, X_cov, dtype=torch.float32):
    return tcavi.CaviState(torch.tensor(X_mean, dtype=dtype),
                           torch.tensor(X_cov, dtype=dtype))


def t_major(x):
    """(n, n, T) numpy -> the engine's (T, n, n) tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(2, 0, 1)))


def jax_data(n=12, T=4, seed=2, family="bernoulli"):
    p = jax_build_params(JaxModelConfig(n_nodes=n, n_time=T, latent_dim=1,
                                        seed=seed))
    Y, X = jax_sample(p, jax.random.PRNGKey(seed), n, T, family=family)
    init = jcavi.init_state(jax.random.PRNGKey(1), n, T, 4, "full", 0.1,
                            0.5)
    return p, np.asarray(Y), np.asarray(X), init


@pytest.mark.parametrize("r", [1, 2])
def test_predictor_moments_match_tame(r):
    mu, cov = random_state(9, 3, r, seed=r)
    m_ref, v_ref = jbc._predictor_moments(
        jcavi.CaviState(jnp.asarray(mu), jnp.asarray(cov)), r)
    m, v = tbc._predictor_moments(to_port(mu, cov), r)
    for got, ref in ((m, m_ref), (v, v_ref)):
        np.testing.assert_allclose(tbc.public_layout(got).numpy(),
                                   np.asarray(ref), rtol=TERMS_RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("with_cov", [False, True])
@pytest.mark.parametrize("r", [1, 2])
def test_weighted_obs_terms_match_tame(r, with_cov):
    n, T = 12, 3
    mu, cov = random_state(n, T, r, seed=4)
    rng = np.random.default_rng(5)
    w = rng.uniform(0.0, 2.0, (n, n, T)).astype(np.float32)
    s = rng.normal(size=(n, n, T)).astype(np.float32)
    off = (1.0 - np.eye(n, dtype=np.float32))[:, :, None]
    w, s = w * off, s * off
    P_ref, eta_ref = jbc.weighted_obs_terms(
        jnp.asarray(mu), r, jnp.asarray(w), jnp.asarray(s),
        cov=jnp.asarray(cov) if with_cov else None)
    P, eta = tbc.weighted_obs_terms(
        torch.from_numpy(mu), r, t_major(w), t_major(s),
        cov=torch.from_numpy(cov) if with_cov else None)
    for got, ref in ((P, P_ref), (eta, eta_ref)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=TERMS_RTOL,
                                   atol=TERMS_RTOL * np.abs(ref).max())


def test_solve_direct_matches_tame():
    rng = np.random.default_rng(6)
    A = rng.normal(size=(20, 6, 6)).astype(np.float32)
    P = A @ A.transpose(0, 2, 1) + 1e3 * np.eye(6, dtype=np.float32)
    eta = rng.normal(size=(20, 6)).astype(np.float32)
    ref = jbc.solve_direct(jnp.asarray(P), jnp.asarray(eta))
    got = tbc.solve_direct(torch.from_numpy(P), torch.from_numpy(eta))
    for g, r_ in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r_), rtol=1e-5,
                                   atol=1e-9)


def port_sample(p, n, T, family, seed=1):
    """Port data drawn on the CPU (the gradient checks need no parity)."""
    return sample(p.to(dtype=torch.float32),
                  torch.Generator().manual_seed(seed), n, T, family=family)


def test_bernoulli_gradient_matches_autograd():
    """The update's implied direction ``eta - P mu`` is the exact gradient
    of the bound with respect to the means (the envelope property at the
    xi-optimal point, and the second-order partner-covariance terms of
    ``weighted_obs_terms``): the port of
    ``TestWeightedUpdateGradientExactness``, autograd in float64."""
    n, T, r = 10, 3, 1
    f64 = torch.float64
    p = build_params(ModelConfig(n_nodes=n, n_time=T, latent_dim=r,
                                 seed=1)).to(dtype=f64)
    Y, _ = port_sample(p, n, T, "bernoulli")
    mu0, cov0 = random_state(n, T, r, seed=1, dtype=np.float64)
    st = to_port(mu0, cov0, f64)
    fi = tbc.family_inputs(Y.to(f64))
    pri = tcavi.precompute_priors(p)

    def bound_of(mu):
        return tbc.bernoulli_step(tcavi.CaviState(mu, st.X_cov), fi.y0,
                                  fi.offd, pri, p, 1.0)[1]

    mu = st.X_mean.clone().requires_grad_(True)
    g, = torch.autograd.grad(bound_of(mu), mu)

    m, var = tbc._predictor_moments(st, r)
    xi = torch.sqrt(torch.clamp(m * m + var, min=1e-12))
    lam = tbc._lam(xi) * fi.offd
    P, eta = tbc.weighted_obs_terms(st.X_mean, r, 2.0 * lam,
                                    (fi.y0 - 0.5) * fi.offd, cov=st.X_cov)
    P = P + tcavi._prior_precision(pri, T)[None]
    eta = eta + tcavi._prior_nat_param(pri, st.X_mean)
    implied = eta - torch.einsum("ntab,ntb->nta", P, st.X_mean)
    assert (implied - g).abs().max() < GRAD_REL * g.abs().max()


def _nan_coded(Y, mask):
    return np.where(np.asarray(mask)[..., None] == 0, np.nan, Y)


@pytest.mark.parametrize("masked", [False, True])
def test_fit_matches_tame(masked):
    p, Y, _, init = jax_data()
    mask = (np.asarray(jax_random_dyad_mask(jax.random.PRNGKey(5), 12, 4,
                                            0.3)) if masked else None)
    kw = dict(max_iter=80, learning_rate=0.8, tolerance=1e-5)
    ref = jbc.fit_cavi_bernoulli(jnp.asarray(Y), p, init, mask=None
                                 if mask is None else jnp.asarray(mask),
                                 **kw)
    got = fit_cavi_bernoulli(torch.from_numpy(Y), params_from_numpy(p),
                             tcavi.state_from_numpy(init),
                             mask=None if mask is None
                             else torch.from_numpy(mask), **kw)
    k = int(ref.n_iter)
    assert (got.n_iter, got.converged, got.diverged) == (
        k, bool(ref.converged), bool(ref.diverged))
    for name in ("elbo_history", "accuracy_history"):
        np.testing.assert_allclose(getattr(got, name)[:k].numpy(),
                                   np.asarray(getattr(ref, name))[:k],
                                   rtol=ELBO_RTOL)
    m_ref = np.asarray(jdyad.dyadic_fwd_temporal(ref.X_mean, 1))
    m_got = tdyad.dyadic_fwd_temporal(got.X_mean, 1).numpy()
    assert np.abs(m_got - m_ref).max() <= MEAN_REL * np.abs(m_ref).max()


def test_masked_entries_never_read():
    p, Y, _, init = jax_data()
    mask = random_dyad_mask(torch.Generator().manual_seed(5), 12, 4, 0.3)
    kw = dict(max_iter=30, learning_rate=0.8, tolerance=0.0, mask=mask)
    args = (params_from_numpy(p), tcavi.state_from_numpy(init))
    a = fit_cavi_bernoulli(torch.from_numpy(Y), *args, **kw)
    b = fit_cavi_bernoulli(torch.from_numpy(_nan_coded(Y, mask.numpy())),
                           *args, **kw)
    assert torch.equal(a.X_mean, b.X_mean) and torch.equal(a.X_cov, b.X_cov)
    assert not torch.equal(a.X_mean, fit_cavi_bernoulli(
        torch.from_numpy(Y), *args, max_iter=30, tolerance=0.0).X_mean)


def port_model(n, T, seed, family, data_seed):
    model = TemporalAMEModel(n_nodes=n, n_time=T, latent_dim=1, seed=seed,
                             device="cpu")
    model.generate_data(generator=torch.Generator().manual_seed(seed))
    model.Y = sample_observations(model.params,
                                  torch.Generator().manual_seed(data_seed),
                                  model.X, family=family)
    return model


def test_warm_init_beats_random():
    model = port_model(12, 4, 0, "bernoulli", 1)
    hw = TemporalAMEBernoulliVI(model, init_mode="warm").fit(
        max_iter=40, tolerance=0.0, verbose=False)
    hr = TemporalAMEBernoulliVI(model, init_mode="random").fit(
        max_iter=40, tolerance=0.0, verbose=False)
    assert hw["elbo"][-1] >= hr["elbo"][-1] - 1.0
    assert hw["elbo"][5] > hr["elbo"][5]
    with pytest.raises(ValueError, match="init_mode"):
        TemporalAMEBernoulliVI(model, init_mode="bogus")


def test_engine_class_and_forecasts():
    """The engine's surface, and the forecast surface of
    ``test_nongaussian_forecast_surface``: AR(1) forecasts contract toward
    the prior mean, probabilities stay in [0, 1]."""
    model = port_model(12, 4, 7, "bernoulli", 8)
    vi = TemporalAMEBernoulliVI(model)
    h = vi.fit(max_iter=60, verbose=False)
    assert set(h) == {"elbo", "accuracy"}
    assert np.isfinite(h["elbo"]).all() and len(h["elbo"]) == len(
        h["accuracy"])
    proba = vi.predict_proba().numpy()
    assert proba.shape == (12, 12, 4)
    assert np.all((proba >= 0) & (proba <= 1))
    y0 = model.Y[..., 0].numpy()
    off = ~np.eye(12, dtype=bool)
    assert proba[off][y0[off] > 0.5].mean() \
        > proba[off][y0[off] < 0.5].mean() + 0.1
    assert vi.get_variational_means() is vi.X_mean
    assert vi.get_variational_covariances().shape == (12, 4, 4, 4)
    Xf = vi.predict_forward(3).numpy()
    assert Xf.shape == (12, 3, 4)
    assert np.linalg.norm(Xf[:, 2]) < np.linalg.norm(Xf[:, 0]) + 1e-6
    pf = vi.predict_proba_forward(3).numpy()
    assert pf.shape == (12, 12, 3) and np.all((pf >= 0) & (pf <= 1))


def test_segmented_checkpoint_resume_is_bitwise(tmp_path):
    model = port_model(10, 4, 3, "bernoulli", 4)
    a = TemporalAMEBernoulliVI(model, seed=3)
    ha = a.fit(max_iter=40, tolerance=1e-5, verbose=False)
    td = tmp_path / "ck"
    TemporalAMEBernoulliVI(model, seed=3).fit(
        max_iter=15, tolerance=1e-5, verbose=False, checkpoint_every=7,
        ckpt_dir=td)
    c = TemporalAMEBernoulliVI(model, seed=3)
    c.fit(max_iter=40, tolerance=1e-5, verbose=False, checkpoint_every=7,
          ckpt_dir=td, resume=True)
    assert c.history == ha
    assert torch.equal(a.X_mean, c.X_mean) and torch.equal(a.X_cov, c.X_cov)
    assert (a._carry_elbo, a._carry_pat) == (c._carry_elbo, c._carry_pat)


def test_port_resumes_a_tame_checkpoint(tmp_path):
    """The JAX engine checkpoints 14 iterations; the port resumes to 40;
    the result follows the JAX engine's uninterrupted fit."""
    jm = JaxModel(n_nodes=10, n_time=4, latent_dim=1, seed=3)
    jm.generate_data()
    jm.Y = np.asarray(jax_sample_observations(
        jm.params, jax.random.PRNGKey(4), jm.X, family="bernoulli"))
    ref = JaxBernoulliVI(jm, seed=3)
    href = ref.fit(max_iter=40, tolerance=1e-5, verbose=False)
    td = tmp_path / "ck"
    JaxBernoulliVI(jm, seed=3).fit(max_iter=14, tolerance=1e-5,
                                   verbose=False, checkpoint_every=7,
                                   ckpt_dir=str(td))
    pm = types.SimpleNamespace(Y=torch.from_numpy(jm.Y),
                               params=params_from_numpy(jm.params), n=10,
                               T=4, d=4, r=1)
    vi = TemporalAMEBernoulliVI(pm, seed=3)
    h = vi.fit(max_iter=40, tolerance=1e-5, verbose=False,
               checkpoint_every=7, ckpt_dir=td, resume=True)
    assert len(h["elbo"]) == len(href["elbo"])
    np.testing.assert_allclose(h["elbo"], href["elbo"], rtol=ELBO_RTOL)
    m_ref = np.asarray(jdyad.dyadic_fwd_temporal(ref.X_mean, 1))
    m_got = tdyad.dyadic_fwd_temporal(vi.X_mean, 1).numpy()
    assert np.abs(m_got - m_ref).max() <= MEAN_REL * np.abs(m_ref).max()
