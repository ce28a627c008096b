"""Port parity for the dyadic likelihood families
(``tame_torch.models.likelihoods`` against ``tame.models.likelihoods``):
log-densities and VI surrogates on the same numpy inputs, the negative
binomial against scipy (the port has the exact log-pmf; ``tame``'s is low
by k log k per entry, ROADMAP C.4), sampling moments of both packages
against the families' means, the NaN-diagonal gating, the ``family=``
sampling keyword, and the exported names of both packages.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import tame.inference as jinf
import tame.models as jmod
from tame.config import ModelConfig as JaxModelConfig
from tame.models import likelihoods as jlk
from tame.models.params import build_params as jax_build_params
import tame_torch.inference as tinf
import tame_torch.models as tmod
from tame_torch.config import ModelConfig
from tame_torch.models import likelihoods as tlk
from tame_torch.models import build_params, params_from_numpy, sample

torch.set_num_threads(1)

# One float32 sum over a few hundred entries, in another order.
RTOL = 1e-5
# The negative binomial's log-pmf against scipy, in float64.
SCIPY_RTOL = 1e-5
# Sample means against the family mean: this many standard errors.
N_SE = 5.0

FAMILIES = {
    "gaussian": (jlk.GaussianDyadic(), tlk.GaussianDyadic()),
    "poisson": (jlk.PoissonDyadic(), tlk.PoissonDyadic()),
    "bernoulli": (jlk.BernoulliDyadic(), tlk.BernoulliDyadic()),
    "negbin": (jlk.NegativeBinomialDyadic(3.0),
               tlk.NegativeBinomialDyadic(3.0)),
}


@pytest.fixture(scope="module")
def problem():
    """n=10, T=3, r=1: parameters, a predictor, counts and binary ties,
    an observation gate with a fifth of the dyads hidden."""
    n, T = 10, 3
    p = jax_build_params(JaxModelConfig(n_nodes=n, n_time=T, latent_dim=1,
                                        seed=0))
    rng = np.random.default_rng(0)
    fwd = rng.normal(0.0, 1.2, (n, n, T)).astype(np.float32)
    mu = np.stack([fwd, fwd.transpose(1, 0, 2)], -1)
    counts = rng.poisson(2.0, (n, n, T)).astype(np.float32)
    ties = (rng.random((n, n, T)) < 0.4).astype(np.float32)
    off = (1.0 - np.eye(n, dtype=np.float32))[:, :, None]
    keep = np.triu((rng.random((n, n, T)) > 0.2).astype(np.float32)
                   .transpose(2, 0, 1), 1).transpose(1, 2, 0)
    mask = (keep + keep.transpose(1, 0, 2)) * off
    var = rng.uniform(0.05, 0.8, (n, n, T)).astype(np.float32)
    return p, mu, counts, ties, mask, var


def _data(kind, counts, ties, mu):
    y = {"gaussian": mu + 1.0, "bernoulli": ties}.get(kind, counts)
    if y.ndim == 3:
        y = np.stack([y, y.transpose(1, 0, 2)], -1)
    return y


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_log_prob_matches_tame(problem, kind):
    p, mu, counts, ties, mask, _ = problem
    jf, tf = FAMILIES[kind]
    Y = _data(kind, counts, ties, mu)
    ref = float(jf.log_prob(p, jnp.asarray(Y), jnp.asarray(mu),
                            jnp.asarray(mask)))
    got = float(tf.log_prob(params_from_numpy(p), torch.from_numpy(Y),
                            torch.from_numpy(mu), torch.from_numpy(mask)))
    if kind == "negbin":
        # C.4: the port adds the k log k per gated entry tame omits
        ref += 3.0 * math.log(3.0) * float(mask.sum())
    assert got == pytest.approx(ref, rel=RTOL)


@pytest.mark.parametrize("kind", ["poisson", "bernoulli", "negbin"])
def test_vi_surrogate_matches_tame(problem, kind):
    _, mu, counts, ties, mask, var = problem
    jf, tf = FAMILIES[kind]
    y0 = _data(kind, counts, ties, mu)[..., 0] * mask
    m = mu[..., 0]
    ref = jf.vi_surrogate(*(jnp.asarray(a) for a in (y0, mask, m, var)))
    got = tf.vi_surrogate(*(torch.from_numpy(a) for a in (y0, mask, m,
                                                           var)))
    shift = 3.0 * math.log(3.0) * float(mask.sum()) if kind == "negbin" \
        else 0.0
    assert float(got[0]) == pytest.approx(float(ref[0]) + shift, rel=RTOL)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("k", [0.5, 3.0, 10.0])
def test_negbin_log_pmf_matches_scipy(k):
    rng = np.random.default_rng(1)
    mu = rng.normal(0.5, 1.5, 400)
    y = rng.poisson(np.exp(mu) * rng.gamma(k, 1.0 / k, 400)).astype(float)
    fam = tlk.NegativeBinomialDyadic(k)
    got = fam._entry_log_prob(torch.from_numpy(y),
                              torch.from_numpy(mu)).numpy()
    ref = scipy.stats.nbinom.logpmf(y, k, k / (k + np.exp(mu)))
    np.testing.assert_allclose(got, ref, rtol=SCIPY_RTOL)


def test_negbin_differs_from_tame_by_exactly_k_log_k():
    """Per entry, in float64: the port minus tame is k log k."""
    jax.config.update("jax_enable_x64", True)
    try:
        rng = np.random.default_rng(2)
        y, mu = rng.poisson(3.0, 50).astype(float), rng.normal(0, 1, 50)
        for k in (0.5, 3.0, 10.0):
            got = tlk.NegativeBinomialDyadic(k)._entry_log_prob(
                torch.from_numpy(y), torch.from_numpy(mu)).numpy()
            ref = np.asarray(jlk.NegativeBinomialDyadic(k)._entry_log_prob(
                jnp.asarray(y), jnp.asarray(mu)))
            np.testing.assert_allclose(got - ref, k * math.log(k),
                                       rtol=1e-9, atol=1e-9)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_softplus_has_no_threshold():
    x = torch.tensor([-40.0, 0.0, 25.0, 60.0])
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(tlk.softplus(x).numpy(), ref, rtol=1e-7)


def test_nan_diag_gating():
    """A huge diagonal predictor must not NaN the Poisson log-density or
    its gradient (gated entries are replaced before exp overflows); the
    port of ``tests/test_inference.py::test_poisson_family_nan_diag_gating``
    through the family's ``log_prob`` and autograd."""
    from tame_torch.ops import dyad as dyad_ops

    p = build_params(ModelConfig(n_nodes=6, n_time=2, latent_dim=1, seed=0))
    Y, X = sample(p, torch.Generator().manual_seed(0), 6, 2,
                  family="poisson")
    Xb = X.clone()
    Xb[0, :, 2:] = 200.0
    Xb.requires_grad_(True)
    mask = dyad_ops.offdiag_mask(6)[:, :, None].expand(6, 6, 2)
    val = tlk.PoissonDyadic().log_prob(p, Y, dyad_ops.dyadic_mean_temporal(
        Xb, 1), mask)
    assert not torch.isnan(val)
    val.backward()
    assert not torch.isnan(Xb.grad).any()


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_sample_moments_match_family_and_tame(kind):
    """Both packages' draws at one predictor: reciprocal layout, zero
    diagonal, and entry means within N_SE standard errors of the family's
    (the Gaussian: residual variance R[0,0] and the dyad correlation)."""
    n, T = 60, 3
    p = jax_build_params(JaxModelConfig(n_nodes=n, n_time=T, latent_dim=1,
                                        seed=0))
    rng = np.random.default_rng(3)
    fwd = rng.normal(0.0, 0.7, (n, n, T)).astype(np.float32)
    mu = np.stack([fwd, fwd.transpose(1, 0, 2)], -1)
    jf, tf = FAMILIES[kind]
    Yj = np.asarray(jf.sample(jax.random.PRNGKey(4), p, jnp.asarray(mu)))
    Yt = tf.sample(torch.Generator().manual_seed(4), params_from_numpy(p),
                   torch.from_numpy(mu)).numpy()
    off = ~np.eye(n, dtype=bool)
    m = mu[..., 0][off]
    for Y in (Yj, Yt):
        assert Y.shape == (n, n, T, 2)
        np.testing.assert_array_equal(Y[..., 1], Y[..., 0].transpose(1, 0,
                                                                      2))
        assert np.all(Y[np.arange(n), np.arange(n)] == 0)
        y = Y[..., 0][off].astype(np.float64)
        if kind == "gaussian":
            e = Y[..., 0] - mu[..., 0]
            e = e[np.triu(np.ones((n, n), bool), 1)]
            f = (Y[..., 1] - mu[..., 1])[np.triu(np.ones((n, n), bool), 1)]
            s2, rho = float(p.R[0, 0]), float(p.R[0, 1] / p.R[0, 0])
            assert abs(e.mean()) < N_SE * math.sqrt(s2 / e.size)
            assert abs(e.var() / s2 - 1.0) < N_SE * math.sqrt(2.0 / e.size)
            assert abs(np.corrcoef(e.ravel(), f.ravel())[0, 1] - rho) \
                < N_SE / math.sqrt(e.size)
            continue
        mean = {"poisson": np.exp(m), "negbin": np.exp(m),
                "bernoulli": 1.0 / (1.0 + np.exp(-m))}[kind]
        var = {"poisson": mean, "negbin": mean + mean ** 2 / 3.0,
               "bernoulli": mean * (1.0 - mean)}[kind]
        assert abs(y.sum() - mean.sum()) < N_SE * math.sqrt(var.sum())
        if kind == "negbin":   # overdispersed: the Pearson ratio vs Poisson
            pearson = np.mean((y - mean) ** 2 / var)
            assert abs(pearson - 1.0) < 0.2


def test_family_keyword_of_sampling():
    p = build_params(ModelConfig(n_nodes=8, n_time=3, latent_dim=1, seed=0))
    g = torch.Generator().manual_seed(0)
    for fam, check in [("bernoulli", lambda y: set(y.unique().tolist())
                        <= {0.0, 1.0}),
                       ("poisson", lambda y: bool((y >= 0).all())
                        and torch.equal(y, y.round())),
                       (tlk.NegativeBinomialDyadic(2.0),
                        lambda y: bool((y >= 0).all()))]:
        Y, X = sample(p, g, 8, 3, family=fam)
        assert Y.shape == (8, 8, 3, 2) and X.shape == (8, 3, 4)
        assert check(Y) and torch.equal(Y[..., 1], Y[..., 0].transpose(0, 1))
    # the Gaussian default and family="gaussian" draw the same data
    a, _ = sample(p, torch.Generator().manual_seed(5), 8, 3)
    b, _ = sample(p, torch.Generator().manual_seed(5), 8, 3,
                  family="gaussian")
    assert torch.equal(a, b)


def test_get_family():
    assert isinstance(tlk.get_family("poisson"), tlk.PoissonDyadic)
    fam = tlk.NegativeBinomialDyadic(4.0)
    assert tlk.get_family(fam) is fam and fam.name == "negbin(k=4)"
    assert fam == tlk.NegativeBinomialDyadic(4.0)
    with pytest.raises(ValueError, match="unknown likelihood family"):
        tlk.get_family("banana")
    with pytest.raises(TypeError):
        tlk.get_family(object())
    with pytest.raises(ValueError, match="dispersion"):
        tlk.NegativeBinomialDyadic(0.0)


# ``tame.inference`` lacks nothing in the port since the samplers came
# over (ROADMAP A.6).
SAMPLER_NAMES = set()


@pytest.mark.parametrize("jax_pkg,port_pkg,missing", [
    (jinf, tinf, SAMPLER_NAMES), (jmod, tmod, set())])
def test_exports_cover_tame(jax_pkg, port_pkg, missing):
    lacking = set(jax_pkg.__all__) - set(port_pkg.__all__)
    assert lacking == missing
    assert all(hasattr(port_pkg, name) for name in port_pkg.__all__)
