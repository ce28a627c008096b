"""Port parity for the joint log-density (``tame_torch.inference.logprob``):
the same numpy ``Y``, mask and latents go through ``tame.inference.logprob``
(JAX, CPU; gradients by ``jax.grad``) and the port (gradients by autograd),
and a batch of latents is held to a loop over its entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tame.config
from tame.inference import logprob as jlp
from tame.models import likelihoods as jlk
from tame.models.params import build_params as jax_build_params
from tame_torch.inference import logprob as tlp
from tame_torch.models import likelihoods as tlk
from tame_torch.models import params_from_numpy

torch.set_num_threads(1)

RTOL = 1e-5   # f32 sums of n^2 T terms in another order
K = 3.0       # negative-binomial dispersion


def _setup(n=9, T=4, r=2, seed=0):
    """Numpy data for every family (reciprocal layout, zero diagonal), a
    symmetric 30 %-hidden mask, 3 latent states and both packages' params."""
    rng = np.random.default_rng(seed)
    d = 2 + 2 * r
    X = (0.7 * rng.standard_normal((3, n, T, d))).astype(np.float32)
    fwd = (X[0, :, None, :, 0] + X[0, None, :, :, 1]
           + np.einsum("itr,jtr->ijt", X[0, ..., 2:2 + r], X[0, ..., 2 + r:]))

    def recip(y):
        y = y.astype(np.float32)
        y[np.arange(n), np.arange(n)] = 0.0
        return np.stack([y, y.transpose(1, 0, 2)], -1)

    gauss = fwd + 0.3 * rng.standard_normal((n, n, T))
    gauss = np.triu(gauss.transpose(2, 0, 1), 1).transpose(1, 2, 0)
    data = {
        "gaussian": recip(gauss + gauss.transpose(1, 0, 2)),
        "poisson": recip(rng.poisson(np.exp(np.clip(fwd, -3, 2)))),
        "bernoulli": recip((rng.random((n, n, T)) < 0.4) * 1.0),
        "negbin": recip(rng.poisson(np.exp(np.clip(fwd, -3, 2)))),
    }
    m = (rng.random((n, n, T)) > 0.3).astype(np.float32)
    m = np.triu(m.transpose(2, 0, 1), 1).transpose(1, 2, 0)
    jp = jax_build_params(tame.config.ModelConfig(n_nodes=n, n_time=T,
                                                  latent_dim=r))
    return data, m + m.transpose(1, 0, 2), X, jp


def _families(name):
    if name == "negbin":
        return jlk.NegativeBinomialDyadic(K), tlk.NegativeBinomialDyadic(K)
    return (None, None) if name == "gaussian" else (name, name)


def _jax_values_grads(fn, X):
    out = [jax.value_and_grad(fn)(jnp.asarray(x)) for x in X]
    return (np.array([float(v) for v, _ in out]),
            np.stack([np.asarray(g) for _, g in out]))


def _port_values_grads(fn, X):
    x = torch.from_numpy(X).requires_grad_(True)
    v = fn(x)
    g, = torch.autograd.grad(v.sum(), x)
    return v.detach().numpy(), g.numpy()


@pytest.mark.parametrize("case", ["gaussian", "masked", "poisson",
                                  "bernoulli", "masked bernoulli"])
def test_values_and_gradients_match_tame(case):
    """log p(Y, X) and its gradient, batched over 3 states in the port and
    one state at a time in JAX; NaN-coded hidden entries under a mask."""
    data, mask, X, jp = _setup()
    family = case.split()[-1]
    if family == "masked":
        family = "gaussian"
    Y = data[family]
    m = None
    if case.startswith("masked"):
        m = mask
        Y = np.where(mask[..., None] > 0, Y, np.nan).astype(np.float32)
    jf, tf = _families(family)
    jfn = jlp.make_logdensity_fn(jp, jnp.asarray(Y), obs_mask=(
        None if m is None else jnp.asarray(m)), family=jf)
    tfn = tlp.make_logdensity_fn(params_from_numpy(jp), torch.from_numpy(Y),
                                 obs_mask=(None if m is None
                                           else torch.from_numpy(m)),
                                 family=tf)
    jv, jg = _jax_values_grads(jfn, X)
    tv, tg = _port_values_grads(tfn, X)
    assert np.all(np.isfinite(tg))
    np.testing.assert_allclose(tv, jv, rtol=RTOL)
    np.testing.assert_allclose(tg, jg, rtol=0,
                               atol=RTOL * np.abs(jg).max())


def test_negative_binomial_up_to_its_constant():
    """The port's NegBin log-pmf is the exact one; ``tame``'s is low by
    k log k per gated entry (ROADMAP C.4): the values differ by exactly
    that constant, the gradients not at all."""
    data, mask, X, jp = _setup()
    Y = data["negbin"]
    jf, tf = _families("negbin")
    for m in (None, mask):
        jfn = jlp.make_logdensity_fn(jp, jnp.asarray(Y), obs_mask=(
            None if m is None else jnp.asarray(m)), family=jf)
        tfn = tlp.make_logdensity_fn(
            params_from_numpy(jp), torch.from_numpy(Y),
            obs_mask=None if m is None else torch.from_numpy(m), family=tf)
        jv, jg = _jax_values_grads(jfn, X)
        tv, tg = _port_values_grads(tfn, X)
        n = Y.shape[0]
        gate = (1.0 - np.eye(n))[:, :, None] * (1.0 if m is None else m)
        entries = np.broadcast_to(gate, Y.shape[:3]).sum()
        np.testing.assert_allclose(tv - jv, K * np.log(K) * entries,
                                   rtol=RTOL * np.abs(jv).max()
                                   / (K * np.log(K) * entries))
        np.testing.assert_allclose(tg, jg, rtol=0,
                                   atol=RTOL * np.abs(jg).max())


@pytest.mark.parametrize("family", ["gaussian", "poisson"])
def test_batch_equals_a_loop(family):
    """(2, 3, n, T, d) latents in one call give what a loop over the six
    states gives, values and gradients."""
    data, _, X, jp = _setup(seed=1)
    tp = params_from_numpy(jp)
    fn = tlp.make_logdensity_fn(tp, torch.from_numpy(data[family]),
                                family=None if family == "gaussian"
                                else family)
    Xb = torch.from_numpy(np.concatenate([X, 0.5 * X])).reshape(
        2, 3, *X.shape[1:])
    v, g = _port_values_grads(fn, Xb.numpy())
    assert v.shape == (2, 3)
    for idx in np.ndindex(2, 3):
        vi, gi = _port_values_grads(fn, Xb[idx].numpy())
        np.testing.assert_allclose(v[idx], vi, rtol=1e-6)
        np.testing.assert_allclose(g[idx], gi, rtol=0,
                                   atol=1e-6 * np.abs(gi).max())


def test_prior_likelihood_and_joint():
    """log_prior and log_likelihood against ``tame``'s on one state, the
    joint their sum, the explicit constants path and the mask gate: a
    mask that hides nothing gives the dense value, and hidden entries are
    never read."""
    data, mask, X, jp = _setup(seed=2)
    tp = params_from_numpy(jp)
    Y, x = data["gaussian"], X[0]
    jpri = float(jlp.log_prior(jp, jnp.asarray(x)))
    tpri = float(tlp.log_prior(tp, torch.from_numpy(x)))
    jll = float(jlp.log_likelihood(jp, jnp.asarray(Y), jnp.asarray(x)))
    tll = float(tlp.log_likelihood(tp, torch.from_numpy(Y),
                                   torch.from_numpy(x),
                                   tlp.precompute(tp)))
    assert tpri == pytest.approx(jpri, rel=RTOL)
    assert tll == pytest.approx(jll, rel=RTOL)
    tY, tx = torch.from_numpy(Y), torch.from_numpy(x)
    assert float(tlp.log_joint(tp, tY, tx)) == pytest.approx(tpri + tll,
                                                             rel=1e-6)
    n, T = Y.shape[0], Y.shape[2]
    full = (1.0 - torch.eye(n))[:, :, None].expand(n, n, T)
    assert float(tlp.log_likelihood(tp, tY, tx, obs_mask=full)) == \
        pytest.approx(tll, rel=1e-6)
    m = torch.from_numpy(mask)
    junk = torch.where(m[..., None] == 0, torch.tensor(1e6), tY)
    assert float(tlp.log_likelihood(tp, tY, tx, obs_mask=m)) == float(
        tlp.log_likelihood(tp, junk, tx, obs_mask=m))
    # make_logdensity_fn zeroes the mask's diagonal
    ones = torch.ones(n, n, T)
    fn = tlp.make_logdensity_fn(tp, tY, obs_mask=ones)
    assert float(fn(tx)) == pytest.approx(float(tlp.log_joint(tp, tY, tx)),
                                          rel=1e-6)
