"""Port parity for the smoothed non-Gaussian E-steps and the non-Gaussian
EM (``tame_torch.inference.family_smoothed`` and ``fit_em(family=...)``
against ``tame``): the guarded smoothed fits of the Bernoulli, Poisson,
negative binomial and a custom ``vi_surrogate`` family from one numpy
init, the learned phi of EM for binary, count, masked binary and
negative-binomial networks, NaN-coded hidden dyads and the family
checks.  On the CPU every smooth runs K4's scan twin; ``tame`` ``vmap``s
its scan smoother.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tame.config import ModelConfig as JaxModelConfig
from tame.inference import em as jem
from tame.inference import family_smoothed as jfs
from tame.models import NegativeBinomialDyadic as JaxNegBin
from tame.models import build_params as jax_build_params
from tame.models import random_dyad_mask as jax_random_dyad_mask
from tame.models import sample as jax_sample
from tame.models.temporal_ame import sample_latents as jax_sample_latents
from tame.ops import dyad as jdyad
from tame_torch.inference import (fit_em, fit_smoothed_family,
                                  warm_init_smoothed_family)
from tame_torch.inference import family_smoothed as tfs
from tame_torch.inference import smoothed as tsm
from tame_torch.models import NegativeBinomialDyadic, params_from_numpy
from tame_torch.ops import dyad as tdyad

torch.set_num_threads(1)

# Whole fits: the objective at every iteration, relative; the dyadic means
# and lag-1 cross-covariances against max |.|.
ELBO_RTOL = 1e-4
STATE_REL = 1e-4
# EM: the learned phi (and tr Q, tr Sigma0) at every EM iteration.
PHI_RTOL = 1e-4


class JaxExposurePoisson:
    """``tests/test_em.py::TestCustomFamilyVI.ExposurePoisson``:
    y ~ Poisson(E exp(m)) with a known exposure E."""

    name = "exposure_poisson"

    def __init__(self, exposure):
        self.exposure = float(exposure)

    def vi_surrogate(self, y0, offd, m, var):
        logE = jnp.log(self.exposure)
        w = self.exposure * jnp.exp(jnp.clip(m + 0.5 * var, -20.0,
                                             20.0)) * offd
        loglik = jnp.sum(offd * (y0 * (m + logE)
                                 - jax.lax.lgamma(y0 + 1.0)) - w)
        return loglik, w, (y0 - w + w * m) * offd

    def warm_transform(self, Y):
        return jnp.log(Y + 0.5) - jnp.log(self.exposure)

    def __hash__(self):
        return hash(("exposure_poisson", self.exposure))

    def __eq__(self, other):
        return (isinstance(other, type(self))
                and other.exposure == self.exposure)


class ExposurePoisson:
    """The same family written for the port: a user family is ~15 lines
    of elementwise torch, whatever the layout of its inputs."""

    name = "exposure_poisson"

    def __init__(self, exposure):
        self.exposure = float(exposure)

    def vi_surrogate(self, y0, offd, m, var):
        logE = math.log(self.exposure)
        w = self.exposure * torch.exp(torch.clamp(m + 0.5 * var, -20.0,
                                                  20.0)) * offd
        loglik = torch.sum(offd * (y0 * (m + logE)
                                   - torch.lgamma(y0 + 1.0)) - w)
        return loglik, w, (y0 - w + w * m) * offd

    def warm_transform(self, Y):
        return torch.log(Y + 0.5) - math.log(self.exposure)


def _latent_data(jfam, n, T, seed):
    p = jax_build_params(JaxModelConfig(n_nodes=n, n_time=T, latent_dim=1,
                                        ar_coefficient=0.8, seed=seed))
    X = jax_sample_latents(p, jax.random.PRNGKey(seed), n, T)
    mu = jdyad.dyadic_mean_temporal(X, 1)
    if isinstance(jfam, JaxExposurePoisson):
        rate = jfam.exposure * jnp.exp(mu[..., 0])
        Yf = jax.random.poisson(jax.random.PRNGKey(seed + 1), rate)
        Yf = Yf.astype(mu.dtype) * (1.0 - jnp.eye(n))[:, :, None]
        Y = jnp.stack([Yf, jnp.swapaxes(Yf, 0, 1)], -1)
    else:
        Y = jfam.sample(jax.random.PRNGKey(seed + 1), p, mu)
    return p, np.asarray(Y)


def problem(kind, n=12, T=4, seed=3):
    """(tame family, port family, params, Y) for a family name."""
    if kind in ("bernoulli", "poisson"):
        p = jax_build_params(JaxModelConfig(n_nodes=n, n_time=T,
                                            latent_dim=1, seed=seed))
        Y, _ = jax_sample(p, jax.random.PRNGKey(seed), n, T, family=kind)
        return kind, kind, p, np.asarray(Y)
    if kind == "negbin":
        jf, tf = JaxNegBin(5.0), NegativeBinomialDyadic(5.0)
    else:
        jf, tf = JaxExposurePoisson(6.0), ExposurePoisson(6.0)
    p, Y = _latent_data(jf, n, T, seed)
    return jf, tf, p, Y


def assert_states_agree(got, ref):
    m_ref = np.asarray(jdyad.dyadic_fwd_temporal(ref.X_mean, 1))
    m_got = tdyad.dyadic_fwd_temporal(got.X_mean, 1).numpy()
    assert np.abs(m_got - m_ref).max() <= STATE_REL * np.abs(m_ref).max()
    c_ref = np.asarray(ref.X_cross)
    assert np.abs(got.X_cross.numpy() - c_ref).max() \
        <= STATE_REL * np.abs(c_ref).max()


@pytest.mark.parametrize("kind,masked", [("bernoulli", False),
                                         ("poisson", False),
                                         ("poisson", True),
                                         ("custom", False)])
def test_fit_smoothed_family_matches_tame(kind, masked):
    """40 iterations of the guarded loop from one warm init: the same
    accepted and rejected steps, the objective within ELBO_RTOL at every
    iteration, the states within STATE_REL.  At a fixed count, as a
    relative stop at 1e-5 falls where float32 noise decides it (measured:
    the masked Poisson fit's deciding change was 9.997e-6 in ``tame`` and
    1.024e-5 in the port, stops 30 and 31); the stop rule itself is
    ``poisson_cavi.GuardRule``, held to ``tame``'s stops in
    ``test_torch_poisson.py``; the port's fit run with it stays finite and
    does not diverge."""
    jf, tf, p, Y = problem(kind)
    mask = (np.asarray(jax_random_dyad_mask(jax.random.PRNGKey(5), 12, 4,
                                            0.3)) if masked else None)
    jm = None if mask is None else jnp.asarray(mask)
    init = jfs.warm_init_smoothed_family(jnp.asarray(Y), p, jf,
                                         obs_mask=jm)
    kw = dict(max_iter=40, learning_rate=0.7, tolerance=0.0)
    ref = jfs.fit_smoothed_family(jnp.asarray(Y), p, init, family=jf,
                                  mask=jm, **kw)
    tmask = None if mask is None else torch.from_numpy(mask)
    tinit = tsm.smoothed_state_from_numpy(init)
    got = fit_smoothed_family(torch.from_numpy(Y), params_from_numpy(p),
                              tinit, family=tf, mask=tmask, **kw)
    assert (got.n_iter, got.diverged) == (40, bool(ref.diverged)) == (
        int(ref.n_iter), False)
    eh, eh_ref = got.elbo_history[:40].numpy(), np.asarray(
        ref.elbo_history)[:40]
    np.testing.assert_allclose(eh, eh_ref, rtol=ELBO_RTOL)
    # a rejected step repeats its base's objective
    np.testing.assert_array_equal(np.diff(eh) == 0, np.diff(eh_ref) == 0)
    assert_states_agree(got.state, ref.state)
    assert float(got.state.X_cross.abs().max()) > 1e-4
    out = fit_smoothed_family(torch.from_numpy(Y), params_from_numpy(p),
                              tinit, family=tf, mask=tmask, max_iter=300,
                              learning_rate=0.7, tolerance=1e-5)
    assert not out.diverged
    assert np.isfinite(out.elbo_history[:out.n_iter].numpy()).all()


def test_negbin_at_fixed_iterations():
    """The negative binomial at tolerance 0 (its objective is ``tame``'s
    plus k log k per observed entry, ROADMAP C.4, which would move a
    relative stop): the states, the surrogate's w and s, and the objective
    up to that constant."""
    jf, tf, p, Y = problem("negbin")
    init = jfs.warm_init_smoothed_family(jnp.asarray(Y), p, jf)
    kw = dict(max_iter=30, learning_rate=0.7, tolerance=0.0)
    ref = jfs.fit_smoothed_family(jnp.asarray(Y), p, init, family=jf, **kw)
    got = fit_smoothed_family(torch.from_numpy(Y), params_from_numpy(p),
                              tsm.smoothed_state_from_numpy(init), family=tf,
                              **kw)
    shift = 5.0 * math.log(5.0) * 12 * 11 * 4
    np.testing.assert_allclose(got.elbo_history[:30].numpy() - shift,
                               np.asarray(ref.elbo_history)[:30],
                               rtol=ELBO_RTOL)
    assert_states_agree(got.state, ref.state)
    # the surrogate's weights at the final state
    pri = jfs.cavi.precompute_priors(p)
    n, T = 12, 4
    offd = jnp.broadcast_to((1.0 - jnp.eye(n))[:, :, None], (n, n, T))
    y0 = jnp.where(offd > 0, jnp.asarray(Y)[..., 0], 0.0)
    _, w_ref, s_ref = jfs._evaluate(jf, ref.state, y0, offd, pri, p)
    fi = tfs.family_inputs(torch.from_numpy(Y))
    tp = params_from_numpy(p)
    _, w, s = tfs._evaluate(tf, got.state, fi.y0, fi.offd,
                            tfs.cavi.precompute_priors(tp), tp)
    for g, r_ in ((w, w_ref), (s, s_ref)):
        r_ = np.asarray(r_)
        np.testing.assert_allclose(g.permute(1, 2, 0).numpy(), r_,
                                   rtol=STATE_REL,
                                   atol=STATE_REL * np.abs(r_).max())


def test_masked_entries_never_read():
    _, tf, p, Y = problem("poisson")
    mask = torch.from_numpy(np.asarray(jax_random_dyad_mask(
        jax.random.PRNGKey(5), 12, 4, 0.3)))
    Yg = np.where(mask.numpy()[..., None] == 0, np.nan, Y)
    tp = params_from_numpy(p)
    init = warm_init_smoothed_family(torch.from_numpy(Y), tp, tf,
                                     obs_mask=mask)
    kw = dict(family=tf, max_iter=20, learning_rate=0.7, tolerance=0.0,
              mask=mask)
    a = fit_smoothed_family(torch.from_numpy(Y), tp, init, **kw)
    b = fit_smoothed_family(torch.from_numpy(Yg), tp, init, **kw)
    assert torch.equal(a.state.X_mean, b.state.X_mean)


def test_warm_init_transforms():
    _, _, p, Y = problem("custom")
    tp, tY = params_from_numpy(p), torch.from_numpy(Y)
    for fam, Z in [("bernoulli", 4.0 * (tY - 0.5)),
                   ("poisson", torch.log(tY + 0.5)),
                   (ExposurePoisson(6.0), torch.log(tY + 0.5)
                    - math.log(6.0))]:
        a = warm_init_smoothed_family(tY, tp, fam)
        b = tsm.warm_init_smoothed_state(Z, tp)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="unknown family"):
        warm_init_smoothed_family(tY, tp, "banana")


def test_family_checks():
    _, _, p, Y = problem("bernoulli", n=6, T=2)
    tp, tY = params_from_numpy(p), torch.from_numpy(Y)
    st = tsm.init_smoothed_state(torch.Generator().manual_seed(0), 6, 2, 4)

    class NoSurrogate:
        pass

    with pytest.raises(ValueError, match="family"):
        fit_smoothed_family(tY, tp, st, family="banana")
    with pytest.raises(ValueError, match="vi_surrogate"):
        fit_smoothed_family(tY, tp, st, family=NoSurrogate())
    with pytest.raises(ValueError, match="vi_surrogate"):
        fit_em(tY, tp, family=NoSurrogate(), n_em=1)
    with pytest.raises(ValueError, match="vi_surrogate"):
        fit_smoothed_family(tY, tp, st, family="gaussian")


@pytest.mark.parametrize("kind,masked", [("bernoulli", False),
                                         ("poisson", False),
                                         ("bernoulli", True),
                                         ("negbin", False)])
def test_fit_em_matches_tame(kind, masked):
    """Three EM iterations from a wrong start (phi 0.3 against the truth's
    0.8) from one warm init: the learned phi, tr Q and tr Sigma0 at every
    EM iteration; sigma2 and rho are held (R is not learned for these
    families).  The negative binomial runs its E-steps at inner tolerance
    0 (its objective is tame's plus a constant, which would move a
    relative stop), the others too: every E-step runs its 40 iterations,
    as a relative stop at 1e-6 falls where float32 noise decides it and
    moves phi by ~2e-4 (measured)."""
    n, T = 12, 4
    jf, tf, p_true, Y = problem(kind, n, T)
    mask = None
    if masked:
        mask = np.asarray(jax_random_dyad_mask(jax.random.PRNGKey(9), n, T,
                                               0.3))
        Y = np.where(mask[..., None] == 0, np.nan, Y).astype(np.float32)
    p0 = jax_build_params(JaxModelConfig(n_nodes=n, n_time=T, latent_dim=1,
                                         ar_coefficient=0.3, seed=3))
    jm = None if mask is None else jnp.asarray(mask)
    init = jfs.warm_init_smoothed_family(
        jnp.asarray(Y), p0, jf, obs_mask=None if jm is None
        else jm * (1.0 - jnp.eye(n))[:, :, None])
    kw = dict(n_em=3, inner_max_iter=40, learning_rate=0.7,
              inner_tolerance=0.0)
    ref = jem.fit_em(jnp.asarray(Y), p0, family=jf, mask=jm, init=init,
                     **kw)
    got = fit_em(torch.from_numpy(Y), params_from_numpy(p0), family=tf,
                 mask=None if mask is None else torch.from_numpy(mask),
                 init=tsm.smoothed_state_from_numpy(init), **kw)
    assert got.history.keys() == ref.history.keys()
    assert len(got.history["phi"]) == len(ref.history["phi"]) == 3
    for key in ("phi", "trQ", "trSigma0"):
        np.testing.assert_allclose(got.history[key], ref.history[key],
                                   rtol=PHI_RTOL)
    for key in ("sigma2", "rho"):
        assert got.history[key] == [ref.history[key][0]] * 3
    shift = (5.0 * math.log(5.0) * n * (n - 1) * T if kind == "negbin"
             else 0.0)
    np.testing.assert_allclose(np.asarray(got.history["elbo"]) - shift,
                               ref.history["elbo"], rtol=ELBO_RTOL)
    assert abs(got.history["phi"][-1] - 0.8) < abs(0.3 - 0.8)
