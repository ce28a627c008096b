"""Port parity for variational EM and the exact ELBO: the same numpy data,
parameters and smoothed state go through ``tame.inference.em`` /
``evidence`` (JAX, CPU) and their ``tame_torch`` counterparts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tame.config import ModelConfig
from tame.inference import cavi as jcavi
from tame.inference import em as jem
from tame.inference import smoothed as jsm
from tame.inference.evidence import exact_elbo as jax_exact_elbo
from tame.models import TemporalAMEModel as JaxModel
from tame.models.params import build_params as jax_build_params
from tame_torch import exact_elbo, fit_em
from tame_torch.inference import em as tem
from tame_torch.inference import smoothed as tsm
from tame_torch.models import params_from_numpy

torch.set_num_threads(1)

# M-step reductions over n T d^2 posterior entries, f32 in another order.
RTOL = 1e-5
# Three whole EM iterations (60 inner CAVI iterations each): f32 noise in
# the E-steps moves the learned scalars by far less than this.
RTOL_EM = 1e-3


@pytest.fixture(scope="module")
def problem():
    """Model data (truth phi 0.8, sigma^2 0.1, rho 0.5), a wrong starting
    guess and a solved smoothed state from it (10 JAX iterations)."""
    model = JaxModel(n_nodes=8, n_time=5, latent_dim=1, seed=3)
    Y = np.array(model.generate_data())
    p0 = jax_build_params(ModelConfig(n_nodes=8, n_time=5, latent_dim=1,
                                      ar_coefficient=0.3, rho_dyadic=0.0,
                                      dyadic_variance=1.0))
    init = jsm.warm_init_smoothed_state(jnp.asarray(Y), p0)
    js = jsm.fit_cavi_smoothed(jnp.asarray(Y), p0, init, max_iter=10,
                               tolerance=0.0).state
    return Y, p0, init, js


def _close(got, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def test_transition_and_residual_moments(problem):
    Y, _, _, js = problem
    ts = tsm.smoothed_state_from_numpy(js)
    for got, ref in zip(tem._transition_moments(ts),
                        jem._transition_moments(js)):
        _close(got, ref, atol=1e-5)
    for got, ref in zip(tem._residual_moments(torch.from_numpy(Y),
                                              ts.X_mean),
                        jem._residual_moments(jnp.asarray(Y), js.X_mean)):
        _close(got, ref)
    m = jnp.broadcast_to((1.0 - jnp.eye(8))[:, :, None], (8, 8, 5))
    for got, ref in zip(tem._residual_moment_corrections(ts),
                        jem._residual_moment_corrections(js, m)):
        _close(got, ref)


@pytest.mark.parametrize("r_structure", ["exchangeable", "diag"])
@pytest.mark.parametrize("phi_structure", ["scalar", "blocks", "diag"])
def test_em_update_params(problem, phi_structure, r_structure):
    Y, p0, _, js = problem
    kw = dict(phi_structure=phi_structure, r_structure=r_structure)
    ref = jem.em_update_params(p0, jnp.asarray(Y), js, **kw)
    got = tem.em_update_params(params_from_numpy(p0), torch.from_numpy(Y),
                               tsm.smoothed_state_from_numpy(js), **kw)
    for name in ref._fields:
        # entries that are zero in exact arithmetic come out at f32 noise
        _close(getattr(got, name), getattr(ref, name), atol=1e-6)


def test_partial_learn_and_validation(problem):
    Y, p0, _, js = problem
    tp, ts, tY = (params_from_numpy(p0), tsm.smoothed_state_from_numpy(js),
                  torch.from_numpy(Y))
    got = tem.em_update_params(tp, tY, ts, learn=("phi",))
    ref = jem.em_update_params(p0, jnp.asarray(Y), js, learn=("phi",))
    _close(got.Phi, ref.Phi, atol=1e-6)
    assert torch.equal(got.Q, tp.Q) and torch.equal(got.R, tp.R)
    with pytest.raises(ValueError, match="unknown learnable"):
        tem.em_update_params(tp, tY, ts, learn=("phi", "bogus"))
    with pytest.raises(ValueError, match="phi_structure"):
        tem.em_update_params(tp, tY, ts, phi_structure="bogus")
    with pytest.raises(ValueError, match="r_structure"):
        tem.em_update_params(tp, tY, ts, r_structure="bogus")
    with pytest.raises(NotImplementedError):
        fit_em(tY, tp, family="bernoulli")
    with pytest.raises(ValueError, match="unknown family"):
        fit_em(tY, tp, family="bogus")


def test_exact_elbo(problem):
    Y, p0, _, js = problem
    _close(exact_elbo(torch.from_numpy(Y), params_from_numpy(p0),
                      tsm.smoothed_state_from_numpy(js)),
           jax_exact_elbo(jnp.asarray(Y), p0, js))


def test_fit_em_matches_jax(problem):
    """Three EM iterations from one warm init: the learned scalars and the
    number of EM iterations agree."""
    Y, p0, init, _ = problem
    kw = dict(n_em=3, inner_max_iter=60)
    ref = jem.fit_em(jnp.asarray(Y), p0, init=init, **kw)
    got = fit_em(torch.from_numpy(Y), params_from_numpy(p0),
                 init=tsm.smoothed_state_from_numpy(init), **kw)
    assert got.history.keys() == ref.history.keys()
    assert len(got.history["elbo"]) == len(ref.history["elbo"]) == 3
    for key in ref.history:
        _close(got.history[key], ref.history[key], rtol=RTOL_EM)
    # the learned scalars moved from the wrong start toward the truth
    h = got.history
    assert abs(h["phi"][-1] - 0.8) < abs(0.3 - 0.8)
    assert abs(h["sigma2"][-1] - 0.1) < abs(1.0 - 0.1)
    assert (torch.linalg.eigvalsh(got.params.Q) > 0).all()
    assert (torch.linalg.eigvalsh(got.params.R) > 0).all()
