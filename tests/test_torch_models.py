"""The port's static model, the temporal model's new methods and the
three dyad ops they use: ``tests/test_models.py::TestStaticAMEModel``'s
invariants on the port (its own random stream), and every ``compute_*``
against the JAX package on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tame.models import StaticAMEModel as JaxStaticAMEModel
from tame.models import TemporalAMEModel as JaxTemporalAMEModel
from tame.ops import dyad as jdyad
from tame_torch import StaticAMEModel, TemporalAMEModel
from tame_torch.models import sample_static
from tame_torch.ops import dyad as tdyad

torch.set_num_threads(1)

RTOL = 1e-5
PARAMS = {"n_nodes": 10, "latent_dim": 2, "seed": 42}


def _f32(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture
def static_data():
    model = StaticAMEModel(**PARAMS, device="cpu")
    Y, A, M = model.generate_data(return_latents=True)
    return {"model": model, "Y": Y, "A": A, "M": M}


class TestStaticAMEModel:
    def test_shapes(self, static_data):
        m = static_data["model"]
        assert static_data["Y"].shape == (m.n, m.n, 2)
        assert static_data["A"].shape == (m.n, 2)
        assert static_data["M"].shape == (m.n, 2 * m.r)

    def test_zero_diagonal(self, static_data):
        Y = static_data["Y"]
        assert bool((Y[torch.arange(10), torch.arange(10)] == 0).all())

    def test_reciprocity(self, static_data):
        Y = static_data["Y"]
        assert torch.equal(Y[..., 1], Y.transpose(0, 1)[..., 0])

    def test_recon_error_at_truth_small(self, static_data):
        """At the true parameters the residual is pure dyadic noise:
        per-dyad MSE ~ 2 * 0.1."""
        m = static_data["model"]
        err = m.compute_reconstruction_error(static_data["A"],
                                             static_data["M"])
        assert 0.05 < err < 0.6

    def test_contributions_nonnegative(self, static_data):
        m = static_data["model"]
        assert m.compute_additive_contribution(static_data["A"]) >= 0
        assert m.compute_multiplicative_contribution(static_data["M"]) >= 0

    def test_same_seed_reproducible(self):
        Y1 = StaticAMEModel(**PARAMS, device="cpu").generate_data()
        Y2 = StaticAMEModel(**PARAMS, device="cpu").generate_data()
        assert torch.equal(Y1, Y2)

    def test_different_seed_differs(self):
        p = dict(PARAMS, seed=7)
        assert not torch.allclose(
            StaticAMEModel(**PARAMS, device="cpu").generate_data(),
            StaticAMEModel(**p, device="cpu").generate_data())

    def test_mean_structure(self):
        model = StaticAMEModel(**PARAMS, device="cpu")
        mu = model.compute_mean(torch.ones(10, 2), torch.zeros(10, 4))
        assert torch.allclose(mu, torch.full((10, 10, 2), 2.0))

    def test_fresh_draws_and_explicit_generator(self):
        model = StaticAMEModel(**PARAMS, device="cpu")
        first = model.generate_data()
        assert not torch.equal(model.generate_data(), first)
        g = torch.Generator().manual_seed(PARAMS["seed"])
        assert torch.equal(model.generate_data(generator=g), first)
        Y, A, M = sample_static(model.params,
                                torch.Generator().manual_seed(3), 6)
        assert Y.shape == (6, 6, 2) and A.shape == (6, 2) and M.shape == (
            6, 4)

    def test_defaults_to_the_card(self):
        if torch.cuda.is_available():
            assert StaticAMEModel(4).generate_data().is_cuda
        else:
            with pytest.raises(RuntimeError, match="needs a CUDA device"):
                StaticAMEModel(4)

    def test_noise_floor(self):
        """Residuals around the true mean have the dyadic variance 0.1: a
        distributional check, as the random streams differ from JAX's."""
        model = StaticAMEModel(n_nodes=60, seed=0, device="cpu")
        Y, A, M = model.generate_data(return_latents=True)
        resid = (Y - model.compute_mean(A, M))[..., 0]
        off = ~torch.eye(60, dtype=torch.bool)
        assert float(resid[off].var()) == pytest.approx(0.1, rel=0.15)


class TestStaticAgainstJax:
    """The ``compute_*`` methods of the two static models on the same
    ``Y``, ``A`` and ``M``."""

    @pytest.fixture
    def pair(self):
        jm = JaxStaticAMEModel(**PARAMS)
        Y, A, M = (np.asarray(v) for v in jm.generate_data(
            return_latents=True))
        tm = StaticAMEModel(**PARAMS, device="cpu")
        tm.Y = torch.tensor(Y)
        return jm, tm, A + 0.1 * _f32(10, 2, seed=1), M + 0.1 * _f32(10, 4)

    def test_compute_mean(self, pair):
        jm, tm, A, M = pair
        np.testing.assert_allclose(
            tm.compute_mean(torch.tensor(A), torch.tensor(M)).numpy(),
            np.asarray(jm.compute_mean(jnp.asarray(A), jnp.asarray(M))),
            rtol=RTOL, atol=1e-6)

    def test_reconstruction_error(self, pair):
        jm, tm, A, M = pair
        assert tm.compute_reconstruction_error(
            torch.tensor(A), torch.tensor(M)) == pytest.approx(
            jm.compute_reconstruction_error(jnp.asarray(A), jnp.asarray(M)),
            rel=RTOL)

    def test_contributions(self, pair):
        jm, tm, A, M = pair
        assert tm.compute_additive_contribution(torch.tensor(A)) == \
            pytest.approx(jm.compute_additive_contribution(jnp.asarray(A)),
                          rel=RTOL)
        assert tm.compute_multiplicative_contribution(torch.tensor(M)) == \
            pytest.approx(jm.compute_multiplicative_contribution(
                jnp.asarray(M)), rel=RTOL)

    def test_parameters(self, pair):
        jm, tm, _, _ = pair
        for name in ("Sigma", "Psi", "R", "R_inv"):
            np.testing.assert_allclose(getattr(tm, name).numpy(),
                                       np.asarray(getattr(jm, name)),
                                       rtol=RTOL, atol=1e-6)


class TestTemporalMethodsAgainstJax:
    @pytest.fixture
    def pair(self):
        jm = JaxTemporalAMEModel(n_nodes=8, n_time=5, latent_dim=2, seed=4)
        Y, X = (np.asarray(v) for v in jm.generate_data(return_latents=True))
        tm = TemporalAMEModel(n_nodes=8, n_time=5, latent_dim=2, seed=4,
                              device="cpu")
        tm.Y, tm.X = torch.tensor(Y), torch.tensor(X)
        return jm, tm, X + 0.2 * _f32(8, 5, 6, seed=2)

    def test_get_states_at_time(self, pair):
        jm, tm, _ = pair
        for t in (0, 4):
            for got, ref in zip(tm.get_states_at_time(t),
                                jm.get_states_at_time(t)):
                assert np.array_equal(got.numpy(), np.asarray(ref))
        with pytest.raises(ValueError, match="out of bounds"):
            tm.get_states_at_time(5)

    def test_state_prediction_error(self, pair):
        jm, tm, X_est = pair
        assert tm.compute_state_prediction_error(
            torch.tensor(X_est)) == pytest.approx(
            jm.compute_state_prediction_error(jnp.asarray(X_est)), rel=RTOL)

    def test_contributions(self, pair):
        jm, tm, X_est = pair
        A, M = X_est[:, 2, :2], X_est[:, 2, 2:]
        assert tm.compute_additive_contribution(torch.tensor(A)) == \
            pytest.approx(jm.compute_additive_contribution(jnp.asarray(A)),
                          rel=RTOL)
        assert tm.compute_multiplicative_contribution(torch.tensor(M)) == \
            pytest.approx(jm.compute_multiplicative_contribution(
                jnp.asarray(M)), rel=RTOL)

    def test_per_time_contributions(self, pair):
        """The per-time contributions are one batched expression over T
        in the port (JAX vmaps them)."""
        jm, tm, X_est = pair
        for name in ("compute_temporal_additive_contribution",
                     "compute_temporal_multiplicative_contribution"):
            got = getattr(tm, name)(torch.tensor(X_est))
            ref = np.asarray(getattr(jm, name)(jnp.asarray(X_est)))
            assert got.shape == (5,)
            np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL)

    def test_compute_mean(self, pair):
        jm, tm, X_est = pair
        A, M = X_est[:, 0, :2], X_est[:, 0, 2:]
        np.testing.assert_allclose(
            tm.compute_mean(torch.tensor(A), torch.tensor(M)).numpy(),
            np.asarray(jm.compute_mean(jnp.asarray(A), jnp.asarray(M))),
            rtol=RTOL, atol=1e-6)


class TestDyadOpsAgainstJax:
    def test_masked_sq_error_static(self):
        Y, mu = _f32(7, 7, 2, seed=5), _f32(7, 7, 2, seed=6)
        assert float(tdyad.masked_sq_error_static(
            torch.tensor(Y), torch.tensor(mu))) == pytest.approx(
            float(jdyad.masked_sq_error_static(jnp.asarray(Y),
                                               jnp.asarray(mu))), rel=RTOL)

    @pytest.mark.parametrize("exclude", [True, False])
    def test_contributions(self, exclude):
        A, M = _f32(9, 2, seed=7), _f32(9, 6, seed=8)
        assert float(tdyad.additive_contribution(
            torch.tensor(A), exclude)) == pytest.approx(
            float(jdyad.additive_contribution(jnp.asarray(A), exclude)),
            rel=RTOL)
        assert float(tdyad.multiplicative_contribution(
            torch.tensor(M), exclude)) == pytest.approx(
            float(jdyad.multiplicative_contribution(jnp.asarray(M),
                                                    exclude)), rel=RTOL)
