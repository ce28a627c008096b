"""Forecasting on the port's CAVI engines: ``predict_forward``,
``predict_forward_with_cov`` and ``predict_dyads`` (the delta-method
predictive std), run as ``tests/test_inference.py::TestForecastUncertainty``
runs them against the JAX package, and held to the JAX engine's forecasts
on a state carried over from a JAX fit.
"""

import numpy as np
import pytest
import torch

from tame.inference import TemporalAMEStructuredMFVI as JaxGood
from tame.models import TemporalAMEModel as JaxTemporalAMEModel
from tame_torch import TemporalAMEModel, TemporalAMEStructuredMFVI
from tame_torch.inference.engine import forecast_dyads, forecast_states
from tame_torch.models import params_from_numpy
from tame_torch.utils import compute_coverage

torch.set_num_threads(1)

RTOL = 1e-5  # float32 products in another order


def _fitted():
    model = TemporalAMEModel(n_nodes=10, n_time=6, latent_dim=1, seed=4,
                             device="cpu")
    model.generate_data()
    vi = TemporalAMEStructuredMFVI(model, factorization="good",
                                   learning_rate=0.8)
    vi.fit(max_iter=60, tolerance=0.0, verbose=False)
    return model, vi


def _forecast_draws(model, vi, S, seed):
    """Draws of the exact one-step forecast distribution: state draw ->
    AR step -> dyad mean."""
    params = model.params
    n, d, r = 10, 4, 1
    mu_T = vi.X_mean[:, -1].numpy().astype(np.float64)
    Sig_T = vi.X_cov[:, -1].numpy().astype(np.float64)
    rng = np.random.default_rng(seed)
    chol = np.linalg.cholesky(Sig_T + 1e-9 * np.eye(d))
    xT = mu_T[None] + np.einsum("ids,nis->nid", chol,
                                rng.standard_normal((S, n, d)))
    Phi, Q = params.Phi.numpy(), params.Q.numpy()
    w = np.einsum("ds,nis->nid", np.linalg.cholesky(Q),
                  rng.standard_normal((S, n, d)))
    x1 = xT @ Phi.T + w
    a, b = x1[..., 0], x1[..., 1]
    U, V = x1[..., 2:2 + r], x1[..., 2 + r:]
    return (a[:, :, None] + b[:, None, :]
            + np.einsum("sir,sjr->sij", U, V)), rng


class TestForecastUncertainty:
    def test_shapes_and_symmetry(self):
        model, vi = _fitted()
        mus, Sigs = vi.predict_forward_with_cov(3)
        assert mus.shape == (10, 3, 4) and Sigs.shape == (10, 3, 4, 4)
        # the covariance grows toward the stationary value and stays SPD
        assert bool((torch.linalg.eigvalsh(Sigs) > 0).all())
        mean, std = vi.predict_dyads(3)
        assert mean.shape == (10, 10, 3, 2) and std.shape == mean.shape
        assert bool((std > 0).all())
        # component 1 of dyad (i, j) is y_ji: its std is the swap
        assert torch.equal(std[..., 1], std[..., 0].transpose(0, 1))

    def test_variance_matches_monte_carlo(self):
        """Delta-method predictive std against a 4000-draw Monte Carlo of
        the exact forecast distribution."""
        model, vi = _fitted()
        mu_dyad, _ = _forecast_draws(model, vi, 4000, 0)
        emp_var = mu_dyad.var(axis=0) + float(model.params.R[0, 0])
        _, std = vi.predict_dyads(1)
        pred_var = std[..., 0, 0].numpy() ** 2
        off = ~np.eye(10, dtype=bool)
        rel = np.abs(pred_var[off] - emp_var[off]) / emp_var[off]
        # exact for the additive part, first order in the bilinear term
        assert np.median(rel) < 0.1
        assert np.mean(rel) < 0.2

    def test_coverage_near_nominal(self):
        """90 % predictive intervals cover ~90 % of exact forecast draws."""
        model, vi = _fitted()
        mean, std = vi.predict_dyads(1)
        m0, s0 = mean[..., 0, 0].numpy(), std[..., 0, 0].numpy()
        mu_dyad, rng = _forecast_draws(model, vi, 500, 1)
        y = mu_dyad + np.sqrt(float(model.params.R[0, 0])) * \
            rng.standard_normal(mu_dyad.shape)
        off = ~np.eye(10, dtype=bool)
        z = 1.6449  # 90 % two-sided
        cov = compute_coverage(
            torch.tensor(np.broadcast_to(m0, y.shape)[:, off]),
            torch.tensor(np.broadcast_to(m0 - z * s0, y.shape)[:, off]),
            torch.tensor(np.broadcast_to(m0 + z * s0, y.shape)[:, off]),
            torch.tensor(y[:, off]))
        assert 0.84 < cov < 0.96

    def test_predict_forward_is_the_ar_mean(self):
        model, vi = _fitted()
        preds = vi.predict_forward(4)
        x = vi.X_mean[:, -1]
        for h in range(4):
            x = x @ model.params.Phi.T
            assert torch.equal(preds[:, h], x)
        assert torch.equal(vi.predict_forward_with_cov(4)[0], preds)

    def test_first_step_is_one_ar_step(self):
        """One step of the covariance recursion is Phi S Phi' + Q."""
        model, vi = _fitted()
        _, Sigs = vi.predict_forward_with_cov(1)
        Phi, Q = model.params.Phi, model.params.Q
        want = Phi @ vi.X_cov[:, -1] @ Phi.T + Q
        np.testing.assert_allclose(Sigs[:, 0].numpy(), want.numpy(),
                                   rtol=RTOL, atol=1e-7)


class TestAgainstJax:
    """A JAX engine fit, its state carried to the port engine: the
    forecasts agree within 1e-5 relative."""

    @pytest.fixture(scope="class")
    def pair(self):
        jmodel = JaxTemporalAMEModel(n_nodes=9, n_time=5, latent_dim=2,
                                     seed=3)
        jmodel.generate_data()
        jvi = JaxGood(jmodel, factorization="good", learning_rate=0.8)
        jvi.fit(max_iter=30, tolerance=0.0, verbose=False)
        model = TemporalAMEModel(n_nodes=9, n_time=5, latent_dim=2, seed=3,
                                 device="cpu")
        model.Y = torch.tensor(np.asarray(jmodel.Y))
        model.params = params_from_numpy(jmodel.params)
        vi = TemporalAMEStructuredMFVI(model, learning_rate=0.8)
        vi.X_mean = torch.tensor(np.asarray(jvi.X_mean))
        vi.X_cov = torch.tensor(np.asarray(jvi.X_cov))
        return jvi, vi

    @staticmethod
    def _close(got, ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                                   atol=RTOL * np.abs(ref).max())

    def test_predict_forward_with_cov(self, pair):
        jvi, vi = pair
        jm, jS = jvi.predict_forward_with_cov(5)
        m, S = vi.predict_forward_with_cov(5)
        self._close(m, jm)
        self._close(S, jS)
        self._close(vi.predict_forward(5), jvi.predict_forward(5))

    def test_predict_dyads(self, pair):
        jvi, vi = pair
        jmean, jstd = jvi.predict_dyads(5)
        mean, std = vi.predict_dyads(5)
        self._close(mean, jmean)
        self._close(std, jstd)

    def test_functions_match_the_engine(self, pair):
        """The module-level forecasts (what a caller holding only a state
        uses) give the engine's bits."""
        _, vi = pair
        mus, Sigs = forecast_states(vi.X_mean[:, -1], vi.X_cov[:, -1],
                                    vi.params, 2)
        mean, std = forecast_dyads(mus, Sigs, vi.params.R)
        got_mean, got_std = vi.predict_dyads(2)
        assert torch.equal(mean, got_mean) and torch.equal(std, got_std)
