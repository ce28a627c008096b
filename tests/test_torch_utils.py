"""The port's evaluation utilities: every function of
``tame_torch.utils.{alignment, metrics, diagnostics}`` against
``tame.utils`` on the same numpy inputs (within 1e-5 relative in float32;
aligned outputs and errors, not rotation matrices, whose signs an SVD may
flip), plus the invariants of ``tests/test_utils.py``'s TestAlignment,
TestMetrics and TestDiagnostics run on the port.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tame.utils as J
import tame_torch.utils as P

torch.set_num_threads(1)

RTOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(*shape, seed=0):
    return _rng(seed).normal(size=shape).astype(np.float32)


def _close(got, ref, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _rotation(theta, k):
    R = np.eye(k, dtype=np.float32)
    R[:2, :2] = [[np.cos(theta), -np.sin(theta)],
                 [np.sin(theta), np.cos(theta)]]
    return R


# ---------------------------------------------------------------------------
# Parity with tame.utils
# ---------------------------------------------------------------------------

class TestAlignmentParity:
    def test_procrustes(self):
        X = _f32(20, 3, seed=1)
        X_est = X @ _rotation(0.7, 3) + 0.05 * _f32(20, 3, seed=2)
        for scaling in (False, True):
            got, R = P.procrustes_alignment(torch.tensor(2.0 * X_est),
                                            torch.tensor(X), scaling)
            ref, _ = J.procrustes_alignment(jnp.asarray(2.0 * X_est),
                                            jnp.asarray(X), scaling)
            _close(got, ref)
            assert float(torch.linalg.det(R)) > 0

    @pytest.mark.parametrize("dim", [-1, 0, 1])
    def test_align_signs(self, dim):
        X, T = _f32(6, 4, seed=3), _f32(6, 4, seed=4)
        _close(P.align_signs(torch.tensor(X), torch.tensor(T), dim),
               J.align_signs(jnp.asarray(X), jnp.asarray(T), dim))

    def test_align_latent_positions(self):
        M_true = _f32(15, 4, seed=5)
        M_est = (np.concatenate([M_true[:, :2] @ _rotation(0.5, 2),
                                 -M_true[:, 2:]], 1)
                 + 0.1 * _f32(15, 4, seed=6))
        _close(P.align_latent_positions(torch.tensor(M_est),
                                        torch.tensor(M_true), 2),
               J.align_latent_positions(jnp.asarray(M_est),
                                        jnp.asarray(M_true), 2))

    @pytest.mark.parametrize("each", [True, False])
    def test_align_temporal_states(self, each):
        X_true = _f32(10, 5, 6, seed=7)
        X_est = -(X_true + 0.3 * _f32(10, 5, 6, seed=8))
        X_est[..., 2:4] = X_est[..., 2:4] @ _rotation(0.4, 2)
        _close(P.align_temporal_states(torch.tensor(X_est),
                                       torch.tensor(X_true), 2, each),
               J.align_temporal_states(jnp.asarray(X_est),
                                       jnp.asarray(X_true), 2, each))

    @pytest.mark.parametrize("shape,latent_dim",
                             [((8, 4, 6), 2), ((8, 6), 2), ((8, 6), None)])
    def test_alignment_error_and_correlation(self, shape, latent_dim):
        X_true = _f32(*shape, seed=9)
        X_est = X_true + 0.2 * _f32(*shape, seed=10)
        err, aligned = P.compute_alignment_error(
            torch.tensor(X_est), torch.tensor(X_true), latent_dim)
        jerr, jaligned = J.compute_alignment_error(
            jnp.asarray(X_est), jnp.asarray(X_true), latent_dim)
        assert err == pytest.approx(jerr, rel=RTOL)
        _close(aligned, jaligned)
        if latent_dim is not None:
            assert P.compute_correlation_after_alignment(
                torch.tensor(X_est), torch.tensor(X_true), latent_dim
            ) == pytest.approx(J.compute_correlation_after_alignment(
                jnp.asarray(X_est), jnp.asarray(X_true), latent_dim),
                rel=RTOL)


def _pair(shape=(6, 6, 4, 2), seed=11):
    a = _f32(*shape, seed=seed)
    return a, a + 0.3 * _f32(*shape, seed=seed + 1)


class TestMetricsParity:
    @pytest.mark.parametrize("name", [
        "mean_squared_error", "root_mean_squared_error",
        "mean_absolute_error", "r_squared", "pearson_correlation"])
    @pytest.mark.parametrize("masked", [False, True])
    def test_pointwise_metrics(self, name, masked):
        y, p = _pair()
        mask = ((_rng(13).random(y.shape) > 0.3).astype(np.float32)
                if masked else None)
        got = getattr(P, name)(torch.tensor(y), torch.tensor(p),
                               None if mask is None else torch.tensor(mask))
        ref = getattr(J, name)(jnp.asarray(y), jnp.asarray(p),
                               None if mask is None else jnp.asarray(mask))
        assert got == pytest.approx(ref, rel=RTOL)

    @pytest.mark.parametrize("order", [1, 2, 3])
    def test_temporal_consistency(self, order):
        X = _f32(5, 10, 3, seed=14)
        assert P.temporal_consistency_score(torch.tensor(X), order) == \
            pytest.approx(J.temporal_consistency_score(jnp.asarray(X),
                                                       order), rel=RTOL)

    def test_link_prediction(self):
        y, p = _pair((10, 10), 15)
        assert P.link_prediction_metrics(torch.tensor(y), torch.tensor(p),
                                         0.2) == pytest.approx(
            J.link_prediction_metrics(jnp.asarray(y), jnp.asarray(p), 0.2))

    def test_calibration_and_coverage(self):
        y, p = _pair((200,), 16)
        unc = np.abs(_f32(200, seed=18))
        assert P.calibration_error(torch.tensor(p), torch.tensor(unc),
                                   torch.tensor(y), 7) == pytest.approx(
            J.calibration_error(p, unc, y, 7), rel=RTOL)
        lo, hi = p - unc, p + unc
        assert P.compute_coverage(torch.tensor(p), torch.tensor(lo),
                                  torch.tensor(hi), torch.tensor(y)) == \
            pytest.approx(J.compute_coverage(jnp.asarray(p), jnp.asarray(lo),
                                             jnp.asarray(hi),
                                             jnp.asarray(y)), rel=RTOL)

    @pytest.mark.parametrize("horizon", [1, 3])
    def test_temporal_prediction_metrics(self, horizon):
        y, p = _pair()
        got = P.temporal_prediction_metrics(torch.tensor(y), torch.tensor(p),
                                            horizon)
        ref = J.temporal_prediction_metrics(jnp.asarray(y), jnp.asarray(p),
                                            horizon)
        assert got == pytest.approx(ref, rel=RTOL)

    def test_relative_error(self):
        y, p = _pair()
        assert P.relative_error(torch.tensor(y), torch.tensor(p)) == \
            pytest.approx(J.relative_error(jnp.asarray(y), jnp.asarray(p)),
                          rel=RTOL)


class TestDiagnosticsParity:
    @pytest.mark.parametrize("shape", [(6, 6, 2), (6, 6, 4, 2)])
    @pytest.mark.parametrize("exclude", [True, False])
    def test_reconstruction_error(self, shape, exclude):
        y, p = _pair(shape, 19)
        assert P.compute_reconstruction_error(
            torch.tensor(y), torch.tensor(p), exclude) == pytest.approx(
            J.compute_reconstruction_error(jnp.asarray(y), jnp.asarray(p),
                                           exclude), rel=RTOL)

    @pytest.mark.parametrize("exclude", [True, False])
    def test_contributions(self, exclude):
        X = _f32(8, 5, 6, seed=20)
        A, M = X[:, 0, :2], X[:, 0, 2:]
        assert P.compute_additive_contribution(
            torch.tensor(A), exclude) == pytest.approx(
            J.compute_additive_contribution(jnp.asarray(A), exclude),
            rel=RTOL)
        assert P.compute_multiplicative_contribution(
            torch.tensor(M), exclude) == pytest.approx(
            J.compute_multiplicative_contribution(jnp.asarray(M), exclude),
            rel=RTOL)
        add, mult = P.compute_temporal_contributions(torch.tensor(X), 2,
                                                     exclude)
        jadd, jmult = J.compute_temporal_contributions(jnp.asarray(X), 2,
                                                       exclude)
        _close(add, jadd)
        _close(mult, jmult)
        assert P.compute_contribution_ratio(
            torch.tensor(A), torch.tensor(M)) == pytest.approx(
            J.compute_contribution_ratio(jnp.asarray(A), jnp.asarray(M)),
            rel=RTOL)

    def test_state_error_and_uv_correlation(self):
        X, Xp = _pair((8, 5, 6), 21)
        assert P.compute_state_prediction_error(
            torch.tensor(X), torch.tensor(Xp)) == pytest.approx(
            J.compute_state_prediction_error(jnp.asarray(X),
                                             jnp.asarray(Xp)), rel=RTOL)
        M, Mp = _pair((10, 4), 22)
        assert P.compute_uv_product_correlation(
            torch.tensor(Mp), torch.tensor(M), 2) == pytest.approx(
            J.compute_uv_product_correlation(jnp.asarray(Mp),
                                             jnp.asarray(M), 2), rel=RTOL)

    def test_printed_reports_match(self, mock_history, capsys):
        X, Xp = _pair((8, 5, 6), 23)
        results = {"A": {"history": mock_history, "X_est": Xp},
                   "B": {"history": {"elbo": [-1.0],
                                     "reconstruction_error": [0.9]},
                         "X_est": X}}
        J.print_diagnostic_summary("m", mock_history, jnp.asarray(X),
                                   jnp.asarray(Xp), 2)
        J.compare_methods(results, X_true=jnp.asarray(X))
        ref = capsys.readouterr().out
        P.print_diagnostic_summary("m", mock_history, torch.tensor(X),
                                   torch.tensor(Xp), 2)
        P.compare_methods(results, X_true=torch.tensor(X))
        assert capsys.readouterr().out == ref

    def test_convergence_and_gap(self):
        for hist in ({"elbo": [1.0] * 20}, {"elbo": list(range(20))},
                     {"elbo": [1.0, 1.00001] * 10, "mse": [0.5] * 3}):
            assert P.track_convergence(hist, 5) == J.track_convergence(
                hist, 5)
        assert P.compute_elbo_gap([-10.0, -5.0], -4.0) == \
            J.compute_elbo_gap([-10.0, -5.0], -4.0)

    def test_chain_diagnostics(self):
        rng = _rng(24)
        x = np.cumsum(rng.normal(size=(4, 200, 3, 2)), axis=1).astype(
            np.float32) * 0.1 + rng.normal(size=(4, 200, 3, 2)).astype(
            np.float32)
        ld = rng.normal(size=(4, 200)).astype(np.float32)
        _close(P.split_rhat(torch.tensor(x)), J.split_rhat(jnp.asarray(x)))
        _close(P.effective_sample_size(torch.tensor(x)),
               J.effective_sample_size(jnp.asarray(x)))
        got = P.chain_diagnostics(torch.tensor(x), torch.tensor(ld))
        ref = J.chain_diagnostics(jnp.asarray(x), jnp.asarray(ld))
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=RTOL), k


# ---------------------------------------------------------------------------
# tests/test_utils.py's invariants on the port
# ---------------------------------------------------------------------------

class TestAlignment:
    def test_procrustes_recovers_rotation(self):
        X = torch.tensor(_f32(20, 3, seed=30))
        X_aligned, _ = P.procrustes_alignment(
            X @ torch.tensor(_rotation(0.7, 3)), X)
        assert torch.allclose(X_aligned, X, atol=1e-4)

    def test_procrustes_handles_reflection(self):
        X = torch.tensor(_f32(20, 2, seed=31))
        _, R = P.procrustes_alignment(X * torch.tensor([1.0, -1.0]), X)
        assert float(torch.linalg.det(R)) > 0  # a proper rotation

    def test_procrustes_scaling(self):
        X = torch.tensor(_f32(20, 3, seed=32))
        X_aligned, _ = P.procrustes_alignment(2.5 * X, X, scaling=True)
        assert torch.allclose(X_aligned, X, atol=1e-3)

    def test_sign_flip_recovery(self):
        X = torch.tensor(_f32(10, 3, seed=33))
        flips = torch.tensor([1.0, -1.0] * 5)[:, None]
        assert torch.allclose(P.align_signs(X * flips, X, dim=1), X)

    def test_align_latent_positions_improves(self):
        M_true = torch.tensor(_f32(15, 4, seed=34))
        R = torch.tensor(_rotation(0.5, 2))
        M_est = torch.cat([M_true[:, :2] @ R, M_true[:, 2:] @ R], 1)
        M_aligned = P.align_latent_positions(M_est, M_true, latent_dim=2)
        err_before = float(torch.mean((M_est - M_true) ** 2))
        err_after = float(torch.mean((M_aligned - M_true) ** 2))
        assert err_after <= err_before + 1e-6
        assert err_after < 1e-6

    def test_temporal_alignment_shapes_and_improvement(self):
        X_true = torch.tensor(_f32(10, 5, 6, seed=35))
        X_est = -(X_true + 0.01 * torch.tensor(_f32(10, 5, 6, seed=36)))
        X_aligned = P.align_temporal_states(X_est, X_true, latent_dim=2)
        assert X_aligned.shape == X_true.shape
        assert float(torch.mean((X_aligned - X_true) ** 2)) < float(
            torch.mean((X_est - X_true) ** 2))

    def test_global_alignment_mode(self):
        X_true = torch.tensor(_f32(10, 5, 6, seed=37))
        X_aligned = P.align_temporal_states(X_true, X_true, latent_dim=2,
                                            align_each_time=False)
        assert float(torch.mean((X_aligned - X_true) ** 2)) < 1e-6

    def test_compute_alignment_error_api(self):
        X_true = torch.tensor(_f32(8, 4, 6, seed=38))
        err, _ = P.compute_alignment_error(X_true, X_true, latent_dim=2)
        assert err < 1e-8
        with pytest.raises(ValueError):
            P.compute_alignment_error(X_true, X_true, latent_dim=None)

    def test_correlation_after_alignment(self):
        X_true = torch.tensor(_f32(8, 4, 6, seed=39))
        assert P.compute_correlation_after_alignment(
            X_true, X_true, latent_dim=2) > 0.999


class TestMetrics:
    def test_mse_identity(self):
        y = torch.arange(10.0)
        assert P.mean_squared_error(y, y) == 0.0
        assert P.mean_squared_error(y, y + 1.0) == pytest.approx(1.0)

    def test_rmse_is_sqrt_mse(self):
        y1, y2 = torch.tensor(_f32(50, seed=40)), torch.tensor(_f32(50,
                                                                    seed=41))
        assert P.root_mean_squared_error(y1, y2) == pytest.approx(
            math.sqrt(P.mean_squared_error(y1, y2)), rel=1e-5)

    def test_r2_at_truth(self):
        y = torch.tensor(_f32(100, seed=42))
        assert P.r_squared(y, y) == pytest.approx(1.0)

    def test_pearson_anticorrelation(self):
        y = torch.tensor(_f32(100, seed=43))
        assert P.pearson_correlation(y, -y) == pytest.approx(-1.0, abs=1e-5)

    def test_masked_metrics(self):
        y_true = torch.tensor([1.0, 2.0, 3.0, 4.0])
        y_pred = torch.tensor([1.0, 2.0, 100.0, 4.0])
        mask = torch.tensor([1.0, 1.0, 0.0, 1.0])
        assert P.mean_squared_error(y_true, y_pred, mask) == 0.0
        assert P.mean_absolute_error(y_true, y_pred, mask) == 0.0

    def test_temporal_consistency(self):
        assert P.temporal_consistency_score(torch.ones(5, 10, 3)) == 0.0
        assert P.temporal_consistency_score(
            torch.tensor(_f32(5, 10, 3, seed=44))) > 0.0

    def test_link_prediction_perfect(self):
        Y = torch.tensor(_f32(10, 10, seed=45))
        m = P.link_prediction_metrics(Y, Y)
        assert m["accuracy"] == pytest.approx(1.0)
        assert m["f1"] == pytest.approx(1.0)

    def test_coverage(self):
        targets = torch.tensor([0.0, 0.5, 2.0, -3.0])
        cov = P.compute_coverage(targets, torch.full((4,), -1.0),
                                 torch.full((4,), 1.0), targets)
        assert cov == pytest.approx(0.5)

    def test_calibration_error_perfect(self):
        preds = torch.zeros(100)
        targets = torch.ones(100) * 0.5
        unc = torch.ones(100) * 0.5  # predicted uncertainty == actual error
        assert P.calibration_error(preds, unc, targets) == pytest.approx(
            0.0, abs=1e-6)

    def test_temporal_prediction_metrics(self):
        Y = torch.tensor(_f32(6, 6, 4, 2, seed=46))
        assert P.temporal_prediction_metrics(Y, Y, horizon=1)["mse"] == \
            pytest.approx(0.0)
        assert P.temporal_prediction_metrics(Y, Y, horizon=10)["mse"] == \
            float("inf")

    def test_relative_error(self):
        y = torch.tensor([1.0, 2.0])
        assert P.relative_error(y, y) == pytest.approx(0.0)


class TestDiagnostics:
    def test_reconstruction_error_normalizations(self):
        """Per-entry normalization, half the history's per-dyad one."""
        Y = _f32(6, 6, 4, 2, seed=47)
        err = P.compute_reconstruction_error(torch.tensor(Y),
                                             torch.zeros(6, 6, 4, 2))
        mask = ~np.eye(6, dtype=bool)
        expected = float((Y[mask] ** 2).sum() / (6 * 5 * 4 * 2))
        assert err == pytest.approx(expected, rel=1e-5)

    def test_temporal_contributions(self):
        add, mult = P.compute_temporal_contributions(
            torch.tensor(_f32(8, 5, 6, seed=48)), latent_dim=2)
        assert add.shape == (5,) and mult.shape == (5,)
        assert bool((add >= 0).all())

    def test_contribution_ratio_inf(self):
        assert P.compute_contribution_ratio(torch.ones(5, 2),
                                            torch.zeros(5, 4)) == float("inf")

    def test_print_summary(self, mock_history, capsys):
        P.print_diagnostic_summary("Test Method", mock_history)
        out = capsys.readouterr().out
        assert "Test Method" in out
        assert "Final ELBO" in out
        assert "reconstruction MSE" in out

    def test_compare_methods_output(self, mock_history, capsys):
        P.compare_methods({
            "A": {"history": mock_history},
            "B": {"history": {"elbo": [-1.0],
                              "reconstruction_error": [0.9]}},
        })
        out = capsys.readouterr().out
        assert "Method Comparison" in out
        assert "1. A" in out  # A has the lower error

    def test_track_convergence(self):
        assert P.track_convergence({"elbo": [1.0] * 20})["elbo"] is True
        assert P.track_convergence({"elbo": list(range(20))})["elbo"] is False
        assert P.track_convergence({"elbo": [1.0]})["elbo"] is False

    def test_elbo_gap(self):
        assert P.compute_elbo_gap([-10.0, -5.0], -4.0) == pytest.approx(1.0)
        assert P.compute_elbo_gap([-10.0], None) is None
        assert P.compute_elbo_gap([], -4.0) is None

    def test_uv_product_correlation_identity(self):
        M = torch.tensor(_f32(10, 4, seed=49))
        assert P.compute_uv_product_correlation(M, M, 2) == pytest.approx(
            1.0, abs=1e-5)

    def test_rhat_and_ess_of_independent_chains(self):
        """Well-mixed independent draws: R-hat near 1, ESS near the draw
        count; a chain stuck apart from the others drives R-hat up."""
        x = torch.tensor(_f32(4, 500, 3, seed=50))
        assert float(P.split_rhat(x).max()) < 1.05
        assert float(P.effective_sample_size(x).min()) > 1000
        x[0] += 5.0
        assert float(P.split_rhat(x).max()) > 1.5
        with pytest.raises(ValueError, match="4 draws"):
            P.split_rhat(torch.zeros(2, 3))
