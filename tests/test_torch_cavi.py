"""Port parity for the CAVI core: the same numpy ``Y``, parameters and
initial state go through ``tame.inference.cavi`` (JAX, CPU) and
``tame_torch.inference.cavi``; assembly terms, ELBO, fits and the K3 twin
must agree at the stated tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tame.config
from tame.inference import cavi as jcavi
from tame.models.params import build_params as jax_build_params
from tame_torch.inference import cavi as tcavi
from tame_torch.models import params_from_numpy
from tame_torch.ops import fused_fit as tff

torch.set_num_threads(1)

# Elementwise assembly in f32 with sums of <= n*T terms in another order.
RTOL_TERMS = 1e-5
# Whole fits: f32 reductions in another order compound over iterations
# (the JAX package holds its fused and unfused paths to the same bounds).
RTOL_HIST = 1e-4
ATOL_STATE = 1e-4


def _problem(n=8, T=4, r=2, structure="full", seed=0, rho=0.5):
    """Numpy data in the reciprocal layout, JAX params and a numpy init."""
    rng = np.random.default_rng(seed)
    d = 2 + 2 * r
    X = 0.8 * rng.standard_normal((n, T, d))
    fwd = (X[:, None, :, 0] + X[None, :, :, 1]
           + np.einsum("itr,jtr->ijt", X[..., 2:2 + r], X[..., 2 + r:]))
    y = fwd + 0.3 * rng.standard_normal((n, n, T))
    y[np.arange(n), np.arange(n)] = 0.0
    Y = np.stack([y, y.transpose(1, 0, 2)], -1).astype(np.float32)
    jparams = jax_build_params(tame.config.ModelConfig(
        n_nodes=n, n_time=T, latent_dim=r, rho_dyadic=rho))
    X_mean = (0.1 * rng.standard_normal((n, T, d))).astype(np.float32)
    eye = np.eye(d, dtype=np.float32)
    if structure == "diag":
        X_cov = np.broadcast_to(0.5 * eye, (n, T, d, d))
    else:
        noise = 0.01 * rng.standard_normal((n, T, d, d))
        X_cov = 0.6 * eye + 0.5 * (noise + noise.swapaxes(-1, -2))
        if structure == "block":
            X_cov[..., :2, 2:] = 0.0
            X_cov[..., 2:, :2] = 0.0
    X_cov = np.ascontiguousarray(X_cov, np.float32)
    return Y, jparams, X_mean, X_cov


def _both(Y, jparams, X_mean, X_cov):
    jstate = jcavi.CaviState(X_mean=jnp.asarray(X_mean),
                             X_cov=jnp.asarray(X_cov))
    tstate = tcavi.state_from_numpy(jstate)
    return (jnp.asarray(Y), jparams, jstate,
            torch.from_numpy(Y), params_from_numpy(jparams), tstate)


def _close(got, ref, rtol=RTOL_TERMS, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _assert_fits_agree(tres, jres, n_check):
    assert tres.n_iter == int(jres.n_iter)
    assert tres.converged == bool(jres.converged)
    assert tres.diverged == bool(jres.diverged)
    eh_t = tres.elbo_history.numpy()[:n_check]
    eh_j = np.asarray(jres.elbo_history)[:n_check]
    assert np.isnan(eh_t).tolist() == np.isnan(eh_j).tolist()
    assert np.nanmax(np.abs(eh_t - eh_j) / np.abs(eh_j)) < RTOL_HIST
    mh_t = tres.mse_history.numpy()[:n_check]
    mh_j = np.asarray(jres.mse_history)[:n_check]
    assert np.nanmax(np.abs(mh_t - mh_j) / np.abs(mh_j)) < RTOL_HIST
    _close(tres.X_mean, jres.X_mean, rtol=0, atol=ATOL_STATE)
    _close(tres.X_cov, jres.X_cov, rtol=0, atol=ATOL_STATE)


class TestAssemblyTerms:
    @pytest.fixture
    def inputs(self):
        Y, jp, Xm, Xc = _problem(n=7, T=4)
        return _both(Y, jp, Xm, Xc)

    def test_obs_precision(self, inputs):
        _, jp, js, _, tp, ts = inputs
        r = 2
        ref = jcavi._obs_precision(js.X_mean[..., 2:2 + r],
                                   js.X_mean[..., 2 + r:], jp.R_inv)
        got = tcavi._obs_precision(ts.X_mean[..., 2:2 + r],
                                   ts.X_mean[..., 2 + r:], tp.R_inv)
        _close(got, ref)

    @pytest.mark.parametrize("corrected", [False, True])
    def test_obs_nat_param(self, inputs, corrected):
        jY, jp, js, tY, tp, ts = inputs
        ref = jcavi._obs_nat_param(jcavi.precompute_obs_constants(
            jY, jp.R_inv), js.X_mean, 2, jp.R_inv, corrected)
        got = tcavi._obs_nat_param(tcavi.precompute_obs_constants(
            tY, tp.R_inv), ts.X_mean, 2, tp.R_inv, corrected)
        _close(got, ref)

    def test_priors(self, inputs):
        _, jp, js, _, tp, ts = inputs
        jpri, tpri = jcavi.precompute_priors(jp), tcavi.precompute_priors(tp)
        for name in jpri._fields:
            _close(getattr(tpri, name), getattr(jpri, name))
        _close(tcavi._prior_precision(tpri, 4),
               jcavi._prior_precision(jpri, 4))
        _close(tcavi._prior_nat_param(tpri, ts.X_mean),
               jcavi._prior_nat_param(jpri, js.X_mean))

    @pytest.mark.parametrize("structure", ["diag", "full", "block"])
    def test_compute_elbo_and_entropy(self, structure):
        Y, jp, Xm, Xc = _problem(n=7, T=4, structure=structure, seed=2)
        jY, jp, js, tY, tp, ts = _both(Y, jp, Xm, Xc)
        ref = jcavi.compute_elbo(jY, jp, jcavi.precompute_priors(jp), js,
                                 structure)
        got = tcavi.compute_elbo(tY, tp, tcavi.precompute_priors(tp), ts,
                                 structure)
        _close(float(got), float(ref))
        _close(float(tcavi.gaussian_entropy(ts)),
               float(jcavi.gaussian_entropy(js)))

    @pytest.mark.parametrize("structure", ["diag", "full", "block"])
    def test_solvers(self, structure):
        rng = np.random.default_rng(9)
        A = rng.standard_normal((11, 6, 6)).astype(np.float32)
        P = A @ A.transpose(0, 2, 1) / 6 + np.eye(6, dtype=np.float32)
        eta = rng.standard_normal((11, 6)).astype(np.float32)
        ref = jcavi._SOLVERS[structure](jnp.asarray(P), jnp.asarray(eta))
        got = tcavi._SOLVERS[structure](torch.from_numpy(P),
                                        torch.from_numpy(eta))
        for g, r in zip(got, ref):
            _close(g, r)


class TestObservationTermOracle:
    """The port's batched sufficient-statistics assembly against the direct
    per-(i, j, t) Jacobian accumulation (as ``tame``'s own oracle test)."""

    def test_matches_direct_loop(self):
        Y, jp, _, _ = _problem(n=6, T=3, seed=11)
        r, n = 2, 6
        rng = np.random.default_rng(12)
        X = rng.standard_normal((n, 3, 6)).astype(np.float32)
        R_inv = np.asarray(jp.R_inv, np.float64)
        tX = torch.from_numpy(X)
        P_all = tcavi._obs_precision(tX[..., 2:2 + r], tX[..., 2 + r:],
                                     torch.from_numpy(R_inv).float())
        obs = tcavi.precompute_obs_constants(torch.from_numpy(Y),
                                             torch.from_numpy(R_inv).float())
        eta_all = tcavi._obs_nat_param(obs, tX, r,
                                       torch.from_numpy(R_inv).float(), False)
        for i, t in [(0, 0), (3, 1), (n - 1, 2)]:
            P_ref, eta_ref = np.zeros((6, 6)), np.zeros(6)
            for j in range(n):
                if j == i:
                    continue
                J = np.zeros((2, 6))
                J[0, 0], J[1, 1] = 1.0, 1.0
                J[0, 2:2 + r] = X[j, t, 2 + r:]      # V_j
                J[1, 2 + r:] = X[j, t, 2:2 + r]      # U_j
                P_ref += J.T @ R_inv @ J
                eta_ref += J.T @ R_inv @ Y[i, j, t]
            # f32 sums of n-1 terms against an f64 loop
            np.testing.assert_allclose(P_all[i, t].numpy(), P_ref, atol=1e-4)
            np.testing.assert_allclose(eta_all[i, t].numpy(), eta_ref,
                                       atol=1e-4)


class TestFitParity:
    @pytest.mark.parametrize("update_mode", ["jacobi", "block"])
    @pytest.mark.parametrize("structure", ["full", "diag", "block"])
    def test_fit_cavi_matches_jax(self, update_mode, structure):
        Y, jp, Xm, Xc = _problem(n=8, T=4, structure=structure, seed=1)
        jY, jp, js, tY, tp, ts = _both(Y, jp, Xm, Xc)
        # tolerance 1e-3: "full" and "diag" stop inside the budget, the
        # bad-SMF control ("block") keeps moving and runs it out.
        kw = dict(structure=structure, update_mode=update_mode, max_iter=60,
                  learning_rate=0.7, tolerance=1e-3, fused=False)
        if update_mode == "block":
            kw["num_blocks"] = 4
        jres = jcavi.fit_cavi(jY, jp, js, **kw)
        tres = tcavi.fit_cavi(tY, tp, ts, **kw)
        assert tres.converged == (structure != "block")
        _assert_fits_agree(tres, jres, 60)

    def test_corrected_default_blocks_matches_jax(self):
        Y, jp, Xm, Xc = _problem(n=12, T=5, seed=3)
        jY, jp, js, tY, tp, ts = _both(Y, jp, Xm, Xc)
        kw = dict(structure="full", update_mode="block", max_iter=60,
                  learning_rate=1.0, tolerance=1e-3, corrected=True,
                  fused=False)
        jres = jcavi.fit_cavi(jY, jp, js, **kw)
        tres = tcavi.fit_cavi(tY, tp, ts, **kw)
        assert tres.converged and tres.n_iter < 60
        _assert_fits_agree(tres, jres, 60)

    def test_elbo_every_matches_jax(self):
        Y, jp, Xm, Xc = _problem(n=6, T=3, seed=4)
        jY, jp, js, tY, tp, ts = _both(Y, jp, Xm, Xc)
        kw = dict(structure="full", update_mode="block", max_iter=21,
                  learning_rate=0.7, tolerance=1e-3, elbo_every=4,
                  fused=False)
        jres = jcavi.fit_cavi(jY, jp, js, **kw)
        tres = tcavi.fit_cavi(tY, tp, ts, **kw)
        # evaluated every 4th iteration and at the last (21 is not one)
        evaluated = ~torch.isnan(tres.elbo_history[:21])
        assert evaluated.nonzero().flatten().tolist() == [3, 7, 11, 15, 19,
                                                          20]
        _assert_fits_agree(tres, jres, 21)

    def test_fixed_100_iteration_trajectory_matches_jax(self):
        Y, jp, Xm, Xc = _problem(n=10, T=5, seed=13)
        jY, jp, js, tY, tp, ts = _both(Y, jp, Xm, Xc)
        kw = dict(structure="full", update_mode="jacobi", max_iter=100,
                  learning_rate=0.5, tolerance=0.0, fused=False)
        jres = jcavi.fit_cavi(jY, jp, js, **kw)
        tres = tcavi.fit_cavi(tY, tp, ts, **kw)
        assert tres.n_iter == 100
        _assert_fits_agree(tres, jres, 100)

    def test_divergence_halts_like_jax(self):
        """lr=1.5 over-relaxes the covariances out of the SPD cone: the
        ELBO goes NaN and both packages halt at once, flagged."""
        Y, jp, Xm, Xc = _problem(n=8, T=4, seed=1)
        jY, jp, js, tY, tp, ts = _both(Y, jp, Xm, Xc)
        kw = dict(structure="full", update_mode="jacobi", max_iter=60,
                  learning_rate=1.5, tolerance=0.0, fused=False)
        jres = jcavi.fit_cavi(jY, jp, js, **kw)
        tres = tcavi.fit_cavi(tY, tp, ts, **kw)
        assert tres.diverged and bool(jres.diverged)
        assert tres.n_iter == int(jres.n_iter) == 1
        assert not tres.converged
        assert torch.isnan(tres.elbo_history).all()
        twin = tff.fused_fit_twin(tY, tp.R_inv, tp.Sigma0, tp.Q, tp.Phi,
                                  ts.X_mean, ts.X_cov, 60, 1.5, 0.0, r=2,
                                  buf_size=64)
        assert twin.diverged and twin.n_iter == 1

    def test_segments_continue_exactly(self):
        """carry_elbo/carry_patience continue a fit with the same stop."""
        Y, jp, Xm, Xc = _problem(n=6, T=3, seed=5)
        _, _, _, tY, tp, ts = _both(Y, jp, Xm, Xc)
        kw = dict(structure="full", update_mode="jacobi",
                  learning_rate=0.7, tolerance=1e-3)
        full = tcavi.fit_cavi(tY, tp, ts, max_iter=60, **kw)
        assert full.converged and full.n_iter > 6
        seg1 = tcavi.fit_cavi(tY, tp, ts, max_iter=6, **kw)
        seg2 = tcavi.fit_cavi(tY, tp, tcavi.CaviState(seg1.X_mean,
                                                      seg1.X_cov),
                              max_iter=54, carry_elbo=seg1.last_elbo,
                              carry_patience=seg1.pat_count, **kw)
        assert seg1.n_iter + seg2.n_iter == full.n_iter
        assert seg2.converged
        assert torch.equal(seg2.X_mean, full.X_mean)

    def test_history_buffer_is_power_of_two_and_nan_padded(self):
        Y, jp, Xm, Xc = _problem(n=6, T=3, seed=6)
        _, _, _, tY, tp, ts = _both(Y, jp, Xm, Xc)
        res = tcavi.fit_cavi(tY, tp, ts, max_iter=70, learning_rate=0.7,
                             tolerance=0.0)
        assert res.elbo_history.shape == (128,) and res.n_iter == 70
        assert torch.isnan(res.elbo_history[70:]).all()
        assert torch.isfinite(res.elbo_history[:70]).all()

    def test_stop_rule_divergence_and_patience(self):
        rule = tcavi._StopRule(None, 0, 1e-3, patience=2)
        rule.update(-100.0)          # first evaluation: nothing to compare
        assert rule.pat == 0 and rule.running
        rule.update(-100.0)
        rule.update(-100.0)
        assert rule.converged and not rule.diverged
        rule = tcavi._StopRule(-5.0, 1, 1e-3, patience=3)
        rule.update(None)            # not evaluated: carry unchanged
        assert rule.pat == 1 and rule.running
        rule.update(float("nan"))
        assert rule.diverged and not rule.converged and rule.pat == 0

    def test_unported_modes_raise(self):
        Y, jp, Xm, Xc = _problem(n=4, T=2, seed=7)
        _, _, _, tY, tp, ts = _both(Y, jp, Xm, Xc)
        # the production flags and a mask run
        for kw in [dict(diag_mode="stats"), dict(mixed_precision=True),
                   dict(mask=torch.ones(4, 4, 2))]:
            res = tcavi.fit_cavi(tY, tp, ts, max_iter=2, **kw)
            assert torch.isfinite(res.elbo_history[:2]).all()
        res = tcavi.fit_cavi(tY, tp, ts, update_mode="seq", max_iter=2)
        assert torch.isfinite(res.elbo_history[:2]).all()
        with pytest.raises(ValueError, match="update_mode"):
            tcavi.fit_cavi(tY, tp, ts, update_mode="sweep")
        with pytest.raises(ValueError, match="fused=True requires"):
            tcavi.fit_cavi(tY, tp, ts, elbo_every=2, fused=True)
        with pytest.raises(ValueError, match="fused=True requires"):
            tcavi.fit_cavi(tY, tp, ts, mixed_precision=True, fused=True)
        with pytest.raises(ValueError, match="diag_mode"):
            tcavi.fit_cavi(tY, tp, ts, diag_mode="bogus")
        with pytest.raises(ValueError, match="mask is supported"):
            tcavi.fit_cavi(tY, tp, ts, update_mode="seq",
                           mask=torch.ones(4, 4, 2))


class TestInitState:
    @pytest.mark.parametrize("structure", ["diag", "full", "block"])
    def test_structure_invariants(self, structure):
        s = tcavi.init_state(torch.Generator().manual_seed(0), 5, 3, 6,
                             structure, 0.1, 0.5)
        assert s.X_mean.shape == (5, 3, 6) and s.X_cov.shape == (5, 3, 6, 6)
        assert torch.equal(s.X_cov, s.X_cov.transpose(-1, -2))
        assert (torch.linalg.eigvalsh(s.X_cov) > 0).all()
        if structure == "diag":
            assert torch.equal(s.X_cov, torch.diag_embed(
                torch.diagonal(s.X_cov, dim1=-2, dim2=-1)))
        if structure == "block":
            assert (s.X_cov[..., :2, 2:] == 0).all()
        again = tcavi.init_state(torch.Generator().manual_seed(0), 5, 3, 6,
                                 structure, 0.1, 0.5)
        assert torch.equal(again.X_mean, s.X_mean)


class TestFusedTwinParity:
    """The port's K3 twin against the JAX megakernel in Pallas interpret
    mode (as tame's TestFusedFit runs it), on the same inputs."""

    @pytest.mark.parametrize("structure,corrected", [
        ("full", False), ("full", True), ("diag", False), ("block", False)])
    def test_twin_matches_jax_kernel(self, structure, corrected):
        Y, jp, Xm, Xc = _problem(n=6, T=3, structure=structure, seed=8)
        jY, jp, js, tY, tp, ts = _both(Y, jp, Xm, Xc)
        kw = dict(structure=structure, update_mode="block", num_blocks=3,
                  max_iter=12, learning_rate=0.7, tolerance=0.0,
                  corrected=corrected, fused=True)
        jres = jcavi.fit_cavi(jY, jp, js, **kw)
        tres = tcavi.fit_cavi(tY, tp, ts, **kw)
        _assert_fits_agree(tres, jres, 12)

    @pytest.mark.parametrize("fused", [True, "auto"])
    def test_disable_switch_sends_the_fit_to_the_loop(self, monkeypatch,
                                                      fused):
        """``TAME_DISABLE_FUSED_FIT=1`` keeps K3 (and its twin) off under
        ``fused=True`` and "auto", as in the JAX package: the fit is
        ``fit_loop``'s, and JAX's under the same switch agrees."""
        Y, jp, Xm, Xc = _problem(n=6, T=3, seed=8)
        jY, jp, js, tY, tp, ts = _both(Y, jp, Xm, Xc)
        kw = dict(structure="full", update_mode="block", num_blocks=3,
                  max_iter=12, learning_rate=0.7, tolerance=0.0)
        monkeypatch.setenv("TAME_DISABLE_FUSED_FIT", "1")

        def refuse(*args, **kwargs):
            raise AssertionError("K3 ran under TAME_DISABLE_FUSED_FIT=1")

        monkeypatch.setattr(tff, "fused_fit", refuse)
        tres = tcavi.fit_cavi(tY, tp, ts, fused=fused, **kw)
        loop = tcavi.fit_loop(tY, tp, ts, buf_size=64, patience=3,
                              corrected=False, elbo_every=1, **kw)
        assert tres.n_iter == loop.n_iter == 12
        for name in ("X_mean", "X_cov", "elbo_history", "mse_history"):
            torch.testing.assert_close(getattr(tres, name),
                                       getattr(loop, name), rtol=0, atol=0,
                                       equal_nan=True)
        _assert_fits_agree(tres, jcavi.fit_cavi(jY, jp, js, fused=fused,
                                                **kw), 12)

    def test_freeze_after_stop_matches_jax_kernel(self):
        Y, jp, Xm, Xc = _problem(n=6, T=3, seed=9)
        jY, jp, js, tY, tp, ts = _both(Y, jp, Xm, Xc)
        kw = dict(structure="full", update_mode="block", num_blocks=3,
                  max_iter=40, learning_rate=0.7, tolerance=1e-3,
                  fused=True)
        jres = jcavi.fit_cavi(jY, jp, js, **kw)
        tres = tff.fused_fit_twin(
            tY, tp.R_inv, tp.Sigma0, tp.Q, tp.Phi, ts.X_mean, ts.X_cov, 40,
            0.7, 1e-3, r=2, buf_size=64, num_blocks=3)
        assert bool(jres.converged) and tres.converged
        assert tres.n_iter < 40
        assert torch.isnan(tres.elbo_history[tres.n_iter:]).all()
        _assert_fits_agree(tres, jres, 40)
