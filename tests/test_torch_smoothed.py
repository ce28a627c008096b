"""Port parity for the smoothed (joint-trajectory) family: the same numpy
``Y``, parameters and state go through ``tame.inference.smoothed`` (JAX,
CPU) and ``tame_torch.inference.smoothed``.  A smoothed fit is chaotic
before it converges, so one step is compared tightly, a short horizon
closely and the fixed point loosely (as ``tame``'s own kernel-vs-scan
test does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tame.config
from tame.inference import cavi as jcavi
from tame.inference import smoothed as jsm
from tame.models.params import build_params as jax_build_params
from tame_torch import TemporalAMEModel, TemporalAMESmoothedVI
from tame_torch.inference import cavi as tcavi
from tame_torch.inference import smoothed as tsm
from tame_torch.models import params_from_numpy
from tame_torch.ops import fused_smoother as tfs

torch.set_num_threads(1)

# One step: assembly sums of <= n T terms and the smoother, f32 in another
# operation order; relative too, as means reach O(1) and logdets O(100).
TOL_STEP = 1e-5
# ELBO terms: f32 reductions over n T d^2 entries in another order.
RTOL_ELBO = 1e-6
# Short horizons: the same reductions compounded over 10 iterations.
RTOL_HIST = 1e-4
# Converged fixed point: pre-convergence float noise is amplified by the
# chaotic transient (tame's kernel-vs-scan bound).
ATOL_FIXED = 1e-3


def _data(n, T, r, seed):
    """Numpy data in the reciprocal layout and JAX params."""
    rng = np.random.default_rng(seed)
    d = 2 + 2 * r
    X = 0.8 * rng.standard_normal((n, T, d))
    fwd = (X[:, None, :, 0] + X[None, :, :, 1]
           + np.einsum("itr,jtr->ijt", X[..., 2:2 + r], X[..., 2 + r:]))
    y = fwd + 0.3 * rng.standard_normal((n, n, T))
    y[np.arange(n), np.arange(n)] = 0.0
    Y = np.stack([y, y.transpose(1, 0, 2)], -1).astype(np.float32)
    jp = jax_build_params(tame.config.ModelConfig(
        n_nodes=n, n_time=T, latent_dim=r))
    return Y, jp, rng


def _random_state(rng, n, T, d):
    """A numpy smoothed state: random means, 0.5 I covariances."""
    return jsm.SmoothedState(
        X_mean=jnp.asarray((0.1 * rng.standard_normal((n, T, d)))
                           .astype(np.float32)),
        X_cov=jnp.broadcast_to(0.5 * jnp.eye(d), (n, T, d, d)),
        X_cross=jnp.zeros((n, T - 1, d, d)),
        logdets=jnp.full((n,), -T * d * np.log(0.5), jnp.float32))


def _solved_state(Y, jp, rng, n, T, d):
    """A consistent state (covariances and logdets from a solve): one JAX
    smoothed step from a random state."""
    obs = jcavi.precompute_obs_constants(jnp.asarray(Y), jp.R_inv)
    return jsm.smoothed_step(_random_state(rng, n, T, d), obs,
                             jcavi.precompute_priors(jp), jp, 0.7)


def _both(Y, jp):
    tY, tp = torch.from_numpy(Y), params_from_numpy(jp)
    return (jnp.asarray(Y), jp, jcavi.precompute_obs_constants(
                jnp.asarray(Y), jp.R_inv), jcavi.precompute_priors(jp),
            tY, tp, tcavi.precompute_obs_constants(tY, tp.R_inv),
            tcavi.precompute_priors(tp))


def _close_state(got, ref, atol, rtol=0.0):
    for name in tsm.SmoothedState._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=rtol,
                                   atol=atol, err_msg=name)


def _assert_fits_agree(tres, jres, n_check, rtol=RTOL_HIST):
    assert tres.n_iter == int(jres.n_iter)
    assert tres.converged == bool(jres.converged)
    assert tres.diverged == bool(jres.diverged)
    for name in ("elbo_history", "mse_history"):
        t = getattr(tres, name).numpy()[:n_check]
        j = np.asarray(getattr(jres, name))[:n_check]
        assert np.isnan(t).tolist() == np.isnan(j).tolist()
        assert np.nanmax(np.abs(t - j) / np.abs(j)) < rtol, name


class TestWarmInit:
    def test_identified_quantities_match_jax_from_one_probe(self):
        Y, jp, _ = _data(10, 5, 2, seed=1)
        ref = jcavi.warm_init_state(jnp.asarray(Y), jp, structure="full")
        # the JAX default probe, handed to the port as numpy
        probe = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (10, 2),
                                             jnp.float32))
        got = tcavi.warm_init_state(torch.from_numpy(Y),
                                    params_from_numpy(jp), structure="full",
                                    probe=torch.from_numpy(probe))
        jm, tm = np.asarray(ref.X_mean), got.X_mean.numpy()
        # additive effects: elementwise f32 means of <= n T terms
        np.testing.assert_allclose(tm[..., :2], jm[..., :2], atol=1e-5)
        # U V' (SVD/QR signs may differ between the two LAPACK calls):
        # power iteration in f32
        np.testing.assert_allclose(
            np.einsum("itr,jtr->ijt", tm[..., 2:4], tm[..., 4:]),
            np.einsum("itr,jtr->ijt", jm[..., 2:4], jm[..., 4:]), atol=1e-4)
        np.testing.assert_array_equal(got.X_cov.numpy(),
                                      np.asarray(ref.X_cov))

    def test_smoothed_warm_init_and_cavi_engine_warm_mode(self):
        Y, jp, _ = _data(8, 4, 1, seed=2)
        tY, tp = torch.from_numpy(Y), params_from_numpy(jp)
        st = tsm.warm_init_smoothed_state(tY, tp)
        ref = jsm.warm_init_smoothed_state(jnp.asarray(Y), jp)
        for name in ("X_cov", "X_cross", "logdets"):
            np.testing.assert_allclose(getattr(st, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-6)
        assert torch.equal(st.X_mean[:, 0], st.X_mean[:, -1])  # broadcast
        model = TemporalAMEModel(n_nodes=8, n_time=4, latent_dim=1, seed=2,
                                 device="cpu")
        model.generate_data()
        from tame_torch import TemporalAMEStructuredMFVI

        vi = TemporalAMEStructuredMFVI(model, init_mode="warm",
                                       learning_rate=0.7)
        assert torch.equal(vi.X_cov[0, 0], 0.6 * torch.eye(4))
        # a mask that hides nothing gives the dense warm init (same probe)
        full = tcavi.warm_init_state(tY, tp, obs_mask=torch.ones(8, 8, 4))
        dense = tcavi.warm_init_state(tY, tp)
        torch.testing.assert_close(full.X_mean, dense.X_mean, rtol=0,
                                   atol=1e-5)


class TestStepsAndElbo:
    @pytest.mark.parametrize("corrected", [False, True])
    def test_jacobi_step_matches_jax(self, corrected):
        Y, jp, rng = _data(7, 5, 2, seed=3)
        jY, jp, jobs, jpri, tY, tp, tobs, tpri = _both(Y, jp)
        js = _random_state(rng, 7, 5, 6)
        ts = tsm.smoothed_state_from_numpy(js)
        ref = jsm.smoothed_step(js, jobs, jpri, jp, 0.7, corrected)
        got = tsm.smoothed_step(ts, tobs, tpri, tp, 0.7, corrected)
        _close_state(got, ref, TOL_STEP, TOL_STEP)

    @pytest.mark.parametrize("corrected", [False, True])
    def test_block_step_matches_jax(self, corrected):
        Y, jp, rng = _data(8, 4, 2, seed=4)
        jY, jp, jobs, jpri, tY, tp, tobs, tpri = _both(Y, jp)
        js = _solved_state(Y, jp, rng, 8, 4, 6)
        ts = tsm.smoothed_state_from_numpy(js)
        ref = jsm.smoothed_step_block(js, jobs, jpri, jp, 0.8, 4, corrected)
        got = tsm.smoothed_step_block(ts, tobs, tpri, tp, 0.8, 4, corrected)
        _close_state(got, ref, TOL_STEP, TOL_STEP)
        assert torch.equal(ts.X_mean, torch.from_numpy(
            np.asarray(js.X_mean)))  # the input state is not modified

    def test_elbo_and_prior_entropy_match_jax(self):
        Y, jp, rng = _data(8, 5, 2, seed=5)
        jY, jp, _, jpri, tY, tp, _, tpri = _both(Y, jp)
        js = _solved_state(Y, jp, rng, 8, 5, 6)
        ts = tsm.smoothed_state_from_numpy(js)
        np.testing.assert_allclose(
            tsm.smoothed_elbo(tY, tp, tpri, ts).item(),
            float(jsm.smoothed_elbo(jY, jp, jpri, js)), rtol=RTOL_ELBO)
        for got, ref in zip(tsm.smoothed_prior_entropy(tp, tpri, ts),
                            jsm.smoothed_prior_entropy(jp, jpri, js)):
            np.testing.assert_allclose(got.item(), float(ref),
                                       rtol=RTOL_ELBO)
        # T = 1: no transition term
        js1 = jsm.SmoothedState(js.X_mean[:, :1], js.X_cov[:, :1],
                                js.X_cross[:, :0], js.logdets)
        prior0, priort, _ = tsm.smoothed_prior_entropy(
            tp, tpri, tsm.smoothed_state_from_numpy(js1))
        assert priort.item() == 0.0
        np.testing.assert_allclose(
            prior0.item(),
            float(jsm.smoothed_prior_entropy(jp, jpri, js1)[0]),
            rtol=RTOL_ELBO)


class TestFitParity:
    @pytest.mark.parametrize("update_mode", ["jacobi", "block"])
    def test_ten_iterations_match_jax(self, update_mode):
        Y, jp, rng = _data(8, 5, 1, seed=6)
        js = _random_state(rng, 8, 5, 4)
        ts = tsm.smoothed_state_from_numpy(js)
        kw = dict(max_iter=10, learning_rate=0.8, tolerance=0.0,
                  update_mode=update_mode)
        jres = jsm.fit_cavi_smoothed(jnp.asarray(Y), jp, js, fused=False,
                                     **kw)
        tres = tsm.fit_cavi_smoothed(torch.from_numpy(Y),
                                     params_from_numpy(jp), ts, **kw)
        assert tres.n_iter == 10 and tres.elbo_history.shape == (64,)
        _assert_fits_agree(tres, jres, 64)
        _close_state(tres.state, jres.state, ATOL_FIXED)

    def test_fixed_point_matches_jax(self):
        """tame's kernel-vs-scan fixed-point check: n=6, T=4, r=1,
        lr 0.5, 256 iterations at tolerance 0, through the K4 twin."""
        from tame.models import TemporalAMEModel as JaxModel

        model = JaxModel(n_nodes=6, n_time=4, latent_dim=1, seed=3)
        Y, _ = model.generate_data(return_latents=True)
        js = jsm.init_smoothed_state(jax.random.PRNGKey(0), 6, 4, 4)
        kw = dict(max_iter=256, learning_rate=0.5, tolerance=0.0)
        jres = jsm.fit_cavi_smoothed(Y, model.params, js, fused=False, **kw)
        tres = tsm.fit_cavi_smoothed(
            torch.from_numpy(np.asarray(Y)), params_from_numpy(model.params),
            tsm.smoothed_state_from_numpy(js), fused=True, **kw)
        assert tres.n_iter == 256
        for name in ("X_mean", "X_cov"):
            np.testing.assert_allclose(
                getattr(tres.state, name).numpy(),
                np.asarray(getattr(jres.state, name)), rtol=0,
                atol=ATOL_FIXED)
        ej = float(np.asarray(jres.elbo_history)[255])
        assert abs(tres.elbo_history[255].item() - ej) / abs(ej) < 1e-4

    def test_warm_started_fit_stops_with_jax(self):
        """From the JAX warm init at tolerance 1e-4, on data drawn from the
        model: the same n_iter and converged flag."""
        from tame.models import TemporalAMEModel as JaxModel

        model = JaxModel(n_nodes=10, n_time=5, latent_dim=1, seed=1)
        Y, jp = np.array(model.generate_data()), model.params
        js = jsm.warm_init_smoothed_state(jnp.asarray(Y), jp)
        kw = dict(max_iter=100, tolerance=1e-4)
        jres = jsm.fit_cavi_smoothed(jnp.asarray(Y), jp, js, **kw)
        tres = tsm.fit_cavi_smoothed(torch.from_numpy(Y),
                                     params_from_numpy(jp),
                                     tsm.smoothed_state_from_numpy(js), **kw)
        assert tres.converged and tres.n_iter == 22
        _assert_fits_agree(tres, jres, 64)

    def test_segments_continue_exactly(self):
        Y, jp, rng = _data(6, 4, 1, seed=8)
        ts = tsm.smoothed_state_from_numpy(_random_state(rng, 6, 4, 4))
        tY, tp = torch.from_numpy(Y), params_from_numpy(jp)
        kw = dict(learning_rate=0.8, tolerance=1e-4)
        full = tsm.fit_cavi_smoothed(tY, tp, ts, max_iter=100, **kw)
        assert full.converged and full.n_iter > 5
        seg1 = tsm.fit_cavi_smoothed(tY, tp, ts, max_iter=5, **kw)
        seg2 = tsm.fit_cavi_smoothed(tY, tp, seg1.state, max_iter=95,
                                     carry_elbo=seg1.last_elbo,
                                     carry_patience=seg1.pat_count, **kw)
        assert seg1.n_iter + seg2.n_iter == full.n_iter and seg2.converged
        assert torch.equal(seg2.state.X_mean, full.state.X_mean)

    def test_divergence_halts_like_jax(self):
        """lr=3 over-relaxes the means until a pivot leaves the SPD cone:
        both packages halt on the same iteration, flagged."""
        Y, jp, rng = _data(8, 4, 1, seed=9)
        js = _random_state(rng, 8, 4, 4)
        kw = dict(max_iter=60, learning_rate=3.0, tolerance=0.0,
                  update_mode="jacobi")
        jres = jsm.fit_cavi_smoothed(jnp.asarray(Y), jp, js, **kw)
        tres = tsm.fit_cavi_smoothed(torch.from_numpy(Y),
                                     params_from_numpy(jp),
                                     tsm.smoothed_state_from_numpy(js), **kw)
        assert tres.diverged and bool(jres.diverged)
        assert tres.n_iter == int(jres.n_iter) < 60
        assert not tres.converged

    def test_options_and_unported_modes(self):
        Y, jp, rng = _data(4, 3, 1, seed=10)
        tY, tp = torch.from_numpy(Y), params_from_numpy(jp)
        ts = tsm.smoothed_state_from_numpy(_random_state(rng, 4, 3, 4))
        with pytest.raises(ValueError, match="mutually exclusive"):
            tsm.fit_cavi_smoothed(tY, tp, ts, fused=True,
                                  smoother="parallel")
        # ported with the time-parallel smoother: it runs
        res = tsm.fit_cavi_smoothed(tY, tp, ts, max_iter=2,
                                    smoother="parallel")
        assert np.isfinite(res.elbo_history[:2].numpy()).all()
        # ported in the production-flags slice: these run
        for kw in [dict(mixed_precision=True), dict(diag_mode="stats"),
                   dict(mask=torch.ones(4, 4, 3))]:
            res = tsm.fit_cavi_smoothed(tY, tp, ts, max_iter=2, **kw)
            assert np.isfinite(res.elbo_history[:2].numpy()).all()
        for kw in [dict(smoother="bogus"), dict(update_mode="seq"),
                   dict(diag_mode="bogus"), dict(fused="bogus")]:
            with pytest.raises(ValueError):
                tsm.fit_cavi_smoothed(tY, tp, ts, **kw)
        t50 = tsm.init_smoothed_state(torch.Generator().manual_seed(0), 4,
                                      3, 50)
        with pytest.raises(ValueError, match="unsupported"):
            tsm.fit_cavi_smoothed(tY, tp, t50, fused=True)  # no K4 past 48
        t1 = tsm.init_smoothed_state(torch.Generator().manual_seed(0), 4, 1,
                                     4)
        for fused in ("auto", True, False):  # every choice runs the twin
            res = tsm.fit_cavi_smoothed(tY[:, :, :1], tp, t1, max_iter=3,
                                        fused=fused)
            assert res.state.X_cross.shape == (4, 0, 4, 4)  # T = 1 runs
        before = tfs.fused_smoother_kernel.launches
        tsm.fit_cavi_smoothed(tY, tp, ts, max_iter=2, update_mode="block")
        assert tfs.fused_smoother_kernel.launches == before  # CPU: twin


class TestEngine:
    def test_smoothed_state_shapes(self):
        model = TemporalAMEModel(n_nodes=6, n_time=4, latent_dim=1, seed=1,
                                 device="cpu")
        model.generate_data()
        sm = TemporalAMESmoothedVI(model)
        h = sm.fit(max_iter=5, verbose=False)
        assert len(h["elbo"]) == 5
        assert sm.X_mean.shape == (6, 4, 4)
        assert sm.X_cov.shape == (6, 4, 4, 4)
        assert sm.X_cross.shape == (6, 3, 4, 4)
        assert (torch.linalg.eigvalsh(sm.X_cov) > 0).all()
        assert dict(sm.named_buffers()).keys() == {
            "X_mean", "X_cov", "X_cross", "logdets"}
        assert sm.get_variational_means() is sm.X_mean
        assert sm.predict_forward(3).shape == (6, 3, 4)
        torch.testing.assert_close(sm.predict_forward(1)[:, 0],
                                   sm.X_mean[:, -1] * 0.8)

    def test_smoothed_warm_init(self):
        """init_mode='warm' reaches at least as good a final ELBO as the
        random init under the same budget."""
        model = TemporalAMEModel(n_nodes=10, n_time=5, latent_dim=2, seed=1,
                                 device="cpu")
        model.generate_data()
        w = TemporalAMESmoothedVI(model, init_mode="warm")
        hw = w.fit(max_iter=60, tolerance=1e-6, verbose=False)
        rnd = TemporalAMESmoothedVI(model, init_mode="random")
        hr = rnd.fit(max_iter=60, tolerance=1e-6, verbose=False)
        assert hw["elbo"][-1] >= hr["elbo"][-1] - 1.0

    def test_fit_surface_and_unported_keywords(self, capsys):
        model = TemporalAMEModel(n_nodes=6, n_time=3, latent_dim=1, seed=4,
                                 device="cpu")
        model.generate_data()
        sm = TemporalAMESmoothedVI(model, learning_rate=0.8)
        sm.fit(max_iter=4, verbose=True, check_every=2)
        assert "Iter    3" in capsys.readouterr().out
        sm.fit(max_iter=2, verbose=False)
        assert len(sm.history["elbo"]) == 6
        for kw in [dict(mixed_precision=True), dict(diag_mode="stats"),
                   dict(mask=torch.ones(6, 6, 3))]:
            h = TemporalAMESmoothedVI(model, **kw).fit(max_iter=2,
                                                       verbose=False)
            assert np.isfinite(h["elbo"]).all()
        sm.fit(max_iter=2, verbose=False, checkpoint_every=1)
        assert len(sm.history["elbo"]) == 8
        with pytest.raises(ValueError, match="ckpt_dir"):
            sm.fit(max_iter=2, resume=True)
        with pytest.raises(ValueError):
            TemporalAMESmoothedVI(model, init_mode="bogus")
