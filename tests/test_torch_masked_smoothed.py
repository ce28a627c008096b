"""Port parity for missing-data smoothed fits, masked variational EM and
the masked exact ELBO: the same numpy ``Y``, mask, parameters and state go
through ``tame.inference.smoothed`` / ``em`` / ``evidence`` (JAX, CPU) and
their ``tame_torch`` counterparts.

Tolerances are those of ``test_torch_smoothed.py`` and
``test_torch_em.py``: one step 1e-5, ELBO terms 1e-6, a 10-iteration
horizon 1e-4 (a smoothed fit is chaotic before it converges), M-step
reductions 1e-5, three EM iterations 1e-3.
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
from tame.ops import masked_contract as jmc
from tame_torch import TemporalAMEModel, TemporalAMESmoothedVI, exact_elbo
from tame_torch import fit_em
from tame_torch.inference import cavi as tcavi
from tame_torch.inference import em as tem
from tame_torch.inference import smoothed as tsm
from tame_torch.models import params_from_numpy, random_dyad_mask
from tame_torch.ops import fused_smoother as tfs
from tame_torch.ops import masked_contract as tmc

torch.set_num_threads(1)

TOL_STEP = 1e-5
# A block sweep through K5's layout: later phases round means that earlier
# phases updated (f32 ulps apart in the two packages) to bf16, and a mean
# on a rounding boundary moves one partner sum by one bf16 step.
TOL_STEP_PACKED = 1e-3
RTOL_ELBO = 1e-6
RTOL_HIST = 1e-4
# bf16 weights with stats diagnostics, held to JAX's exact diagnostics on
# the same steps (the port carries the diagnostics' panels in two bf16
# halves, cavi._diag_contract; JAX's bf16 stats read 2.0e-3 of the ELBO
# and 2.6e-3 of the MSE from its exact ones here): the port's data-mean
# cross terms read the bf16 weights, where the exact residual pass reads
# the float32 network; measured 2.1e-4 of each history.
RTOL_HIST_BF16_STATS = 4e-4
RTOL = 1e-5
RTOL_EM = 1e-3


def _mask(rng, n, T, missing=0.3):
    keep = ((rng.random((n, n, T)) > missing)
            * np.triu(np.ones((n, n)), k=1)[:, :, None])
    return (keep + keep.transpose(1, 0, 2)).astype(np.float32)


def _model_data(n=10, T=5, r=1, seed=6):
    """Model data (truth phi 0.8, sigma^2 0.1, rho 0.5) and a mask."""
    model = JaxModel(n_nodes=n, n_time=T, latent_dim=r, seed=seed)
    Y = np.array(model.generate_data())
    return Y, _mask(np.random.default_rng(seed), n, T), model.params


def _random_state(rng, n, T, d):
    return jsm.SmoothedState(
        X_mean=jnp.asarray((0.1 * rng.standard_normal((n, T, d)))
                           .astype(np.float32)),
        X_cov=jnp.broadcast_to(0.5 * jnp.eye(d), (n, T, d, d)),
        X_cross=jnp.zeros((n, T - 1, d, d)),
        logdets=jnp.full((n,), -T * d * np.log(0.5), jnp.float32))


def _close_state(got, ref, atol, rtol=0.0):
    for name in tsm.SmoothedState._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=rtol,
                                   atol=atol, err_msg=name)


def _assert_fits_agree(tres, jres, n_check, hist_rtol=RTOL_HIST):
    assert tres.n_iter == int(jres.n_iter)
    assert tres.converged == bool(jres.converged)
    assert tres.diverged == bool(jres.diverged)
    for name in ("elbo_history", "mse_history"):
        t = getattr(tres, name).numpy()[:n_check]
        j = np.asarray(getattr(jres, name))[:n_check]
        assert np.isnan(t).tolist() == np.isnan(j).tolist()
        assert np.nanmax(np.abs(t - j) / np.abs(j)) < hist_rtol, name


class TestMaskedSmoothedSteps:
    @pytest.fixture(scope="class")
    def inputs(self):
        Y, mask, jp = _model_data(n=8, T=4, r=2, seed=3)
        Ym = Y * mask[..., None]
        jobs = jcavi.precompute_obs_constants(jnp.asarray(Ym), jp.R_inv)
        tp = params_from_numpy(jp)
        tobs = tcavi.precompute_obs_constants(torch.from_numpy(Ym), tp.R_inv)
        js = _random_state(np.random.default_rng(3), 8, 4, 6)
        return (Y, mask, jp, tp, jobs, tobs, jcavi.precompute_priors(jp),
                tcavi.precompute_priors(tp), js,
                tsm.smoothed_state_from_numpy(js))

    @pytest.mark.parametrize("corrected,packed", [(False, False),
                                                  (True, False),
                                                  (True, True)])
    def test_jacobi_step(self, inputs, corrected, packed):
        _, mask, jp, tp, jobs, tobs, jpri, tpri, js, ts = inputs
        jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
        if packed:  # one stripe: K5's twin / the interpret-mode kernel
            jm = jcavi.PackedMask(jmc.pack_mask(jm, 1))
            tm = tcavi.PackedMask(tmc.pack_mask(tm, 1))
        ref = jsm.smoothed_step(js, jobs, jpri, jp, 0.7, corrected, mask=jm)
        got = tsm.smoothed_step(ts, tobs, tpri, tp, 0.7, corrected, mask=tm)
        _close_state(got, ref, TOL_STEP, TOL_STEP)

    @pytest.mark.parametrize("packed", [False, True])
    def test_block_step(self, inputs, packed):
        """Block phases through dense mask rows, or through K5's layout
        (the twin here, the interpret-mode Pallas kernel there)."""
        _, mask, jp, tp, jobs, tobs, jpri, tpri, js, ts = inputs
        jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
        if packed:
            jm = jcavi.PackedMask(jmc.pack_mask(jm, 4))
            tm = tcavi.PackedMask(tmc.pack_mask(tm, 4))
        ref = jsm.smoothed_step_block(js, jobs, jpri, jp, 0.8, 4, True,
                                      mask=jm)
        got = tsm.smoothed_step_block(ts, tobs, tpri, tp, 0.8, 4, True,
                                      mask=tm)
        tol = TOL_STEP_PACKED if packed else TOL_STEP
        _close_state(got, ref, tol, TOL_STEP)
        with pytest.raises(ValueError, match="block count"):
            tsm.smoothed_step_block(
                ts, tobs, tpri, tp, 0.8, 2, True,
                mask=tcavi.PackedMask(tmc.pack_mask(torch.from_numpy(mask),
                                                    4)))

    def test_elbo_and_warm_init(self, inputs):
        Y, mask, jp, tp, jobs, tobs, jpri, tpri, js, ts = inputs
        Ynan = np.where(mask[..., None] > 0, Y, np.nan).astype(np.float32)
        solved = jsm.smoothed_step(js, jobs, jpri, jp, 0.7,
                                   mask=jnp.asarray(mask))
        ref = jsm.smoothed_elbo(jnp.asarray(Y), jp, jpri, solved,
                                obs_mask=jnp.asarray(mask))
        got = tsm.smoothed_elbo(torch.from_numpy(Ynan), tp, tpri,
                                tsm.smoothed_state_from_numpy(solved),
                                obs_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL_ELBO)
        wj = jsm.warm_init_smoothed_state(jnp.asarray(Y), jp,
                                          obs_mask=jnp.asarray(mask))
        wt = tsm.warm_init_smoothed_state(torch.from_numpy(Ynan), tp,
                                          obs_mask=torch.from_numpy(mask))
        # additive effects (the U/V frame depends on the probe)
        np.testing.assert_allclose(wt.X_mean[..., :2].numpy(),
                                   np.asarray(wj.X_mean[..., :2]), atol=1e-5)
        for name in ("X_cov", "X_cross", "logdets"):
            np.testing.assert_allclose(getattr(wt, name).numpy(),
                                       np.asarray(getattr(wj, name)),
                                       rtol=1e-6)


class TestMaskedSmoothedFits:
    @pytest.mark.parametrize("update_mode,diag_mode,mixed_precision", [
        ("jacobi", "exact", False), ("block", "exact", False),
        ("block", "stats", False), ("jacobi", "stats", True)])
    def test_ten_iterations_match_jax(self, update_mode, diag_mode,
                                      mixed_precision):
        Y, mask, jp = _model_data()
        js = _random_state(np.random.default_rng(1), 10, 5, 4)
        kw = dict(max_iter=10, learning_rate=0.8, tolerance=0.0,
                  update_mode=update_mode, num_blocks=5, diag_mode=diag_mode,
                  mixed_precision=mixed_precision)
        # bf16 panels with stats diagnostics: the port's diagnostics carry
        # their panels at ~16 bits (cavi._diag_contract), so its ELBO is
        # held to JAX's exact diagnostics on the same bf16 steps
        jkw = (dict(kw, diag_mode="exact")
               if mixed_precision and diag_mode == "stats" else kw)
        jres = jsm.fit_cavi_smoothed(jnp.asarray(Y), jp, js, fused=False,
                                     mask=jnp.asarray(mask), **jkw)
        tres = tsm.fit_cavi_smoothed(torch.from_numpy(Y),
                                     params_from_numpy(jp),
                                     tsm.smoothed_state_from_numpy(js),
                                     mask=torch.from_numpy(mask), **kw)
        _assert_fits_agree(tres, jres, 64, hist_rtol=(
            RTOL_HIST_BF16_STATS if jkw is not kw else RTOL_HIST))

    def test_warm_started_fit_stops_with_jax(self):
        Y, mask, jp = _model_data(seed=2)
        js = jsm.warm_init_smoothed_state(jnp.asarray(Y), jp,
                                          obs_mask=jnp.asarray(mask))
        kw = dict(max_iter=100, tolerance=1e-4)
        jres = jsm.fit_cavi_smoothed(jnp.asarray(Y), jp, js,
                                     mask=jnp.asarray(mask), **kw)
        tres = tsm.fit_cavi_smoothed(torch.from_numpy(Y),
                                     params_from_numpy(jp),
                                     tsm.smoothed_state_from_numpy(js),
                                     mask=torch.from_numpy(mask), **kw)
        assert tres.converged
        _assert_fits_agree(tres, jres, 64)

    def test_full_mask_matches_unmasked_and_hidden_never_read(self):
        Y, mask, jp = _model_data()
        tY, tp = torch.from_numpy(Y), params_from_numpy(jp)
        ts = tsm.smoothed_state_from_numpy(
            _random_state(np.random.default_rng(1), 10, 5, 4))
        kw = dict(max_iter=25, learning_rate=0.8, tolerance=0.0)
        a = tsm.fit_cavi_smoothed(tY, tp, ts, **kw)
        b = tsm.fit_cavi_smoothed(tY, tp, ts, mask=torch.ones(10, 10, 5),
                                  **kw)
        torch.testing.assert_close(b.state.X_mean, a.state.X_mean, rtol=0,
                                   atol=1e-4)
        ea, eb = a.elbo_history[:25], b.elbo_history[:25]
        assert ((ea - eb).abs() / ea.abs()).max() < 1e-4
        tm = torch.from_numpy(mask)
        c = tsm.fit_cavi_smoothed(tY, tp, ts, mask=tm, **kw)
        for fill in (1e6, float("nan")):
            d = tsm.fit_cavi_smoothed(
                torch.where(tm[..., None] == 0, fill, tY), tp, ts, mask=tm,
                **kw)
            assert torch.equal(c.state.X_mean, d.state.X_mean)

    def test_packed_block_mode_and_engine(self, monkeypatch):
        """TAME_PACKED_MASK=1 packs with the block count (the JAX
        regression test) and runs through the twins on the CPU; the
        engine takes the mask and both production flags."""
        Y, mask, jp = _model_data(n=12, T=4, r=2, seed=3)
        tY, tp, tm = (torch.from_numpy(Y), params_from_numpy(jp),
                      torch.from_numpy(mask))
        ts = tsm.init_smoothed_state(torch.Generator().manual_seed(1), 12,
                                     4, 6)
        monkeypatch.setenv("TAME_PACKED_MASK", "1")
        before = (tmc.packed_rows_contract_kernel.launches,
                  tfs.fused_smoother_kernel.launches)
        out = tsm.fit_cavi_smoothed(tY, tp, ts, max_iter=5, tolerance=0.0,
                                    mask=tm, update_mode="block",
                                    num_blocks=4, diag_mode="stats")
        assert np.isfinite(out.elbo_history[:5].numpy()).all()
        assert (tmc.packed_rows_contract_kernel.launches,
                tfs.fused_smoother_kernel.launches) == before
        model = TemporalAMEModel(n_nodes=10, n_time=5, latent_dim=1, seed=6,
                                 device="cpu")
        model.generate_data()
        gm = random_dyad_mask(torch.Generator().manual_seed(2), 10, 5, 0.25)
        vi = TemporalAMESmoothedVI(model, mask=gm, init_mode="warm",
                                   mixed_precision=True, diag_mode="stats")
        h = vi.fit(max_iter=30, tolerance=0.0, verbose=False)
        assert np.isfinite(h["elbo"]).all()
        assert h["reconstruction_error"][-1] < h["reconstruction_error"][0]


class TestMaskedEMAndEvidence:
    @pytest.fixture(scope="class")
    def problem(self):
        """Model data, a mask, a wrong starting guess and a solved masked
        smoothed state from it (10 JAX iterations)."""
        Y, mask, _ = _model_data(n=10, T=5, r=1, seed=3)
        p0 = jax_build_params(ModelConfig(n_nodes=10, n_time=5, latent_dim=1,
                                          ar_coefficient=0.3, rho_dyadic=0.0,
                                          dyadic_variance=1.0))
        init = jsm.warm_init_smoothed_state(jnp.asarray(Y), p0,
                                            obs_mask=jnp.asarray(mask))
        js = jsm.fit_cavi_smoothed(jnp.asarray(Y), p0, init, max_iter=10,
                                   tolerance=0.0,
                                   mask=jnp.asarray(mask)).state
        return Y, mask, p0, init, js

    def test_masked_residual_moments_and_corrections(self, problem):
        Y, mask, _, _, js = problem
        ts = tsm.smoothed_state_from_numpy(js)
        Ynan = np.where(mask[..., None] > 0, Y, np.nan).astype(np.float32)
        for got, ref in zip(
                tem._residual_moments(torch.from_numpy(Ynan), ts.X_mean,
                                      torch.from_numpy(mask)),
                jem._residual_moments(jnp.asarray(Y), js.X_mean,
                                      jnp.asarray(mask))):
            np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)
        for got, ref in zip(
                tem._residual_moment_corrections(ts, torch.from_numpy(mask)),
                jem._residual_moment_corrections(js, jnp.asarray(mask))):
            np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)
        # the off-diagonal mask through the general path equals the
        # O(n T k) shortcut
        off = torch.ones(10, 10, 5) * (1 - torch.eye(10))[:, :, None]
        for got, ref in zip(tem._residual_moment_corrections(ts, off),
                            tem._residual_moment_corrections(ts)):
            np.testing.assert_allclose(got.item(), ref.item(), rtol=RTOL)

    def test_masked_em_update_params(self, problem):
        Y, mask, p0, _, js = problem
        ref = jem.em_update_params(p0, jnp.asarray(Y), js,
                                   mask=jnp.asarray(mask))
        got = tem.em_update_params(params_from_numpy(p0), torch.from_numpy(Y),
                                   tsm.smoothed_state_from_numpy(js),
                                   mask=torch.from_numpy(mask))
        for name in ref._fields:
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=RTOL, atol=1e-6)

    def test_masked_fit_em_matches_jax(self, problem):
        Y, mask, p0, init, _ = problem
        Ynan = np.where(mask[..., None] > 0, Y, np.nan).astype(np.float32)
        kw = dict(n_em=3, inner_max_iter=30)
        ref = jem.fit_em(jnp.asarray(Y), p0, init=init,
                         mask=jnp.asarray(mask), **kw)
        got = fit_em(torch.from_numpy(Ynan), params_from_numpy(p0),
                     init=tsm.smoothed_state_from_numpy(init),
                     mask=torch.from_numpy(mask), **kw)
        assert got.history.keys() == ref.history.keys()
        assert len(got.history["elbo"]) == len(ref.history["elbo"]) == 3
        for key in ref.history:
            np.testing.assert_allclose(got.history[key], ref.history[key],
                                       rtol=RTOL_EM)
        assert (torch.linalg.eigvalsh(got.params.Q) > 0).all()
        assert (torch.linalg.eigvalsh(got.params.R) > 0).all()

    def test_masked_exact_elbo(self, problem):
        Y, mask, p0, _, js = problem
        tY, tp = torch.from_numpy(Y), params_from_numpy(p0)
        ts = tsm.smoothed_state_from_numpy(js)
        ref = jax_exact_elbo(jnp.asarray(Y), p0, js, mask=jnp.asarray(mask))
        np.testing.assert_allclose(
            exact_elbo(tY, tp, ts, mask=torch.from_numpy(mask)).item(),
            float(ref), rtol=RTOL)

    def test_nonzero_diagonal_mask_is_gated_first(self, problem):
        """A mask with ones on its diagonal: the port zeroes the diagonal
        before the plug-in statistics (ROADMAP C.2), so it equals JAX's
        bound on the diagonal-zeroed mask."""
        Y, mask, p0, _, js = problem
        diag = mask.copy()
        diag[np.arange(10), np.arange(10)] = 1.0
        ref = jax_exact_elbo(jnp.asarray(Y), p0, js, mask=jnp.asarray(mask))
        got = exact_elbo(torch.from_numpy(Y), params_from_numpy(p0),
                         tsm.smoothed_state_from_numpy(js),
                         mask=torch.from_numpy(diag))
        np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)
        # JAX's own result on the raw mask counts the diagonal as observed
        raw = jax_exact_elbo(jnp.asarray(Y), p0, js, mask=jnp.asarray(diag))
        assert abs(float(raw) - float(ref)) > 1e-3 * abs(float(ref))
