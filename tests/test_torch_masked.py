"""Port parity for missing-data CAVI fits and the production flags (bf16
dyad weights, sufficient-statistics diagnostics): the same numpy ``Y``,
mask, parameters and initial state go through ``tame.inference.cavi``
(JAX, CPU; its Pallas mask kernel in interpret mode) and
``tame_torch.inference.cavi``.

Tolerances: assembly terms 1e-5 relative (float32 sums of <= n T terms in
another order); whole fits 1e-4 relative on the ELBO and MSE histories
with the same stop iteration (the bound of the dense fits in
``test_torch_cavi.py``).

bf16 fits and their whole-fit tolerance: rounding the feature panels to
bf16 makes one step a step function of the state.  The two packages'
steps from one state agree to ~5e-7, but where an entry of the state lies
that close to a bf16 rounding boundary the two round it apart, and the
fits then differ by about one bf16 step (~4e-3 in a mean) from there on:
the iteration does not damp it.  Of ten data seeds at the grid's setting
(n=16, T=5, r=1, 30 % missing), two kept all 16 cases within 1e-4; the
other eight each lost one to eight of the bf16 cases (to 4e-4 - 1e-2
relative), never an f32 one.  The grid runs on one of the two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tame.config
from tame.inference import cavi as jcavi
from tame.models.params import build_params as jax_build_params
from tame.ops import masked_contract as jmc
from tame_torch import TemporalAMEModel, TemporalAMEStructuredMFVI
from tame_torch.inference import cavi as tcavi
from tame_torch.models import params_from_numpy, random_dyad_mask
from tame_torch.ops import masked_contract as tmc

torch.set_num_threads(1)

RTOL_TERMS = 1e-5
RTOL_HIST = 1e-4
# bf16 weights with stats diagnostics, held to JAX's exact diagnostics on
# the same steps (the port carries the diagnostics' panels in two bf16
# halves, cavi._diag_contract; JAX's bf16 stats, with the panels in bf16,
# read 1.2e-3 - 2.6e-3 from its exact ones here and stop elsewhere): the
# port's data-mean cross terms read the bf16 weights, where the exact
# residual pass reads the float32 network, a fixed bf16 rounding of each
# weight; measured on these grids up to 3.9e-4 of the ELBO and 6.8e-4 of
# the MSE.  The stops and the means keep RTOL_HIST's cases' checks.
RTOL_HIST_BF16_STATS = {"elbo_history": 5e-4, "mse_history": 1e-3}
ATOL_STATE = 1e-4
# A mean one bf16 rounding step apart: ~4e-3 at O(1) (module docstring).
ATOL_STATE_BF16 = 1e-2


def _problem(n=10, T=4, r=2, seed=0, missing=0.3):
    """Numpy data in the reciprocal layout, a symmetric zero-diagonal
    numpy mask, JAX params and a numpy Good-SMF init."""
    rng = np.random.default_rng(seed)
    d = 2 + 2 * r
    X = 0.8 * rng.standard_normal((n, T, d))
    fwd = (X[:, None, :, 0] + X[None, :, :, 1]
           + np.einsum("itr,jtr->ijt", X[..., 2:2 + r], X[..., 2 + r:]))
    y = fwd + 0.3 * rng.standard_normal((n, n, T))
    y[np.arange(n), np.arange(n)] = 0.0
    Y = np.stack([y, y.transpose(1, 0, 2)], -1).astype(np.float32)
    keep = ((rng.random((n, n, T)) > missing)
            * np.triu(np.ones((n, n)), k=1)[:, :, None])
    mask = (keep + keep.transpose(1, 0, 2)).astype(np.float32)
    jp = jax_build_params(tame.config.ModelConfig(n_nodes=n, n_time=T,
                                                  latent_dim=r))
    X_mean = (0.1 * rng.standard_normal((n, T, d))).astype(np.float32)
    noise = 0.01 * rng.standard_normal((n, T, d, d))
    X_cov = (0.6 * np.eye(d) + 0.5 * (noise + noise.swapaxes(-1, -2))
             ).astype(np.float32)
    return Y, mask, jp, X_mean, X_cov


def _both(Y, mask, jp, X_mean, X_cov):
    js = jcavi.CaviState(X_mean=jnp.asarray(X_mean), X_cov=jnp.asarray(X_cov))
    return (jnp.asarray(Y), jnp.asarray(mask), jp, js,
            torch.from_numpy(Y), torch.from_numpy(mask),
            params_from_numpy(jp), tcavi.state_from_numpy(js))


def _close(got, ref, rtol=RTOL_TERMS, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _assert_fits_agree(tres, jres, n_check, state_atol=ATOL_STATE,
                       hist_rtol=None):
    assert tres.n_iter == int(jres.n_iter)
    assert tres.converged == bool(jres.converged)
    assert tres.diverged == bool(jres.diverged)
    for name in ("elbo_history", "mse_history"):
        t = getattr(tres, name).numpy()[:n_check]
        j = np.asarray(getattr(jres, name))[:n_check]
        assert np.isnan(t).tolist() == np.isnan(j).tolist()
        rtol = RTOL_HIST if hist_rtol is None else hist_rtol[name]
        assert np.nanmax(np.abs(t - j) / np.abs(j)) < rtol, name
    _close(tres.X_mean, jres.X_mean, rtol=0, atol=state_atol)


@pytest.fixture(scope="module")
def inputs():
    return _both(*_problem(n=9, T=4, seed=1))


class TestAssemblyTerms:
    def test_masked_panel_and_precision(self, inputs):
        _, jm, jp, js, _, tm, tp, ts = inputs
        jU, jV = js.X_mean[..., 2:4], js.X_mean[..., 4:]
        tU, tV = ts.X_mean[..., 2:4], ts.X_mean[..., 4:]
        _close(tcavi._masked_panel(tU, tV), jcavi._masked_panel(jU, jV))
        _close(tcavi._masked_obs_precision(tm, tU, tV, tp.R_inv),
               jcavi._masked_obs_precision(jm, jU, jV, jp.R_inv))
        # the same through K5's layout (the twin here, the interpret-mode
        # Pallas kernel there), one stripe per block of 3 rows
        tpm = tcavi.PackedMask(tmc.pack_mask(tm, 3))
        jpm = jcavi.PackedMask(jmc.pack_mask(jm, 3))
        _close(tcavi._masked_obs_precision(tpm, tU, tV, tp.R_inv),
               jcavi._masked_obs_precision(jpm, jU, jV, jp.R_inv))

    @pytest.mark.parametrize("corrected", [False, True])
    def test_obs_nat_param(self, inputs, corrected):
        jY, jm, jp, js, tY, tm, tp, ts = inputs
        jobs = jcavi.precompute_obs_constants(jY * jm[..., None], jp.R_inv)
        tobs = tcavi.precompute_obs_constants(tY * tm[..., None], tp.R_inv)
        _close(tcavi._obs_nat_param(tobs, ts.X_mean, 2, tp.R_inv, corrected,
                                    mask=tm),
               jcavi._obs_nat_param(jobs, js.X_mean, 2, jp.R_inv, corrected,
                                    mask=jm), atol=1e-5)

    @pytest.mark.parametrize("masked", [False, True])
    def test_residual_stats(self, inputs, masked):
        jY, jm, jp, js, tY, tm, tp, ts = inputs
        if masked:
            jY, tY = jY * jm[..., None], tY * tm[..., None]
        jobs = jcavi.precompute_obs_constants(jY, jp.R_inv)
        tobs = tcavi.precompute_obs_constants(tY, tp.R_inv)
        jdc = jcavi.precompute_diag_constants(jY)
        tdc = tcavi.precompute_diag_constants(tY)
        for name in jdc._fields:
            _close(getattr(tdc, name), getattr(jdc, name), atol=1e-5)
        if masked:
            got = tcavi._masked_residual_stats(tdc, tobs, ts.X_mean, 2,
                                               tp.R_inv, tm)
            ref = jcavi._masked_residual_stats(jdc, jobs, js.X_mean, 2,
                                               jp.R_inv, jm)
        else:
            got = tcavi._residual_stats_from_moments(tdc, tobs, ts.X_mean, 2,
                                                     tp.R_inv)
            ref = jcavi._residual_stats_from_moments(jdc, jobs, js.X_mean, 2,
                                                     jp.R_inv)
        for g, r in zip(got, ref):
            _close(g.item(), float(r))

    def test_bf16_eta_contract(self, inputs):
        jY, _, jp, js, tY, _, tp, ts = inputs
        jobs = jcavi.precompute_obs_constants(jY, jp.R_inv,
                                              w_dtype=jnp.bfloat16)
        tobs = tcavi.precompute_obs_constants(tY, tp.R_inv,
                                              w_dtype=torch.bfloat16)
        assert tobs.W0.dtype == torch.bfloat16
        assert tobs.eta_a.dtype == torch.float32  # sums before rounding
        _close(tobs.eta_a, jobs.eta_a, atol=1e-5)
        got = tcavi._eta_contract(tobs.W0, ts.X_mean[..., 4:])
        ref = jcavi._eta_contract(jobs.W0, js.X_mean[..., 4:])
        assert got.dtype == torch.float32
        _close(got, ref, atol=1e-6)

    def test_compute_elbo_with_obs_mask(self, inputs):
        jY, jm, jp, js, tY, tm, tp, ts = inputs
        ref = jcavi.compute_elbo(jY, jp, jcavi.precompute_priors(jp), js,
                                 "full", obs_mask=jm)
        got = tcavi.compute_elbo(tY, tp, tcavi.precompute_priors(tp), ts,
                                 "full", obs_mask=tm)
        _close(got.item(), float(ref))

    def test_warm_init_with_obs_mask(self):
        Y, mask, jp, _, _ = _problem(n=12, T=5, seed=2, missing=0.4)
        Ynan = np.where(mask[..., None] > 0, Y, np.nan).astype(np.float32)
        ref = jcavi.warm_init_state(jnp.asarray(Y), jp, structure="full",
                                    obs_mask=jnp.asarray(mask))
        # the JAX default probe handed to the port as numpy
        probe = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (12, 2),
                                             jnp.float32))
        got = tcavi.warm_init_state(torch.from_numpy(Ynan),
                                    params_from_numpy(jp), structure="full",
                                    probe=torch.from_numpy(probe),
                                    obs_mask=torch.from_numpy(mask))
        jm, tm = np.asarray(ref.X_mean), got.X_mean.numpy()
        assert np.isfinite(tm).all()  # NaN-coded hidden entries unread
        _close(tm[..., :2], jm[..., :2], rtol=0, atol=1e-5)
        # U V' (SVD/QR signs may differ between the two LAPACK calls)
        _close(np.einsum("itr,jtr->ijt", tm[..., 2:4], tm[..., 4:]),
               np.einsum("itr,jtr->ijt", jm[..., 2:4], jm[..., 4:]), rtol=0,
               atol=1e-4)


class TestFitParity:
    @pytest.fixture(scope="class")
    def grid_inputs(self):
        return _both(*_problem(n=16, T=5, r=1, seed=1, missing=0.3))

    @pytest.mark.parametrize("mixed_precision", [False, True])
    @pytest.mark.parametrize("diag_mode", ["exact", "stats"])
    @pytest.mark.parametrize("corrected", [False, True])
    @pytest.mark.parametrize("update_mode", ["jacobi", "block"])
    def test_masked_fit_matches_jax(self, grid_inputs, update_mode,
                                    corrected, diag_mode, mixed_precision):
        jY, jm, jp, js, tY, tm, tp, ts = grid_inputs
        kw = dict(structure="full", update_mode=update_mode, max_iter=60,
                  tolerance=1e-3, corrected=corrected, diag_mode=diag_mode,
                  mixed_precision=mixed_precision)
        if update_mode == "block":
            kw.update(num_blocks=4, learning_rate=0.8)
        else:
            kw.update(learning_rate=0.6)
        # bf16 panels with stats diagnostics: the port's diagnostics carry
        # their panels at ~16 bits (cavi._diag_contract), so its ELBO is
        # held to JAX's exact diagnostics on the same bf16 steps
        jkw = (dict(kw, diag_mode="exact")
               if mixed_precision and diag_mode == "stats" else kw)
        jres = jcavi.fit_cavi(jY, jp, js, mask=jm, **jkw)
        tres = tcavi.fit_cavi(tY, tp, ts, mask=tm, **kw)
        assert tres.converged
        _assert_fits_agree(tres, jres, 64, hist_rtol=(
            RTOL_HIST_BF16_STATS if jkw is not kw else None))

    # Two more bf16 paths, over a fixed short horizon (8 iterations,
    # tolerance 0) with exact diagnostics: on this data their fits to the
    # stop meet a rounding boundary (see the module docstring) and stop
    # 1-9 iterations apart, and with bf16 stats diagnostics the ELBO
    # meets one within 8 (its data-mean cross terms come from bf16-rounded
    # means, ~5e-4 relative apart after a flip).
    def test_dense_production_flags_match_jax(self, grid_inputs):
        jY, _, jp, js, tY, _, tp, ts = grid_inputs
        kw = dict(structure="full", update_mode="block", num_blocks=4,
                  max_iter=8, learning_rate=0.8, tolerance=0.0,
                  mixed_precision=True, fused=False)
        _assert_fits_agree(tcavi.fit_cavi(tY, tp, ts, **kw),
                           jcavi.fit_cavi(jY, jp, js, **kw), 8,
                           state_atol=ATOL_STATE_BF16)

    def test_packed_fit_matches_jax_packed_fit(self, grid_inputs,
                                               monkeypatch):
        """Both packages with TAME_PACKED_MASK=1: the port's K5 twin
        against the JAX kernel in interpret mode, inside a block fit."""
        jY, jm, jp, js, tY, tm, tp, ts = grid_inputs
        monkeypatch.setenv("TAME_PACKED_MASK", "1")
        kw = dict(structure="full", update_mode="block", num_blocks=4,
                  max_iter=8, learning_rate=0.8, tolerance=0.0,
                  corrected=True)
        _assert_fits_agree(tcavi.fit_cavi(tY, tp, ts, mask=tm, **kw),
                           jcavi.fit_cavi(jY, jp, js, mask=jm, **kw), 8,
                           state_atol=ATOL_STATE_BF16)


class TestMaskedInvariants:
    """The JAX package's masked-fit invariants, held by the port."""

    KW = dict(structure="full", max_iter=25, learning_rate=0.7,
              tolerance=0.0)

    @pytest.fixture(scope="class")
    def data(self):
        Y, mask, jp, Xm, Xc = _problem(n=12, T=5, seed=5, missing=0.35)
        return (torch.from_numpy(Y), torch.from_numpy(mask),
                params_from_numpy(jp),
                tcavi.CaviState(torch.from_numpy(Xm), torch.from_numpy(Xc)))

    @pytest.mark.parametrize("update_mode", ["jacobi", "block"])
    def test_full_mask_matches_unmasked(self, data, update_mode):
        Y, _, p, init = data
        full = torch.ones(12, 12, 5)  # the diagonal is zeroed by the fit
        kw = dict(self.KW, update_mode=update_mode, num_blocks=4)
        a = tcavi.fit_cavi(Y, p, init, fused=False, **kw)
        b = tcavi.fit_cavi(Y, p, init, mask=full, **kw)
        torch.testing.assert_close(b.X_mean, a.X_mean, rtol=0, atol=1e-4)
        ea, eb = a.elbo_history[:25], b.elbo_history[:25]
        assert ((ea - eb).abs() / ea.abs()).max() < 1e-4

    @pytest.mark.parametrize("diag_mode", ["exact", "stats"])
    def test_hidden_entries_never_read(self, data, diag_mode):
        """Garbage (1e6) or NaN in the hidden dyads changes no bit."""
        Y, mask, p, init = data
        kw = dict(self.KW, update_mode="jacobi", diag_mode=diag_mode,
                  mask=mask, corrected=True)
        a = tcavi.fit_cavi(Y, p, init, **kw)
        hidden = mask[..., None] == 0
        for fill in (1e6, float("nan")):
            b = tcavi.fit_cavi(torch.where(hidden, fill, Y), p, init, **kw)
            assert torch.equal(a.X_mean, b.X_mean)
            assert torch.equal(a.elbo_history[:25], b.elbo_history[:25])

    @pytest.mark.parametrize("update_mode", ["jacobi", "block"])
    def test_stats_equals_exact_under_mask(self, data, update_mode):
        Y, mask, p, init = data
        kw = dict(self.KW, update_mode=update_mode, num_blocks=4, mask=mask)
        a = tcavi.fit_cavi(Y, p, init, diag_mode="exact", **kw)
        b = tcavi.fit_cavi(Y, p, init, diag_mode="stats", **kw)
        for name in ("elbo_history", "mse_history"):
            ea, eb = getattr(a, name)[:25], getattr(b, name)[:25]
            assert ((ea - eb).abs() / ea.abs()).max() < 1e-4, name
        assert torch.equal(a.X_mean, b.X_mean)  # diagnostics feed nothing

    def test_bf16_stats_tracks_f32(self, data):
        Y, mask, p, init = data
        kw = dict(self.KW, update_mode="jacobi", mask=mask,
                  learning_rate=0.6, max_iter=40)
        a = tcavi.fit_cavi(Y, p, init, diag_mode="exact", **kw)
        b = tcavi.fit_cavi(Y, p, init, diag_mode="stats",
                           mixed_precision=True, **kw)
        ma, mb = a.mse_history[39].item(), b.mse_history[39].item()
        assert np.isfinite(mb) and abs(mb - ma) / ma < 0.05

    @pytest.mark.parametrize("update_mode", ["jacobi", "block"])
    def test_packed_equals_dense_within_bf16(self, data, update_mode,
                                             monkeypatch):
        """TAME_PACKED_MASK=1 sends every masked contraction through K5's
        layout (the twin on the CPU: no launch); the fit tracks the dense
        f32 mask path within bf16 panel rounding."""
        Y, mask, p, init = data
        kw = dict(self.KW, update_mode=update_mode, num_blocks=4, mask=mask,
                  corrected=True, diag_mode="stats", max_iter=15,
                  learning_rate=0.6)
        monkeypatch.setenv("TAME_PACKED_MASK", "0")
        a = tcavi.fit_cavi(Y, p, init, **kw)
        monkeypatch.setenv("TAME_PACKED_MASK", "1")
        before = tmc.packed_rows_contract_kernel.launches
        b = tcavi.fit_cavi(Y, p, init, **kw)
        assert tmc.packed_rows_contract_kernel.launches == before
        assert (a.X_mean - b.X_mean).abs().max() < 2e-2
        ea, eb = a.elbo_history[:15], b.elbo_history[:15]
        assert ((ea - eb).abs() / ea.abs()).max() < 1e-2


def test_masked_engine_on_the_cpu():
    """The public surface: a masked bf16 + stats fit of a model sampled on
    the CPU, with the warm init averaging over observed dyads."""
    model = TemporalAMEModel(n_nodes=12, n_time=5, latent_dim=2, seed=0,
                             device="cpu")
    model.generate_data()
    mask = random_dyad_mask(torch.Generator().manual_seed(2), 12, 5, 0.25)
    for init_mode in ("random", "warm"):
        mse = []
        for flags in (dict(), dict(mixed_precision=True, diag_mode="stats")):
            vi = TemporalAMEStructuredMFVI(model, learning_rate=0.7,
                                           mask=mask, init_mode=init_mode,
                                           **flags)
            h = vi.fit(max_iter=60, tolerance=0.0, verbose=False)
            assert len(h["elbo"]) == 60 and np.isfinite(h["elbo"]).all()
            m = h["reconstruction_error"]
            assert m[-1] < m[0]
            mse.append(m[-1])
        assert abs(mse[1] - mse[0]) / mse[0] < 0.05  # bf16 + stats vs f32
