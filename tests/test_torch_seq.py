"""Port parity for the seq sweep (``update_mode="seq"``, the reference's
node-by-node order): the same numpy ``Y``, parameters and initial state go
through ``tame.inference.cavi.fit_cavi`` (JAX, CPU) and
``tame_torch.inference.cavi.fit_cavi`` (the K1 twin on the CPU); the ELBO
histories, stop iterations and dyadic means must agree.
"""

import numpy as np
import pytest
import torch

from tame.inference import cavi as jcavi
from tame.models import TemporalAMEModel as JaxTemporalAMEModel
from tame.ops import dyad as jdyad
from tame_torch import (
    TemporalAMEModel,
    TemporalAMENaiveMFVI,
    TemporalAMEStructuredMFVI,
)
from tame_torch.inference import cavi as tcavi
from tame_torch.models import params_from_numpy
from tame_torch.ops import dyad as tdyad
from tame_torch.ops import fused_fit as tff
from test_torch_cavi import _both, _problem

torch.set_num_threads(1)

# Whole fits: f32 reductions in another order compound over iterations.
RTOL_HIST = 1e-4
ATOL_MEAN = 1e-4


def _fit_both(structure, max_iter=30, tolerance=1e-4, lr=0.7, seed=0):
    Y, jp, Xm, Xc = _problem(n=8, T=4, r=2, structure=structure, seed=seed)
    jY, jp, js, tY, tp, ts = _both(Y, jp, Xm, Xc)
    kw = dict(structure=structure, update_mode="seq", max_iter=max_iter,
              learning_rate=lr, tolerance=tolerance)
    return (jcavi.fit_cavi(jY, jp, js, **kw),
            tcavi.fit_cavi(tY, tp, ts, **kw))


@pytest.mark.parametrize("structure", ["diag", "full", "block"])
def test_seq_fit_matches_jax(structure):
    jres, tres = _fit_both(structure)
    n = tres.n_iter
    assert n == int(jres.n_iter)
    assert tres.converged == bool(jres.converged)
    assert tres.diverged == bool(jres.diverged)
    eh_t = tres.elbo_history.numpy()[:n]
    eh_j = np.asarray(jres.elbo_history)[:n]
    assert np.all(np.isfinite(eh_t))
    assert np.max(np.abs(eh_t - eh_j) / np.abs(eh_j)) < RTOL_HIST
    assert np.isnan(tres.elbo_history.numpy()[n:]).all()
    mu_t = tdyad.dyadic_mean_temporal(tres.X_mean, 2).numpy()
    mu_j = np.asarray(jdyad.dyadic_mean_temporal(jres.X_mean, 2))
    np.testing.assert_allclose(mu_t, mu_j, rtol=0, atol=ATOL_MEAN)


def test_seq_stops_where_jax_stops():
    """A loose tolerance: both fits stop early, at the same iteration."""
    jres, tres = _fit_both("full", max_iter=100, tolerance=1e-3)
    assert tres.converged and tres.n_iter < 100
    assert tres.n_iter == int(jres.n_iter)
    assert tres.last_elbo == pytest.approx(float(jres.last_elbo),
                                           rel=RTOL_HIST)


def test_seq_sweep_reads_fresh_means():
    """One seq step equals a hand-written node-by-node, time-by-time loop
    of the closed-form update (the order the reference runs)."""
    Y, jp, Xm, Xc = _problem(n=5, T=3, r=1, structure="full", seed=3)
    _, _, _, tY, tp, ts = _both(Y, jp, Xm, Xc)
    obs = tcavi.precompute_obs_constants(tY, tp.R_inv)
    pri = tcavi.precompute_priors(tp)
    got = tcavi.cavi_step_seq(ts, obs, pri, tp, "full", 0.6)

    Xm_, Xc_ = ts.X_mean.clone(), ts.X_cov.clone()
    n, T, d = Xm_.shape
    for i in range(n):
        for t in range(T):
            # factor (i, t)'s closed-form update at the current state: node
            # i's observation terms read only the other nodes, the prior
            # coupling reads step t-1 as updated and step t+1 as not yet
            P = (tcavi._obs_precision(Xm_[..., 2:3], Xm_[..., 3:],
                                      tp.R_inv)[i, t]
                 + tcavi._prior_precision(pri, T)[t])
            eta = (tcavi._obs_nat_param(obs, Xm_, 1, tp.R_inv, False)[i, t]
                   + tcavi._prior_nat_param(pri, Xm_)[i, t])
            cov = torch.linalg.inv(P)
            cov = 0.5 * (cov + cov.T) + 1e-6 * torch.eye(d)
            Xm_[i, t] = 0.6 * (cov @ eta) + 0.4 * Xm_[i, t]
            Xc_[i, t] = 0.6 * cov + 0.4 * Xc_[i, t]
    np.testing.assert_allclose(got.X_mean.numpy(), Xm_.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.X_cov.numpy(), Xc_.numpy(), rtol=0,
                               atol=1e-5)


class TestRejections:
    def _inputs(self):
        Y, jp, Xm, Xc = _problem(n=6, T=3, r=1)
        _, _, _, tY, tp, ts = _both(Y, jp, Xm, Xc)
        return tY, tp, ts

    def test_corrected_rejected(self):
        tY, tp, ts = self._inputs()
        with pytest.raises(ValueError, match="corrected"):
            tcavi.fit_cavi(tY, tp, ts, update_mode="seq", corrected=True)

    def test_mixed_precision_rejected(self):
        tY, tp, ts = self._inputs()
        with pytest.raises(ValueError, match="mixed_precision"):
            tcavi.fit_cavi(tY, tp, ts, update_mode="seq",
                           mixed_precision=True)

    def test_mask_rejected(self):
        tY, tp, ts = self._inputs()
        with pytest.raises(ValueError, match="mask"):
            tcavi.fit_cavi(tY, tp, ts, update_mode="seq",
                           mask=torch.ones(6, 6, 3))

    def test_never_fused(self):
        """seq lies outside K3's envelope, as in JAX: "auto" never takes
        it and ``fused=True`` raises."""
        assert not tff.fused_fit_supported(15, 10, 6, structure="full",
                                           update_mode="seq",
                                           diag_mode="exact", elbo_every=1)
        tY, tp, ts = self._inputs()
        with pytest.raises(ValueError, match="fused=True"):
            tcavi.fit_cavi(tY, tp, ts, update_mode="seq", fused=True)

    def test_unknown_update_mode_rejected(self):
        tY, tp, ts = self._inputs()
        with pytest.raises(ValueError, match="update_mode"):
            tcavi.fit_cavi(tY, tp, ts, update_mode="sweep")


def _jacobi_and_seq(model):
    vj = TemporalAMEStructuredMFVI(model, factorization="good",
                                   learning_rate=0.7, update_mode="jacobi")
    vs = TemporalAMEStructuredMFVI(model, factorization="good",
                                   learning_rate=0.7, update_mode="seq")
    vj.fit(max_iter=300, tolerance=1e-9, verbose=False)
    vs.fit(max_iter=300, tolerance=1e-9, verbose=False)
    mse_j = model.compute_temporal_reconstruction_error(vj.X_mean)
    mse_s = model.compute_temporal_reconstruction_error(vs.X_mean)
    assert abs(mse_j - mse_s) / mse_s < 0.05
    return vj, vs


class TestJacobiVsSeq:
    """``tests/test_inference.py::TestJacobiVsSeq`` on the port: Jacobi
    (batched) and seq (reference order) reach the same fixed point on a
    well-damped problem."""

    def test_fixed_points_agree(self):
        """The JAX test's data (its model, seed 11) fed to the port: the
        same assertions, raw state means included."""
        jmodel = JaxTemporalAMEModel(n_nodes=8, n_time=4, latent_dim=1,
                                     seed=11)
        jmodel.generate_data()
        model = TemporalAMEModel(n_nodes=8, n_time=4, latent_dim=1, seed=11,
                                 device="cpu")
        model.Y = torch.tensor(np.asarray(jmodel.Y))
        model.params = params_from_numpy(jmodel.params)
        vj, vs = _jacobi_and_seq(model)
        assert np.allclose(vj.X_mean.numpy(), vs.X_mean.numpy(), atol=0.05)

    def test_identified_means_agree_on_port_data(self):
        """The port's own draw: the dyadic means (the identified quantity)
        agree; the raw latents may differ along the model's rotation."""
        model = TemporalAMEModel(n_nodes=8, n_time=4, latent_dim=1, seed=11,
                                 device="cpu")
        model.generate_data()
        vj, vs = _jacobi_and_seq(model)
        np.testing.assert_allclose(
            tdyad.dyadic_mean_temporal(vj.X_mean, 1).numpy(),
            tdyad.dyadic_mean_temporal(vs.X_mean, 1).numpy(), rtol=0,
            atol=0.05)


def test_seq_engine_demo_pattern():
    """The demo's qualitative pattern under the reference's sweep order:
    Naive and Good reach the same low MSE, Bad stays far worse."""
    model = TemporalAMEModel(n_nodes=10, n_time=5, latent_dim=2, seed=42,
                             device="cpu")
    model.generate_data()
    mse = {}
    for name, vi in [
            ("naive", TemporalAMENaiveMFVI(model, learning_rate=0.7,
                                           update_mode="seq")),
            ("good", TemporalAMEStructuredMFVI(model, learning_rate=0.7,
                                               update_mode="seq")),
            ("bad", TemporalAMEStructuredMFVI(model, factorization="bad",
                                              learning_rate=0.7,
                                              update_mode="seq"))]:
        h = vi.fit(max_iter=60, verbose=False)
        mse[name] = (h["reconstruction_error"][-1], vi._diverged)
    (naive, _), (good, _), (bad, bad_div) = (mse["naive"], mse["good"],
                                             mse["bad"])
    assert naive < 0.5 and good < 0.5 and abs(naive - good) < 0.05, mse
    assert bad_div or bad > 2.0 * good, mse
