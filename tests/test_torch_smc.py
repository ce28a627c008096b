"""Port parity for tempered SMC (``tame_torch.inference.smc``): the ESS,
systematic resampling fed ``tame``'s uniform, the first adaptive stage
(bisection, reweighting, evidence increment) from ``tame``'s own
particles, and the sampler's surface after ``tests/test_mcmc.py``.

The evidence-above-the-exact-ELBO check (``tests/test_mcmc.py::
TestEvidence`` at n=16, T=4, r=1, 256 particles) takes ~50 s per run on
one CPU core in the port, more than this suite's budget; ``chip_smoke.py``
holds it on the card at the ``smc_bench`` shape.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tame.config
from tame.inference import smc as jsmc
from tame.models.params import build_params as jax_build_params
from tame.models.temporal_ame import sample_latents as jax_sample_latents
from tame.models.temporal_ame import sample_observations
from tame_torch import TemporalAMEModel
from tame_torch.inference import TemporalAMESMC, run_smc
from tame_torch.inference import smc as tsmc
from tame_torch.models import params_from_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    model = TemporalAMEModel(n_nodes=6, n_time=3, latent_dim=1,
                             ar_coefficient=0.8, seed=7, device="cpu")
    model.generate_data()
    return model


def test_ess():
    assert float(tsmc.effective_sample_size(torch.zeros(10))) == \
        pytest.approx(10.0)
    concentrated = torch.tensor([0.0] + [-100.0] * 9)
    assert float(tsmc.effective_sample_size(concentrated)) == \
        pytest.approx(1.0, abs=1e-3)
    lw = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    assert float(tsmc.effective_sample_size(torch.from_numpy(lw))) == \
        pytest.approx(float(jsmc.effective_sample_size(jnp.asarray(lw))),
                      rel=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_systematic_resample_fed_tames_uniform(seed):
    rng = np.random.default_rng(seed)
    lw = (3.0 * rng.standard_normal(64)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jsmc.systematic_resample(key, jnp.asarray(lw)))
    u = torch.tensor(float(jax.random.uniform(key)))
    got = tsmc.systematic_resample(None, torch.from_numpy(lw), u=u)
    np.testing.assert_array_equal(got.numpy(), ref)
    # uniform weights: every particle survives exactly once
    idx = tsmc.systematic_resample(torch.Generator().manual_seed(seed),
                                   torch.zeros(16))
    assert sorted(idx.tolist()) == list(range(16))
    # a last cumulative weight short of 1 never indexes past the end
    assert int(tsmc.systematic_resample(
        None, torch.tensor([0.0, -40.0]), u=torch.tensor(0.9999999)).max()) \
        <= 1


@pytest.mark.parametrize("schedule", ["adaptive", "linear"])
def test_first_stage_matches_tame(schedule):
    """``tame``'s particles (its key tree's prior draws) handed to the
    port as a zero-stage ``resume_from``: one stage with no moves gives
    ``tame``'s temperature (the 30-step bisection), ESS and evidence."""
    n, T, r, N = 8, 3, 1, 64
    cfg = tame.config.ModelConfig(n_nodes=n, n_time=T, latent_dim=r,
                                  seed=0)
    jp = jax_build_params(cfg)
    key = jax.random.PRNGKey(3)
    Xt = jax_sample_latents(jp, jax.random.PRNGKey(9), n, T)
    Y = sample_observations(jp, jax.random.PRNGKey(10), Xt)
    kw = dict(num_particles=N, num_stages=8, num_moves=0,
              schedule=schedule)
    ref = jsmc.run_smc(jp, Y, key, max_new_stages=1, **kw)
    k_init, _ = jax.random.split(key)
    parts = jax.vmap(lambda k: jax_sample_latents(jp, k, n, T))(
        jax.random.split(k_init, N))
    nan = torch.full((8,), math.nan)
    start = tsmc.SMCResult(
        particles=torch.from_numpy(np.asarray(parts)),
        log_weights=torch.zeros(N), ess_history=nan,
        accept_history=nan.clone(), log_evidence=torch.tensor(0.0),
        beta_history=nan.clone(), n_stages=0, n_resamples=0)
    got = run_smc(params_from_numpy(jp), torch.from_numpy(np.asarray(Y)),
                  torch.Generator().manual_seed(0), resume_from=start,
                  max_new_stages=1, **kw)
    assert got.n_stages == int(ref.n_stages) == 1
    for name in ("beta_history", "ess_history"):
        assert float(getattr(got, name)[0]) == pytest.approx(
            float(np.asarray(getattr(ref, name))[0]), rel=1e-5)
    assert float(got.log_evidence) == pytest.approx(
        float(ref.log_evidence), rel=1e-5)
    assert got.n_resamples == int(ref.n_resamples)


def test_smc_runs(tiny):
    smc = TemporalAMESMC(tiny, num_particles=64, num_stages=64, num_moves=2,
                         seed=0)
    result = smc.sample()
    assert result.particles.shape == (64, 6, 3, 4)
    assert torch.isfinite(result.particles).all()
    assert math.isfinite(float(result.log_evidence))
    ns = result.n_stages
    assert 0 < ns <= 64
    ess = result.ess_history[:ns]
    assert torch.all(ess >= 1.0) and torch.all(ess <= 64.0)
    betas = result.beta_history[:ns]
    assert float(betas[-1]) == pytest.approx(1.0)
    assert torch.all(torch.diff(betas) > 0)
    assert torch.isnan(result.beta_history[ns:]).all()
    assert float(torch.logsumexp(result.log_weights, 0)) == pytest.approx(
        0.0, abs=1e-5)
    pm = smc.posterior_mean(result)
    assert pm.shape == (6, 3, 4)


def test_segmented_resume(tiny):
    """Calls of at most 2 stages carried with ``resume_from`` reach beta
    = 1 with the stage count, temperature and evidence carried; a
    zero-stage resume changes nothing."""
    Y, p = tiny.Y, tiny.params
    kw = dict(num_particles=64, num_stages=64, num_moves=2)
    full = run_smc(p, Y, torch.Generator().manual_seed(5), **kw)
    gen = torch.Generator().manual_seed(50)
    res, seg, stages = None, 0, []
    while res is None or (float(res.beta_history[res.n_stages - 1]) < 1.0
                          and res.n_stages < 64):
        res = run_smc(p, Y, gen, resume_from=res, max_new_stages=2, **kw)
        stages.append(res.n_stages)
        seg += 1
    assert seg > 1
    assert all(0 < b - a <= 2 for a, b in zip([0] + stages, stages))
    assert float(res.beta_history[res.n_stages - 1]) == pytest.approx(1.0)
    assert torch.all(torch.diff(res.beta_history[:res.n_stages]) > 0)
    # the same estimator in distribution (its spread between seeds at this
    # toy size is ~100 nats, tame's measurement)
    assert abs(float(res.log_evidence) - float(full.log_evidence)) < 500.0
    noop = run_smc(p, Y, torch.Generator().manual_seed(99), resume_from=res,
                   max_new_stages=0, **kw)
    assert torch.equal(noop.particles, res.particles)
    assert float(noop.log_evidence) == float(res.log_evidence)
    assert noop.n_stages == res.n_stages
    assert noop.n_resamples == res.n_resamples
    torch.testing.assert_close(noop.beta_history, res.beta_history, rtol=0,
                               atol=0, equal_nan=True)
    seg_smc = TemporalAMESMC(tiny, num_particles=32, num_stages=64,
                             num_moves=1, seed=2).sample(stages_per_call=3)
    assert float(seg_smc.beta_history[seg_smc.n_stages - 1]) == 1.0


def test_partial_buffer_warns(tiny, capsys):
    smc = TemporalAMESMC(tiny, num_particles=32, num_stages=2, num_moves=1,
                         seed=0)
    result = smc.sample()
    out = capsys.readouterr().out
    beta = float(result.beta_history[result.n_stages - 1])
    assert beta < 1.0 and result.n_stages == 2     # this schedule needs more
    assert "PARTIAL" in out


def test_move_kernels_schedules_and_options(tiny):
    Y, p = tiny.Y, tiny.params
    for kw in (dict(move_kernel="rwm"), dict(schedule="linear",
                                             num_stages=6)):
        res = run_smc(p, Y, torch.Generator().manual_seed(1),
                      num_particles=32, num_moves=1, **{"num_stages": 64,
                                                         **kw})
        assert float(res.beta_history[res.n_stages - 1]) == \
            pytest.approx(1.0)
        acc = res.accept_history[:res.n_stages]
        assert torch.all((acc >= 0) & (acc <= 1))
    lin = run_smc(p, Y, torch.Generator().manual_seed(1), num_particles=16,
                  num_moves=0, num_stages=4, schedule="linear")
    torch.testing.assert_close(lin.beta_history,
                               torch.tensor([0.25, 0.5, 0.75, 1.0]))
    for bad in (dict(move_kernel="mala"), dict(schedule="geometric")):
        with pytest.raises(ValueError):
            run_smc(p, Y, torch.Generator(), **bad)
    mask = torch.ones(6, 6, 3)
    res = TemporalAMESMC(tiny, num_particles=16, num_stages=64, num_moves=1,
                         mask=mask, precondition=False).sample()
    assert torch.isfinite(res.log_evidence)
    assert TemporalAMESMC(tiny, family="poisson").precondition is False
    with pytest.raises(TypeError, match="mesh"):
        TemporalAMESMC(tiny).sample(mesh=object())
