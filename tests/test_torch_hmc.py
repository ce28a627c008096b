"""Port parity for HMC (``tame_torch.inference.hmc``): the integrator, the
dual-averaging recursion and one transition fed ``tame``'s own draws
against ``tame.inference.hmc`` (JAX, CPU), the CAVI preconditioner from
one init, standard-normal moments, the graphed log density (the eager
function on the CPU; the eager gradient on the card), and the engine class
surface.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tame.config
from tame.inference import cavi as jcavi
from tame.inference import hmc as jhmc
from tame.inference import logprob as jlp
from tame.models.params import build_params as jax_build_params
from tame_torch import TemporalAMEModel
from tame_torch.inference import TemporalAMEHMC, run_hmc
from tame_torch.inference import cavi as tcavi
from tame_torch.inference import hmc as thmc
from tame_torch.inference import logprob as tlp
from tame_torch.inference.cavi import state_from_numpy
from tame_torch.models import params_from_numpy, random_dyad_mask

torch.set_num_threads(1)

ATOL = 1e-5   # positions after a trajectory of autograd vs jax.grad steps


def _target(n=6, T=3, r=1, seed=0):
    """A tiny AME posterior in both packages: numpy data, JAX params,
    (jax_fn, port_fn) log densities, a start and a diagonal inverse mass."""
    rng = np.random.default_rng(seed)
    d = 2 + 2 * r
    X = 0.7 * rng.standard_normal((n, T, d))
    fwd = (X[:, None, :, 0] + X[None, :, :, 1]
           + np.einsum("itr,jtr->ijt", X[..., 2:2 + r], X[..., 2 + r:]))
    y = np.triu((fwd + 0.3 * rng.standard_normal((n, n, T)))
                .transpose(2, 0, 1), 1).transpose(1, 2, 0)
    y = y + y.transpose(1, 0, 2)
    Y = np.stack([y, y.transpose(1, 0, 2)], -1).astype(np.float32)
    jp = jax_build_params(tame.config.ModelConfig(n_nodes=n, n_time=T,
                                                  latent_dim=r))
    jfn = jlp.make_logdensity_fn(jp, jnp.asarray(Y))
    tfn = tlp.make_logdensity_fn(params_from_numpy(jp), torch.from_numpy(Y))
    x0 = (0.5 * rng.standard_normal((n, T, d))).astype(np.float32)
    inv_mass = (0.05 + 0.1 * rng.random((n, T, d))).astype(np.float32)
    return Y, jp, jfn, tfn, x0, inv_mass


def test_leapfrog_matches_tame():
    _, _, jfn, tfn, x0, inv_mass = _target()
    mom = np.random.default_rng(1).standard_normal(x0.shape).astype(
        np.float32)
    _, jg = jax.value_and_grad(jfn)(jnp.asarray(x0))
    ref = jhmc._leapfrog(jfn, jnp.asarray(x0), jnp.asarray(mom), jg,
                         jnp.asarray(0.05), jnp.asarray(inv_mass), 12)
    _, tg = thmc.value_and_grad(tfn, torch.from_numpy(x0)[None])
    got = thmc._leapfrog(tfn, torch.from_numpy(x0)[None],
                         torch.from_numpy(mom)[None], tg,
                         torch.tensor([0.05]), torch.from_numpy(inv_mass),
                         12)
    for j, t in zip(ref, got):
        j = np.asarray(j)
        np.testing.assert_allclose(t[0].numpy(), j, rtol=1e-5,
                                   atol=ATOL * max(np.abs(j).max(), 1.0))


def test_dual_averaging_matches_tame():
    """The same accept-probability sequence through both recursions: the
    step sizes agree at every update (per chain here, one chain there)."""
    aps = np.random.default_rng(2).random((40, 3)).astype(np.float32)
    for c in range(3):
        jda = jhmc._da_init(jnp.asarray(0.01 * (c + 1), jnp.float32))
        tda = thmc._da_init(torch.tensor([0.01, 0.02, 0.03]))
        for row in aps:
            jda = jhmc._da_update(jda, jnp.asarray(row[c]), target=0.8)
            tda = thmc._da_update(tda, torch.from_numpy(row), target=0.8)
            for name in ("log_eps", "log_eps_avg", "grad_avg"):
                assert float(getattr(tda, name)[c]) == pytest.approx(
                    float(getattr(jda, name)), rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("seed,step", [(0, 0.05), (1, 0.05), (2, 0.3),
                                       (3, 0.3)])
def test_one_transition_fed_tames_draws(seed, step):
    """``hmc_kernel`` given the momentum noise and the uniform that
    ``tame``'s key tree draws makes ``tame``'s transition: the same
    acceptance, the same new state."""
    _, _, jfn, tfn, x0, inv_mass = _target()
    key = jax.random.PRNGKey(seed)
    jl, jg = jax.value_and_grad(jfn)(jnp.asarray(x0))
    jstate, jacc = jhmc.hmc_kernel(
        jfn, jhmc.HMCState(jnp.asarray(x0), jl, jg), key, jnp.asarray(step),
        jnp.asarray(inv_mass), 8)
    k_mom, k_acc = jax.random.split(key)
    draws = thmc.HMCDraws(
        noise=torch.from_numpy(np.asarray(jax.random.normal(
            k_mom, x0.shape)))[None],
        uniform=torch.tensor([float(jax.random.uniform(k_acc))]))
    tl, tg = thmc.value_and_grad(tfn, torch.from_numpy(x0)[None])
    tstate, tacc = thmc.hmc_kernel(
        tfn, thmc.HMCState(torch.from_numpy(x0)[None], tl, tg), None,
        torch.tensor([step]), torch.from_numpy(inv_mass), 8, draws=draws)
    assert float(tacc[0]) == pytest.approx(float(jacc), rel=1e-4, abs=1e-5)
    np.testing.assert_allclose(tstate.position[0].numpy(),
                               np.asarray(jstate.position), rtol=0,
                               atol=ATOL)
    assert float(tstate.logdensity[0]) == pytest.approx(
        float(jstate.logdensity), rel=1e-5)


def test_precondition_from_cavi_matches_tame(monkeypatch):
    """The warm Jacobi fit from ``tame``'s own init (handed over as
    numpy): the chain start and the inverse mass within 1e-4."""
    Y, jp, *_ = _target(n=8, T=4, seed=3)
    ref_center, ref_mass = jhmc.precondition_from_cavi(jnp.asarray(Y), jp,
                                                       seed=0)
    jinit = jcavi.init_state(jax.random.PRNGKey(0), 8, 4, 4, "full", 0.1,
                             0.5)
    monkeypatch.setattr(tcavi, "init_state",
                        lambda *a, **k: state_from_numpy(jinit))
    center, mass = thmc.precondition_from_cavi(torch.from_numpy(Y),
                                               params_from_numpy(jp), seed=0)
    for got, ref in ((center, ref_center), (mass, ref_mass)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_graphed_log_density_on_the_cpu_is_the_eager_function():
    """On CPU tensors a ``GraphedLogDensity`` is its function, eager: the
    same values and gradients, and NUTS driven through it draws the same
    bits as NUTS on the bare function."""
    from tame_torch.inference import run_nuts

    _, _, _, tfn, x0, inv_mass = _target()
    graphed = thmc.GraphedLogDensity(tfn)
    x = torch.from_numpy(x0)[None].repeat(3, 1, 1, 1)
    assert torch.equal(graphed(x), tfn(x))
    for a, b in zip(thmc.value_and_grad(graphed, x),
                    thmc.value_and_grad(tfn, x)):
        assert torch.equal(a, b)
    assert graphed.graphs == {}
    runs = [run_nuts(fn, x, torch.Generator().manual_seed(3), num_warmup=3,
                     num_samples=3, max_depth=3,
                     inv_mass=torch.from_numpy(inv_mass))
            for fn in (graphed, tfn)]
    assert torch.equal(runs[0].positions, runs[1].positions)


@pytest.mark.cuda
def test_graphed_log_density_replays_the_eager_gradient():
    """On the card the captured graph gives the eager pass's values and
    gradients at every new input, within f32 reduction order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode; "
                    "the CPU path is the eager function, tested above)")
    Y, jp, _, _, x0, _ = _target(n=12, T=4, r=2)
    fn = tlp.make_logdensity_fn(params_from_numpy(jp, device="cuda"),
                                torch.from_numpy(Y).cuda())
    graphed = thmc.GraphedLogDensity(fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(3):
        x = torch.from_numpy(x0).cuda()[None] + 0.1 * torch.randn(
            (5,) + x0.shape, generator=gen, device="cuda")
        for a, b in zip(thmc.value_and_grad(graphed, x),
                        thmc.value_and_grad(fn, x)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert len(graphed.graphs) == 1


def test_standard_normal_moments():
    """Four chains on a 2-D standard normal, with ``tame``'s settings and
    bounds (``tests/test_mcmc.py::test_run_hmc_standard_normal``): every
    chain's mean within 0.25 of 0 and sd within 0.25 of 1."""
    out = run_hmc(lambda x: -0.5 * (x ** 2).sum(-1), torch.zeros(4, 2),
                  torch.Generator().manual_seed(0), num_warmup=200,
                  num_samples=500, num_leapfrog=8, initial_step_size=0.5)
    assert out.positions.shape == (4, 500, 2)
    assert out.step_size.shape == (4,)
    s = out.positions.flatten(1)                 # (chains, draws * 2)
    assert s.mean(1).abs().max() < 0.25
    assert (s.std(1) - 1.0).abs().max() < 0.25


class TestEngine:
    @pytest.fixture(scope="class")
    def model(self):
        m = TemporalAMEModel(n_nodes=6, n_time=3, latent_dim=1,
                             ar_coefficient=0.8, seed=7, device="cpu")
        m.generate_data()
        return m

    def test_sample_surface_and_diagnostics(self, model):
        hmc = TemporalAMEHMC(model, num_chains=2, num_leapfrog=6, seed=1)
        with pytest.raises(RuntimeError, match="sample"):
            hmc.diagnostics()
        out = hmc.sample(num_warmup=20, num_samples=20, thin=2)
        assert out.positions.shape == (2, 20, 6, 3, 4)
        assert out.logdensities.shape == out.accept_prob.shape == (2, 20)
        assert torch.isfinite(out.positions).all()
        assert 0.3 < float(out.accept_prob.mean()) <= 1.0
        diag = hmc.diagnostics()
        assert set(diag) >= {"max_rhat", "min_ess", "median_ess",
                             "logdensity_rhat"}
        assert hmc.diagnostics() is diag           # cached until sample()
        assert 0 < diag["min_ess"] <= 2 * 20
        with pytest.raises(TypeError, match="mesh"):
            hmc.sample(num_warmup=1, num_samples=1, mesh=object())
        assert TemporalAMEHMC(model, family="poisson").precondition is False
        one = TemporalAMEHMC(model, num_chains=1, num_leapfrog=2)
        one.sample(num_warmup=2, num_samples=2)
        with pytest.raises(RuntimeError, match="chain diagnostics need"):
            one.diagnostics()

    def test_masked_nan_coded_target_samples(self, model):
        """NaN-coded hidden dyads must not freeze the chains (a NaN log
        density would reject every proposal)."""
        n, T = model.n, model.T
        mask = random_dyad_mask(torch.Generator().manual_seed(4), n, T, 0.3)
        masked = TemporalAMEModel(n_nodes=6, n_time=3, latent_dim=1,
                                  ar_coefficient=0.8, seed=7, device="cpu")
        masked.Y = torch.where(mask[..., None] == 0, torch.tensor(np.nan),
                               model.Y)
        hmc = TemporalAMEHMC(masked, num_chains=2, num_leapfrog=5, seed=1,
                             mask=mask, precondition=False)
        out = hmc.sample(num_warmup=20, num_samples=20)
        assert torch.isfinite(out.logdensities).all()
        assert float(out.accept_prob.mean()) > 0.2

    def test_no_data_raises(self):
        with pytest.raises(ValueError, match="no data"):
            TemporalAMEHMC(TemporalAMEModel(n_nodes=4, n_time=2,
                                            latent_dim=1, device="cpu"))

