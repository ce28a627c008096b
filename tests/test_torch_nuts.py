"""Port parity for NUTS (``tame_torch.inference.nuts``): the bit helpers,
one transition fed the draws replayed from ``tame``'s key tree (same
depth, leapfrog count and flags, candidate within 1e-5), a batch of chains
against each chain run alone on its own draws, and sampling checks after
``tests/test_mcmc.py::TestNUTS``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tame.config
from tame.inference import logprob as jlp
from tame.inference import nuts as jnuts
from tame.models.params import build_params as jax_build_params
from tame_torch import TemporalAMEModel
from tame_torch.inference import TemporalAMENUTS, nuts_kernel, run_nuts
from tame_torch.inference import logprob as tlp
from tame_torch.inference import nuts as tnuts
from tame_torch.models import params_from_numpy

torch.set_num_threads(1)


def _target(n=6, T=3, r=1, seed=0):
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
    x0 = (0.5 * rng.standard_normal((3, n, T, d))).astype(np.float32)
    inv_mass = (0.05 + 0.1 * rng.random((n, T, d))).astype(np.float32)
    return (jlp.make_logdensity_fn(jp, jnp.asarray(Y)),
            tlp.make_logdensity_fn(params_from_numpy(jp),
                                   torch.from_numpy(Y)), x0, inv_mass)


def _replay(key, shape, max_depth):
    """The draws ``tame``'s ``nuts_kernel`` makes from ``key``, in the
    port's layout (every depth and leaf, used or not)."""
    k_mom, _, carry = jax.random.split(key, 3)
    noise = np.asarray(jax.random.normal(k_mom, shape))
    dirs, swaps, leaves = [], [], []
    for j in range(max_depth):
        carry, k_dir, k_sub, k_swap = jax.random.split(carry, 4)
        dirs.append(1.0 if bool(jax.random.bernoulli(k_dir)) else -1.0)
        swaps.append(float(jax.random.uniform(k_swap)))
        for _ in range(2 ** j):
            k_sub, k_acc = jax.random.split(k_sub)
            leaves.append(float(jax.random.uniform(k_acc)))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))[None]

    return tnuts.NUTSDraws(noise=t(noise), direction=t(dirs), swap=t(swaps),
                           leaf=t(leaves))


def test_bit_helpers_match_tame():
    x = np.arange(0, 2 ** 16 + 1, dtype=np.int32)
    np.testing.assert_array_equal(
        tnuts._popcount(torch.from_numpy(x)).numpy(),
        np.asarray(jnuts._popcount(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tnuts._trailing_zeros(torch.from_numpy(x[1:])).numpy(),
        np.asarray(jnuts._trailing_zeros(jnp.asarray(x[1:]))))
    assert [tnuts._bits(k) for k in range(64)] == \
        np.asarray(jnuts._popcount(jnp.arange(64))).tolist()


@pytest.mark.parametrize("seed,step,max_depth", [
    (0, 0.05, 6), (1, 0.2, 6), (2, 0.02, 7), (3, 0.5, 5), (4, 0.1, 4)])
def test_one_transition_fed_tames_draws(seed, step, max_depth):
    """The same depth, leapfrog count, flags and accept statistic, the
    candidate within 1e-5; and the host read back at most once per
    leapfrog step."""
    jfn, tfn, x0, inv_mass = _target()
    key = jax.random.PRNGKey(seed)
    jz, jl, js = jnuts.nuts_kernel(jfn, jnp.asarray(x0[0]), key,
                                   jnp.asarray(step), jnp.asarray(inv_mass),
                                   max_depth=max_depth)
    tz, tl, ts = tnuts.nuts_transition(
        tfn, torch.from_numpy(x0[:1]), _replay(key, x0[0].shape, max_depth),
        torch.tensor([step]), torch.from_numpy(inv_mass), max_depth)
    assert int(ts["depth"][0]) == int(js["depth"])
    assert int(ts["n_leapfrog"][0]) == int(js["n_leapfrog"])
    assert bool(ts["diverging"][0]) == bool(js["diverging"])
    assert float(ts["accept_prob"][0]) == pytest.approx(
        float(js["accept_prob"]), rel=1e-4, abs=1e-5)
    np.testing.assert_allclose(tz[0].numpy(), np.asarray(jz), rtol=0,
                               atol=1e-5)
    assert float(tl[0]) == pytest.approx(float(jl), rel=1e-5)
    assert ts["syncs"] <= max(int(ts["n_leapfrog"][0]), 1)


def test_batch_equals_each_chain_alone():
    """Three chains with different step sizes (so they stop at different
    depths) in one batch, and each chain run alone on its slice of the
    same draws: the same transitions."""
    _, tfn, x0, inv_mass = _target(seed=1)
    gen = torch.Generator().manual_seed(3)
    pos = torch.from_numpy(x0)
    draws = tnuts.nuts_draws(gen, pos, 6)
    steps = torch.tensor([0.02, 0.1, 0.4])
    bz, bl, bs = tnuts.nuts_transition(tfn, pos, draws, steps,
                                       torch.from_numpy(inv_mass), 6)
    assert len(set(bs["n_leapfrog"].tolist())) > 1
    for c in range(3):
        one = tnuts.NUTSDraws(*(d[c:c + 1] for d in draws))
        z, lp, s = tnuts.nuts_transition(tfn, pos[c:c + 1], one,
                                         steps[c:c + 1],
                                         torch.from_numpy(inv_mass), 6)
        for name in ("depth", "n_leapfrog", "diverging"):
            assert bs[name][c] == s[name][0], name
        assert float(bs["accept_prob"][c]) == pytest.approx(
            float(s["accept_prob"][0]), rel=1e-5)
        torch.testing.assert_close(bz[c], z[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(bl[c], lp[0], rtol=1e-6, atol=0)


def test_standard_normal_moments():
    fn = lambda x: -0.5 * (x ** 2).sum(-1)  # noqa: E731
    out = run_nuts(fn, torch.zeros(2, 3), torch.Generator().manual_seed(0),
                   num_warmup=300, num_samples=600, initial_step_size=0.5,
                   max_depth=6)
    s = out.positions.reshape(-1, 3)
    assert s.mean(0).abs().max() < 0.25
    assert (s.std(0) - 1.0).abs().max() < 0.25


def test_correlated_normal():
    """Strong correlation, where a badly sized fixed-length HMC fails."""
    rho = 0.95
    P = torch.linalg.inv(torch.tensor([[1.0, rho], [rho, 1.0]]))
    fn = lambda x: -0.5 * ((x @ P) * x).sum(-1)  # noqa: E731
    out = run_nuts(fn, torch.zeros(2, 2), torch.Generator().manual_seed(1),
                   num_warmup=300, num_samples=800, initial_step_size=0.3,
                   max_depth=8)
    for s in out.positions:                         # per chain, (800, 2)
        emp = torch.corrcoef(s.T)[0, 1]
        assert abs(float(emp) - rho) < 0.12
        assert (s.std(0) - 1.0).abs().max() < 0.3


def test_adaptive_depth():
    """A small step integrates deeper than a large one."""
    fn = lambda x: -0.5 * (x ** 2).sum(-1)  # noqa: E731
    gen = torch.Generator().manual_seed(2)
    draws = tnuts.nuts_draws(gen, torch.ones(1, 2), 10)
    small = tnuts.nuts_transition(fn, torch.ones(1, 2), draws,
                                  torch.tensor([0.01]), torch.ones(2), 10)
    big = tnuts.nuts_transition(fn, torch.ones(1, 2), draws,
                                torch.tensor([1.0]), torch.ones(2), 10)
    assert int(small[2]["n_leapfrog"][0]) > int(big[2]["n_leapfrog"][0])


def test_engine_on_temporal_ame():
    model = TemporalAMEModel(n_nodes=6, n_time=3, latent_dim=1,
                             ar_coefficient=0.8, seed=7, device="cpu")
    model.generate_data()
    nuts = TemporalAMENUTS(model, num_chains=2, max_depth=5, seed=0)
    syncs, transitions = nuts_kernel.syncs, nuts_kernel.transitions
    out = nuts.sample(num_warmup=25, num_samples=25)
    assert nuts_kernel.transitions - transitions == 50
    assert nuts_kernel.syncs > syncs
    assert out.positions.shape == (2, 25, 6, 3, 4)
    assert out.step_size.shape == (2,)
    assert torch.isfinite(out.positions).all()
    assert float(out.accept_prob.mean()) > 0.4
    assert set(nuts.diagnostics()) >= {"max_rhat", "logdensity_rhat"}
    with pytest.raises(TypeError, match="mesh"):
        nuts.sample(num_warmup=1, num_samples=1, mesh=object())
