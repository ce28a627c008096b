"""The port's CUDA kernels against their plain PyTorch twins on the card.

Every test here carries the ``cuda`` marker and skips without a GPU (the
kernels have no CPU mode; the twins are held to the JAX package by the
other ``test_torch_*`` files).  The file imports no JAX, so it runs on a
GPU host without it:

    python -m pytest -o addopts="" --noconftest tests/test_torch_kernels.py -m cuda
"""

import pytest
import torch

from tame_torch.config import ModelConfig
from tame_torch.inference import cavi
from tame_torch.inference import smoothed
from tame_torch.models import (TemporalAMEModel, build_params,
                               random_dyad_mask)
from tame_torch.ops import cholesky as tchol
from tame_torch.ops import dual_contract as tdc
from tame_torch.ops import eta_contract as tec
from tame_torch.ops import fused_fit as tff
from tame_torch.ops import fused_smoother as tfs
from tame_torch.ops import masked_contract as tmc

pytestmark = pytest.mark.cuda

# Kernel vs twin: the same f32 algorithm against cuSOLVER's blocked
# factorization (K1/K2) or against the unfused loop's reductions (K3).
RTOL = 1e-4
ATOL = 1e-5
STATE_ATOL = 1e-4
# K4 vs twin: mean/cov/cross within 1e-4 of max|twin| (f32 operation
# order); logdet, a sum of T d logs each exact to f32 rounding, 1e-5.
SMOOTHER_REL = 1e-4
LOGDET_RTOL = 1e-5
# K5 / K6 vs twin: the same bf16-rounded products summed in float32 in
# another order (K6's column sums through atomics in a changing order).
CONTRACT_REL = 1e-4
# Packed-mask fit through K5 vs through its twin: the two sum in another
# order, so later phases round means an f32 ulp apart to bf16; a mean on a
# rounding boundary moves a partner sum by one bf16 step (~4e-3 of it).
PACKED_FIT_RTOL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode; their twins are tested on the CPU)")
    return torch.device("cuda")


def _spd(B, d, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn(B, d, d, device=device, generator=g)
    P = A @ A.transpose(-1, -2) / d + torch.eye(d, device=device)
    return P, torch.randn(B, d, device=device, generator=g)


@pytest.mark.parametrize("d,B", [(4, 1001), (6, 1001), (8, 130),
                                 (10, 6250), (12, 777), (14, 6250),
                                 (16, 777), (48, 33)])
def test_spd_kernels_match_twins(cuda_device, d, B):
    P, eta = _spd(B, d, cuda_device, d)
    mu, cov = tchol.spd_solve_inv_kernel(P, eta)
    mu_only = tchol.spd_solve_inv_kernel(P, eta, with_inverse=False)
    ld = tchol.logdet_spd_kernel(P)
    torch.cuda.synchronize()
    mu_t, cov_t = tchol.spd_solve_inv_twin(P, eta)
    torch.testing.assert_close(mu, mu_t, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(cov, cov_t, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(mu_only, mu, rtol=0, atol=0)
    torch.testing.assert_close(ld, tchol.logdet_spd_twin(P), rtol=RTOL,
                               atol=ATOL)


def test_public_entry_points_launch_the_kernels(cuda_device):
    P, eta = _spd(24, 6, cuda_device, 0)
    before = (tchol.spd_solve_inv_kernel.launches,
              tchol.logdet_spd_kernel.launches)
    mu, cov = tchol.batched_spd_solve_inv(P.reshape(4, 6, 6, 6),
                                          eta.reshape(4, 6, 6))
    tchol.batched_logdet_spd(P)
    assert mu.shape == (4, 6, 6) and cov.shape == (4, 6, 6, 6)
    assert (tchol.spd_solve_inv_kernel.launches,
            tchol.logdet_spd_kernel.launches) == (before[0] + 1,
                                                   before[1] + 1)
    with pytest.raises(ValueError, match="built for d in"):
        tchol.batched_logdet_spd(torch.eye(5, device=cuda_device)[None])


def test_fused_smem_formula_matches_kernel(cuda_device):
    from tame_torch.ops import _ext

    ext = _ext.load()
    for shape in [(15, 10, 6, 15), (100, 10, 6, 10), (8, 4, 12, 1)]:
        assert ext.fused_fit_smem_bytes(*shape) == \
            tff.fused_fit_smem_bytes(*shape)


@pytest.mark.parametrize("structure,corrected,num_blocks", [
    ("full", False, 4), ("full", True, 12), ("diag", False, 1),
    ("block", False, 3)])
def test_fused_fit_matches_twin(cuda_device, structure, corrected,
                                num_blocks):
    model = TemporalAMEModel(n_nodes=12, n_time=5, latent_dim=2, seed=7)
    Y = model.generate_data(device=cuda_device)
    p = model.params.to(cuda_device)
    init = cavi.init_state(torch.Generator().manual_seed(1), 12, 5, 6,
                           structure, 0.1, 0.5, device=cuda_device)
    args = (Y, p.R_inv, p.Sigma0, p.Q, p.Phi, init.X_mean, init.X_cov, 20,
            0.7, 0.0)
    kw = dict(r=2, buf_size=64, structure=structure, corrected=corrected,
              num_blocks=num_blocks)
    k = tff.fused_fit_kernel(*args, **kw)
    t = tff.fused_fit_twin(*args, **kw)
    assert (k.n_iter, k.converged, k.diverged) == (t.n_iter, t.converged,
                                                   t.diverged)
    torch.testing.assert_close(k.elbo_history, t.elbo_history, rtol=RTOL,
                               atol=0, equal_nan=True)
    torch.testing.assert_close(k.X_mean, t.X_mean, rtol=0, atol=STATE_ATOL)
    torch.testing.assert_close(k.X_cov, t.X_cov, rtol=0, atol=STATE_ATOL)


def test_fused_fit_freezes_after_stop(cuda_device):
    model = TemporalAMEModel(n_nodes=8, n_time=4, latent_dim=2, seed=3)
    Y = model.generate_data(device=cuda_device)
    init = cavi.init_state(torch.Generator().manual_seed(2), 8, 4, 6,
                           "full", 0.1, 0.5, device=cuda_device)
    before = tff.fused_fit_kernel.launches
    res = cavi.fit_cavi(Y, model.params.to(cuda_device), init,
                        update_mode="block", num_blocks=4, max_iter=100,
                        learning_rate=0.7, tolerance=1e-3)
    assert tff.fused_fit_kernel.launches == before + 1  # "auto" chose K3
    assert res.converged and res.n_iter < 100
    assert torch.isnan(res.elbo_history[res.n_iter:]).all()
    assert torch.isfinite(res.elbo_history[:res.n_iter]).all()


def test_fused_fit_divergence_halts_like_twin(cuda_device):
    model = TemporalAMEModel(n_nodes=8, n_time=4, latent_dim=2, seed=3)
    Y = model.generate_data(device=cuda_device)
    p = model.params.to(cuda_device)
    init = cavi.init_state(torch.Generator().manual_seed(2), 8, 4, 6,
                           "full", 0.1, 0.5, device=cuda_device)
    args = (Y, p.R_inv, p.Sigma0, p.Q, p.Phi, init.X_mean, init.X_cov, 60,
            1.5, 0.0)
    k = tff.fused_fit_kernel(*args, r=2, buf_size=64)
    t = tff.fused_fit_twin(*args, r=2, buf_size=64)
    assert k.diverged and t.diverged and k.n_iter == t.n_iter
    assert not k.converged


def _smoother_system(n, T, d, device, seed):
    """The smoothed fit's systems: D_t = an SPD observation precision
    (A A'/d + I) + the prior precision, O = -(Q^-1 Phi)', b ~ N(0, 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    pri = cavi.precompute_priors(build_params(ModelConfig(
        n_nodes=n, n_time=T, latent_dim=(d - 2) // 2)).to(device))
    A = torch.randn(n, T, d, d, device=device, generator=g)
    D = (A @ A.transpose(-1, -2) / d + torch.eye(d, device=device)
         + cavi._prior_precision(pri, T)[None])
    return D, -pri.Qinv_Phi.T, torch.randn(n, T, d, device=device,
                                           generator=g)


@pytest.mark.parametrize("n,T,d", [(125, 50, 10), (2000, 50, 10),
                                   (3, 2, 4), (3, 1, 4), (125, 50, 14),
                                   (7, 5, 16), (3, 1, 14), (2, 3, 48)])
def test_fused_smoother_matches_twin(cuda_device, n, T, d):
    D, O, b = _smoother_system(n, T, d, cuda_device, d + T)
    k = tfs.fused_smoother_kernel(D, O, b)
    torch.cuda.synchronize()
    t = tfs.fused_smoother_twin(D, O, b)
    for name in ("mean", "cov", "cross_cov"):
        got, ref = getattr(k, name), getattr(t, name)
        assert got.shape == ref.shape
        if ref.numel():  # cross_cov is (n, 0, d, d) at T = 1
            assert (got - ref).abs().max() <= SMOOTHER_REL * ref.abs().max()
    torch.testing.assert_close(k.logdet, t.logdet, rtol=LOGDET_RTOL, atol=0)


def test_fused_smoother_envelope_and_smem_formula(cuda_device):
    from tame_torch.ops import _ext

    ext = _ext.load()
    for d in tchol.UNROLLED_DIMS + (14, 16, tchol.MAX_KERNEL_D):
        assert ext.fused_smoother_smem_bytes(d) == \
            tfs.fused_smoother_smem_bytes(d)
    assert ext.fused_smoother_smem_bytes(tchol.MAX_KERNEL_D + 2) == 0
    D, O, b = _smoother_system(4, 3, 6, cuda_device, 0)
    with pytest.raises(ValueError, match="built for d in"):
        tfs.fused_smoother(D[..., :5, :5], O[:5, :5], b[..., :5])


def test_smoothed_fit_runs_through_k4(cuda_device, monkeypatch):
    model = TemporalAMEModel(n_nodes=12, n_time=5, latent_dim=2, seed=3)
    Y = model.generate_data(device=cuda_device)
    p = model.params.to(cuda_device)
    init = smoothed.warm_init_smoothed_state(Y, p)
    kw = dict(max_iter=10, tolerance=0.0, update_mode="block", num_blocks=4)
    before = tfs.fused_smoother_kernel.launches
    res = smoothed.fit_cavi_smoothed(Y, p, init, **kw)
    assert tfs.fused_smoother_kernel.launches == before + 40  # one per block
    # the same fit on the card with every smooth through the twin
    monkeypatch.setattr(smoothed, "fused_smoother", tfs.fused_smoother_twin)
    ref = smoothed.fit_cavi_smoothed(Y, p, init, **kw)
    assert tfs.fused_smoother_kernel.launches == before + 40
    torch.testing.assert_close(res.elbo_history, ref.elbo_history,
                               rtol=RTOL, atol=0, equal_nan=True)


def test_smoothed_fit_outside_k4_envelope_raises(cuda_device):
    """d = 50 (r = 24) is past every K4 build (even d up to 48): on the
    card the fit raises, as K1-K3 do, instead of falling back to the
    twin."""
    model = TemporalAMEModel(n_nodes=6, n_time=3, latent_dim=24, seed=0)
    Y = model.generate_data(device=cuda_device)
    p = model.params.to(cuda_device)
    init = smoothed.init_smoothed_state(
        torch.Generator(device=cuda_device).manual_seed(0), 6, 3, 50)
    with pytest.raises(ValueError, match="built for d in"):
        smoothed.fit_cavi_smoothed(Y, p, init, max_iter=2)


@pytest.mark.parametrize("kind", ["good", "smoothed"])
def test_high_rank_fit_runs_through_runtime_d_kernels(cuda_device, kind,
                                                      monkeypatch):
    """An r = 6 (d = 14) fit on the card runs through the runtime-d
    K1/K2 (Good SMF; K3 keeps d <= 12) or K4 (smoothed) and matches the
    same fit on the card with every kernel call through its twin."""
    model = TemporalAMEModel(n_nodes=12, n_time=5, latent_dim=6, seed=3)
    Y = model.generate_data(device=cuda_device)
    p = model.params.to(cuda_device)
    kw = dict(max_iter=10, tolerance=0.0, update_mode="block", num_blocks=4)
    if kind == "good":
        init = cavi.init_state(torch.Generator().manual_seed(1), 12, 5, 14,
                               "full", 0.1, 0.5, device=cuda_device)

        def fit():
            return cavi.fit_cavi(Y, p, init, learning_rate=0.7, **kw)

        counters = (tchol.spd_solve_inv_kernel, tchol.logdet_spd_kernel,
                    tff.fused_fit_kernel)
        before = [c.launches for c in counters]
        res = fit()
        assert [c.launches - b for c, b in zip(counters, before)] == \
            [40, 10, 0]
        monkeypatch.setattr(tchol, "spd_solve_inv_kernel",
                            tchol.spd_solve_inv_twin)
        monkeypatch.setattr(tchol, "logdet_spd_kernel",
                            tchol.logdet_spd_twin)
    else:
        init = smoothed.warm_init_smoothed_state(Y, p)

        def fit():
            return smoothed.fit_cavi_smoothed(Y, p, init, **kw)

        before = tfs.fused_smoother_kernel.launches
        res = fit()
        assert tfs.fused_smoother_kernel.launches == before + 40
        monkeypatch.setattr(smoothed, "fused_smoother",
                            tfs.fused_smoother_twin)
    ref = fit()
    torch.testing.assert_close(res.elbo_history, ref.elbo_history,
                               rtol=RTOL, atol=0, equal_nan=True)


@pytest.mark.parametrize("T,N,R", [(50, 2000, 4), (3, 48, 4), (3, 37, 1),
                                   (3, 37, 16), (2, 40, 7), (1, 8200, 2)])
def test_eta_contract_matches_twin(cuda_device, T, N, R):
    g = torch.Generator(device=cuda_device).manual_seed(N + R)
    W = torch.randn(T, N, N, device=cuda_device, generator=g).to(
        torch.bfloat16)
    Z = torch.randn(T, N, R, device=cuda_device, generator=g)
    before = tec.eta_contract_kernel.launches
    got = tec.eta_contract(W, Z)
    assert tec.eta_contract_kernel.launches == before + 1
    assert _max_rel(got, tec.eta_contract_twin(W, Z)) <= CONTRACT_REL



def _max_rel(got, ref):
    assert got.shape == ref.shape
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("n,T,K,nb", [(20, 3, 5, 4), (2000, 50, 57, 16),
                                      (300, 7, 70, 1)])
def test_masked_contract_matches_twin(cuda_device, n, T, K, nb):
    g = torch.Generator(device=cuda_device).manual_seed(n + K)
    mask = (torch.rand(n, n, T, device=cuda_device, generator=g) > 0.3)
    mask = mask.float() * (1 - torch.eye(n, device=cuda_device))[:, :, None]
    Z = torch.randn(n, T, K, device=cuda_device, generator=g)
    pm = tmc.pack_mask(mask, nb)
    before = tmc.packed_rows_contract_kernel.launches
    for k in range(nb):
        got = tmc.packed_rows_contract(pm[k], Z)
        ref = tmc.packed_rows_contract_twin(pm[k], Z)
        assert _max_rel(got, ref) <= CONTRACT_REL
    assert tmc.packed_rows_contract_kernel.launches == before + nb


@pytest.mark.parametrize("T,n,m", [(3, 20, 4), (50, 2000, 8), (2, 37, 13)])
def test_dual_contract_matches_twin(cuda_device, T, n, m):
    g = torch.Generator(device=cuda_device).manual_seed(n + m)
    y0 = torch.randn(T, n, n, device=cuda_device, generator=g)
    Z = torch.randn(T, n, m, device=cuda_device, generator=g)
    Wp = tdc.pad_data(y0)
    before = tdc.dual_contract_kernel.launches
    row, col = tdc.dual_contract_padded(Wp, Z)
    assert tdc.dual_contract_kernel.launches == before + 1
    row_t, col_t = tdc.dual_contract_twin(Wp, Z)
    assert _max_rel(row, row_t) <= CONTRACT_REL
    assert _max_rel(col, col_t) <= CONTRACT_REL


def test_packed_masked_fit_runs_through_k5(cuda_device, monkeypatch):
    """A 10-iteration masked block fit with TAME_PACKED_MASK=1: one K5
    launch per block phase and per diagnostics stripe, and the same fit
    with every stripe through the twin agrees."""
    model = TemporalAMEModel(n_nodes=12, n_time=5, latent_dim=2, seed=3)
    Y = model.generate_data(device=cuda_device)
    p = model.params.to(cuda_device)
    mask = random_dyad_mask(
        torch.Generator(device=cuda_device).manual_seed(1), 12, 5, 0.3)
    init = cavi.init_state(torch.Generator().manual_seed(1), 12, 5, 6,
                           "full", 0.1, 0.5, device=cuda_device)
    kw = dict(update_mode="block", num_blocks=4, max_iter=10,
              learning_rate=0.7, tolerance=0.0, diag_mode="stats",
              mask=mask)
    monkeypatch.setenv("TAME_PACKED_MASK", "1")
    before = tmc.packed_rows_contract_kernel.launches
    res = cavi.fit_cavi(Y, p, init, **kw)
    # 4 phase stripes + 4 diagnostics stripes per iteration
    assert tmc.packed_rows_contract_kernel.launches == before + 80
    monkeypatch.setattr(tmc, "packed_rows_contract",
                        tmc.packed_rows_contract_twin)
    ref = cavi.fit_cavi(Y, p, init, **kw)
    assert tmc.packed_rows_contract_kernel.launches == before + 80
    torch.testing.assert_close(res.elbo_history, ref.elbo_history,
                               rtol=PACKED_FIT_RTOL, atol=0, equal_nan=True)
