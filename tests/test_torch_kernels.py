"""The port's CUDA kernels against their plain PyTorch twins on the card.

Every test here carries the ``cuda`` marker and skips without a GPU (the
kernels have no CPU mode; the twins are held to the JAX package by the
other ``test_torch_*`` files).  The file imports no JAX, so it runs on a
GPU host without it:

    python -m pytest -o addopts="" --noconftest tests/test_torch_kernels.py -m cuda
"""

import pytest
import torch

from tame_torch.inference import cavi
from tame_torch.models import TemporalAMEModel
from tame_torch.ops import cholesky as tchol
from tame_torch.ops import fused_fit as tff

pytestmark = pytest.mark.cuda

# Kernel vs twin: the same f32 algorithm against cuSOLVER's blocked
# factorization (K1/K2) or against the unfused loop's reductions (K3).
RTOL = 1e-4
ATOL = 1e-5
STATE_ATOL = 1e-4


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
                                 (10, 6250), (12, 777)])
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
