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
from tame_torch.inference import graphed
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


# (d, B): every group width, the exact capacities and the padded ones (18
# in 24, 34 in 48), each B a ragged multiple of its systems per block
# (64 / 32 / 16 / 8 by d).
@pytest.mark.parametrize("d,B", [(4, 1001), (6, 1001), (8, 130),
                                 (10, 6250), (12, 777), (14, 6250),
                                 (16, 777), (18, 77), (34, 1003), (48, 33),
                                 (48, 1001)])
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


@pytest.mark.parametrize("d", [6, 14, 34, 48])
def test_spd_kernels_indefinite_system_is_nan_alone(cuda_device, d):
    P, eta = _spd(37, d, cuda_device, d + 1)
    P[5] = -P[5]                       # the first pivot fails
    P[20] = torch.eye(d, device=cuda_device)
    P[20, 2, 2] = -1.0                 # the third pivot fails
    mu, cov = tchol.spd_solve_inv_kernel(P, eta)
    mu_only = tchol.spd_solve_inv_kernel(P, eta, with_inverse=False)
    ld = tchol.logdet_spd_kernel(P)
    torch.cuda.synchronize()
    bad = torch.zeros(37, dtype=torch.bool, device=cuda_device)
    bad[[5, 20]] = True
    for x in (mu, cov, mu_only, ld):
        assert torch.isnan(x[bad]).all() and torch.isfinite(x[~bad]).all()
    mu_t, cov_t = tchol.spd_solve_inv_twin(P, eta)
    torch.testing.assert_close(mu[~bad], mu_t[~bad], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(cov[~bad], cov_t[~bad], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ld[~bad], tchol.logdet_spd_twin(P)[~bad],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [4, 10, 14, 48])
def test_spd_kernels_read_only_the_lower_triangle(cuda_device, d):
    P, eta = _spd(65, d, cuda_device, d + 2)
    upper = torch.triu(torch.ones(d, d, dtype=torch.bool,
                                  device=cuda_device), 1)
    Pg = P.clone()
    Pg[:, upper] = float("nan")
    mu, cov = tchol.spd_solve_inv_kernel(Pg, eta)
    ld = tchol.logdet_spd_kernel(Pg)
    torch.cuda.synchronize()
    mu_t, cov_t = tchol.spd_solve_inv_twin(P, eta)
    torch.testing.assert_close(mu, mu_t, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(cov, cov_t, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ld, tchol.logdet_spd_twin(P), rtol=RTOL,
                               atol=ATOL)


def test_spd_kernels_empty_and_strided_batches(cuda_device):
    for d in (10, 48):
        P, eta = _spd(0, d, cuda_device, 0)
        mu, cov = tchol.spd_solve_inv_kernel(P, eta)
        assert mu.shape == (0, d) and cov.shape == (0, d, d)
        assert tchol.logdet_spd_kernel(P).shape == (0,)
    # a non-contiguous P (every other system of a batch) and a view that
    # starts off a 16-byte boundary
    P, eta = _spd(402, 14, cuda_device, 3)
    Ps, es = P[::2], eta[::2]
    assert not Ps.is_contiguous()
    base = torch.empty(1 + P.numel(), device=cuda_device)
    base[1:] = P.reshape(-1)
    Pm = base[1:].view_as(P)
    assert Pm.data_ptr() % 16 != 0
    for Pb, eb in [(Ps, es), (Pm, eta)]:
        mu, cov = tchol.spd_solve_inv_kernel(Pb, eb)
        ld = tchol.logdet_spd_kernel(Pb)
        torch.cuda.synchronize()
        mu_t, cov_t = tchol.spd_solve_inv_twin(Pb.contiguous(), eb)
        torch.testing.assert_close(mu, mu_t, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(cov, cov_t, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(ld, tchol.logdet_spd_twin(Pb.contiguous()),
                                   rtol=RTOL, atol=ATOL)


def test_spd_geometry_matches_kernel(cuda_device):
    from tame_torch.ops import _ext

    ext = _ext.load()
    for d in range(0, tchol.MAX_KERNEL_D + 4):
        for narrow in (False, True):
            assert tuple(ext.spd_geometry(d, narrow)) == \
                tchol.spd_geometry(d, narrow), (d, narrow)


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
    for shape in [(15, 10, 6, 15), (15, 10, 6, 1), (100, 10, 6, 10),
                  (8, 4, 12, 1), (13, 7, 10, 1), (2897, 1, 4, 2897),
                  (2000, 50, 10, 16), (15, 10, 6, 4)]:
        layout = tff.fused_fit_layout(*shape)
        want = (tff.fused_fit_smem_bytes(*shape, layout) if layout >= 0
                else 0)
        assert tuple(ext.fused_fit_layout(*shape)) == (layout, want), shape


def _k3_fit(device, n, T, d, structure, seed, max_iter=20):
    """(positional args, keywords) of a K3 fit on the card."""
    model = TemporalAMEModel(n_nodes=n, n_time=T, latent_dim=(d - 2) // 2,
                             seed=seed)
    Y = model.generate_data(device=device)
    p = model.params.to(device)
    init = cavi.init_state(torch.Generator().manual_seed(seed), n, T, d,
                           structure, 0.1, 0.5, device=device)
    return (Y, p.R_inv, p.Sigma0, p.Q, p.Phi, init.X_mean, init.X_cov,
            max_iter, 0.7, 0.0), dict(r=(d - 2) // 2, buf_size=64,
                                      structure=structure)


# every d x {Jacobi, 4 blocks} x structure x corrected at n=12, T=5; a
# ragged Jacobi n, 5 blocks of 3 nodes, and the n=100, T=10, 10-block fit,
# whose W0, W1 and y0 stay in device memory
_K3_CASES = [(12, 5, d, nb, s, c) for d in tff.FUSED_DIMS for nb in (1, 4)
             for s in ("diag", "full", "block") for c in (False, True)] + [
    (13, 5, 6, 1, "full", False), (15, 10, 6, 5, "block", True),
    (100, 10, 6, 10, "full", False)]


@pytest.mark.parametrize("n,T,d,num_blocks,structure,corrected", _K3_CASES)
def test_fused_fit_matches_twin(cuda_device, n, T, d, num_blocks, structure,
                                corrected):
    # Bad SMF at d = 12 grows its means fastest: over 20 iterations the
    # fit's own float32 rounding reaches the state bound, so it is compared
    # over 10 (test_torch_fused_fit holds the float32 twin to a float64 run
    # within half the bound there).  The twin runs in float64 on the CPU:
    # the card's float32 unfused loop sums in another order than K3, and two
    # float32 block fits part by up to twice their own rounding.
    max_iter = 10 if (d, structure) == (12, "block") else 20
    args, kw = _k3_fit(cuda_device, n, T, d, structure, seed=d + n,
                       max_iter=max_iter)
    kw.update(corrected=corrected, num_blocks=num_blocks)
    k = tff.fused_fit_kernel(*args, **kw)
    t = tff.fused_fit_twin(*[a.cpu().double() if torch.is_tensor(a) else a
                             for a in args], **kw)
    k = k._replace(X_mean=k.X_mean.cpu().double(),
                   X_cov=k.X_cov.cpu().double())
    assert (k.n_iter, k.converged, k.diverged) == (t.n_iter, t.converged,
                                                   t.diverged)
    torch.testing.assert_close(k.elbo_history, t.elbo_history, rtol=RTOL,
                               atol=0, equal_nan=True)
    torch.testing.assert_close(k.X_mean, t.X_mean, rtol=0, atol=STATE_ATOL)
    torch.testing.assert_close(k.X_cov, t.X_cov, rtol=0, atol=STATE_ATOL)


def test_fused_fit_launch_does_not_synchronise(cuda_device):
    """The launch half of ``fused_fit_kernel`` runs under
    ``set_sync_debug_mode("error")``, where a readback raises; the one
    readback comes after it."""
    args, kw = _k3_fit(cuda_device, 15, 10, 6, "full", seed=3)
    kw.update(num_blocks=15)
    ref = tff.fused_fit_kernel(*args, **kw)  # builds the extension
    torch.cuda.synchronize()
    before = tff.fused_fit_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        Xm, _, hist = tff.fused_fit_launch(*args, **kw)
        with pytest.raises(RuntimeError):
            hist.cpu()  # the mode is live: a readback synchronises
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tff.fused_fit_kernel.launches == before + 1
    h = hist.cpu()
    assert int(h[-5]) == ref.n_iter == 20
    torch.testing.assert_close(h[:64], ref.elbo_history, rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(Xm, ref.X_mean, rtol=0, atol=0)


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
                                   (7, 5, 16), (3, 1, 14), (2, 3, 48),
                                   (4, 3, 32), (4, 3, 34), (5, 4, 48),
                                   (2001, 5, 10), (133, 7, 14)])
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


def test_fused_smoother_indefinite_node_is_nan(cuda_device):
    """A node whose D_t is indefinite gives NaN in every output, as the
    twin does; the other nodes are the twin's."""
    D, O, b = _smoother_system(5, 6, 14, cuda_device, 3)
    D[2, 3] = -torch.eye(14, device=cuda_device)
    k = tfs.fused_smoother_kernel(D, O, b)
    torch.cuda.synchronize()
    t = tfs.fused_smoother_twin(D, O, b)
    keep = [0, 1, 3, 4]
    for name in ("mean", "cov", "cross_cov", "logdet"):
        got, ref = getattr(k, name), getattr(t, name)
        assert torch.isnan(got[2]).all() and torch.isnan(ref[2]).all(), name
        got, ref = got[keep], ref[keep]
        assert torch.isfinite(got).all(), name
        if name == "logdet":
            torch.testing.assert_close(got, ref, rtol=LOGDET_RTOL, atol=0)
        else:
            assert (got - ref).abs().max() <= SMOOTHER_REL * ref.abs().max()


def test_fused_smoother_envelope_and_smem_formula(cuda_device):
    from tame_torch.ops import _ext

    ext = _ext.load()
    for d in (4, 6, 8, 10, 12, 14, 16, 32, 34, tchol.MAX_KERNEL_D):
        for warps in range(1, tfs.MAX_WARPS + 1):
            assert ext.fused_smoother_smem_bytes(d, warps) == \
                tfs.fused_smoother_smem_bytes(d, warps)
        for n in (1, 125, 133, 2000, 2001):
            assert ext.fused_smoother_warps(n, d) == \
                tfs.fused_smoother_warps(n, d)
    assert ext.fused_smoother_smem_bytes(tchol.MAX_KERNEL_D + 2, 1) == 0
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
    # the same fit on the card with every smooth through the twin, eagerly:
    # the twin's tridiagonal solves cannot be captured into a CUDA graph
    monkeypatch.setattr(smoothed, "fused_smoother", tfs.fused_smoother_twin)
    monkeypatch.setattr(graphed, "engages", lambda *a, **k: False)
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
    same fit on the card with every kernel call through its twin, run
    eagerly: a twin has no launch counter for a capture to read, and K4's
    twin's tridiagonal solves cannot be captured into a CUDA graph."""
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
    monkeypatch.setattr(graphed, "engages", lambda *a, **k: False)
    ref = fit()
    torch.testing.assert_close(res.elbo_history, ref.elbo_history,
                               rtol=RTOL, atol=0, equal_nan=True)


@pytest.mark.parametrize("T,N,R", [(50, 2000, 4), (3, 48, 4), (3, 37, 1),
                                   (3, 37, 16), (2, 40, 7), (1, 8200, 2)])
def test_eta_contract_matches_twin(cuda_device, T, N, R):
    g = torch.Generator(device=cuda_device).manual_seed(N + R)
    W = torch.randn(T, N, N, device=cuda_device, generator=g).to(
        torch.bfloat16)
    Z = torch.randn(N, T, R, device=cuda_device, generator=g)
    before = tec.eta_contract_kernel.launches
    got = tec.eta_contract(W, Z)
    assert tec.eta_contract_kernel.launches == before + 1
    assert _max_rel(got, tec.eta_contract_twin(W, Z)) <= CONTRACT_REL


# The engines' K7 launches: (label, dtype, T, rows, n, R); a panel that is
# a strided view of a (n, T, 2 + 2R) state's means.
K7_PATH = [("f32 stripe", torch.float32, 50, slice(125, 250), 2000, 4),
           ("bf16 stripe", torch.bfloat16, 50, slice(125, 250), 2000, 4),
           ("bf16 whole, stats halves", torch.bfloat16, 50, slice(None),
            2000, 16),
           ("bf16 whole, r=6 halves", torch.bfloat16, 50, slice(None), 2000,
            24),
           ("bf16 whole, r=7 halves", torch.bfloat16, 50, slice(None), 2000,
            28),
           ("f32 whole, r=23 halves", torch.float32, 10, slice(None), 300,
            92),
           ("f32 stripe, r=6", torch.float32, 50, slice(0, 125), 2000, 6),
           ("quick start row", torch.float32, 10, slice(3, 4), 15, 2),
           ("ragged f32", torch.float32, 3, slice(12, 24), 37, 5),
           ("ragged bf16", torch.bfloat16, 3, slice(None), 37, 16)]


@pytest.mark.parametrize("case", K7_PATH, ids=[c[0] for c in K7_PATH])
def test_eta_contract_at_the_path_shapes(cuda_device, case):
    """K7 on a stripe of the time-major weights read in place, against a
    strided panel, against its twin; a float32 panel is not rounded."""
    _, dtype, T, rows, n, R = case
    g = torch.Generator(device=cuda_device).manual_seed(n + R)
    W = torch.randn(T, n, n, device=cuda_device, generator=g).to(dtype)
    Z = torch.randn(n, T, 2 + 2 * R, device=cuda_device,
                    generator=g)[..., 2 + R:]
    got = tec.eta_contract(W[:, rows], Z)
    ref = tec.eta_contract_twin(W[:, rows], Z)
    assert got.shape == ref.shape == (W[:, rows].shape[1], T, R)
    assert _max_rel(got, ref) <= CONTRACT_REL
    if dtype == torch.float32:
        rounded = tec.eta_contract_twin(W[:, rows], Z.to(
            torch.bfloat16).float())
        assert _max_rel(got, rounded) > CONTRACT_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eta_contract_stripes_are_the_whole_matrix_rows(cuda_device, dtype):
    """A row's sums do not depend on the tile K7 picks: the 16 stripes of
    a block sweep give the whole matrix's bits."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    W = torch.randn(50, 2000, 2000, device=cuda_device, generator=g).to(
        dtype)
    Z = torch.randn(2000, 50, 10, device=cuda_device, generator=g)[..., 6:]
    whole = tec.eta_contract(W, Z)
    stripes = torch.cat([tec.eta_contract(W[:, lo:lo + 125], Z)
                         for lo in range(0, 2000, 125)])
    assert torch.equal(stripes, whole)


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_graphed_block_step_is_the_eager_one(cuda_device, mixed_precision):
    """One block step captured into a CUDA graph, with its 2 K7 launches
    a block, replays the eager step's bits."""
    n, T, r, blocks = 64, 8, 2, 4
    model = TemporalAMEModel(n, T, r, device=cuda_device, seed=5)
    model.generate_data()
    p = model.params.to(cuda_device)
    fi = cavi.fit_inputs(model.Y, p.R_inv, None,
                         mixed_precision=mixed_precision, diag_mode="exact",
                         packed_mask=False, num_blocks=blocks)
    pri = cavi.precompute_priors(p)
    state = cavi.init_state(torch.Generator(device=cuda_device).manual_seed(
        1), n, T, 2 + 2 * r, "full", 0.1, 0.5, device=cuda_device)

    def step():
        return cavi.cavi_step_block(state, fi.obs, pri, p, "full", 0.7,
                                    blocks)

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = tec.eta_contract_kernel.launches
    with torch.cuda.graph(graph):
        out = step()
    assert tec.eta_contract_kernel.launches - before == 2 * blocks
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.X_mean, eager.X_mean)
    assert torch.equal(out.X_cov, eager.X_cov)


def _max_rel(got, ref):
    assert got.shape == ref.shape
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("n,T,K,nb", [(20, 3, 5, 4), (2000, 50, 57, 16),
                                      (300, 7, 70, 1), (37, 4, 65, 1),
                                      (400, 3, 130, 2)])
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


@pytest.mark.parametrize("T,n,m", [(3, 20, 4), (50, 2000, 8), (2, 37, 13),
                                   (4, 2000, 40), (3, 37, 40), (2, 300, 17)])
def test_dual_contract_matches_twin(cuda_device, T, n, m):
    g = torch.Generator(device=cuda_device).manual_seed(n + m)
    y0 = torch.randn(T, n, n, device=cuda_device, generator=g)
    Z = torch.randn(T, n, m, device=cuda_device, generator=g)
    Wp = tdc.pad_data(y0)
    before = tdc.dual_contract_kernel.launches
    row, col = tdc.dual_contract_padded(Wp, Z)
    # one launch per 16-column slice of Z
    assert tdc.dual_contract_kernel.launches == before + -(-m // 16)
    row_t, col_t = tdc.dual_contract_twin(Wp, Z)
    assert _max_rel(row, row_t) <= CONTRACT_REL
    assert _max_rel(col, col_t) <= CONTRACT_REL


@pytest.mark.parametrize("T,n,m", [(50, 2000, 8), (3, 37, 13), (2, 300, 40)])
def test_dual_contract_is_deterministic(cuda_device, T, n, m):
    """No atomics: two launches on the same inputs give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(7 * n + m)
    Wp = tdc.pad_data(torch.randn(T, n, n, device=cuda_device, generator=g))
    Z = torch.randn(T, n, m, device=cuda_device, generator=g)
    row, col = tdc.dual_contract_padded(Wp, Z)
    again = tdc.dual_contract_padded(Wp, Z)
    assert torch.equal(row, again[0]) and torch.equal(col, again[1])


def test_contract_layouts_match_kernels(cuda_device):
    """The Python mirror of K6's shared memory is the binding's, and the
    wrapper refuses an n whose block would not fit."""
    from tame_torch.ops import _ext

    ext = _ext.load()
    for n in (1, 20, 37, 300, 2000, 4097, 10752):
        for width in (1, 8, 9, 16):
            assert ext.dual_contract_smem_bytes(n, width) == \
                tdc.smem_bytes(n, width)
    with pytest.raises(ValueError, match="shared memory"):
        tdc.dual_contract_padded(
            torch.zeros(1, 11000, 11000, dtype=torch.bfloat16,
                        device=cuda_device),
            torch.zeros(1, 11000, 16, device=cuda_device))


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


def _bitwise_engines(a, b):
    assert a.history == b.history
    for name in a.state_dict():
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_segmented_k3_fit_bitwise_equals_one_shot(cuda_device, tmp_path):
    """The demo's Good-SMF fit through K3, killed after 10 iterations (2
    segments of 5, one K3 launch each) and resumed to 20 by a fresh
    engine: bit for bit the one-shot fit, which is itself reproducible."""
    from tame_torch import TemporalAMEStructuredMFVI

    model = TemporalAMEModel(n_nodes=15, n_time=10, latent_dim=2, seed=42)
    model.generate_data(generator=torch.Generator().manual_seed(42),
                        device=cuda_device)

    def make():
        return TemporalAMEStructuredMFVI(model, learning_rate=0.7)

    ref, again = make(), make()
    for vi in (ref, again):
        vi.fit(max_iter=20, tolerance=0.0, verbose=False)
    _bitwise_engines(ref, again)
    before = tff.fused_fit_kernel.launches
    make().fit(max_iter=10, tolerance=0.0, verbose=False,
               checkpoint_every=5, ckpt_dir=tmp_path / "ck")
    vi = make()
    vi.fit(max_iter=20, tolerance=0.0, verbose=False, checkpoint_every=5,
           ckpt_dir=tmp_path / "ck", resume=True)
    assert tff.fused_fit_kernel.launches == before + 4
    _bitwise_engines(vi, ref)


def test_segmented_smoothed_fit_bitwise_equals_one_shot(cuda_device,
                                                        tmp_path):
    """A smoothed fit through K4 (4 blocks), killed after 8 iterations in
    segments of 4 and resumed to 12: bit for bit the one-shot fit."""
    from tame_torch import TemporalAMESmoothedVI

    model = TemporalAMEModel(n_nodes=24, n_time=6, latent_dim=2, seed=5)
    model.generate_data(device=cuda_device)

    def make():
        return TemporalAMESmoothedVI(model, learning_rate=0.8,
                                     update_mode="block", num_blocks=4)

    ref, again = make(), make()
    for vi in (ref, again):
        vi.fit(max_iter=12, tolerance=0.0, verbose=False)
    _bitwise_engines(ref, again)
    before = tfs.fused_smoother_kernel.launches
    make().fit(max_iter=8, tolerance=0.0, verbose=False, checkpoint_every=4,
               ckpt_dir=tmp_path / "sm")
    vi = make()
    vi.fit(max_iter=12, tolerance=0.0, verbose=False, checkpoint_every=4,
           ckpt_dir=tmp_path / "sm", resume=True)
    assert tfs.fused_smoother_kernel.launches == before + 4 * 12
    _bitwise_engines(vi, ref)


@pytest.mark.parametrize("structure", ["diag", "full", "block"])
def test_seq_sweep_on_card_matches_cpu(cuda_device, structure):
    """The seq sweep on the card (one K1 launch per (node, time) solve)
    against the same fit on the CPU: ELBO within 1e-4 relative at every
    iteration and the same stop."""
    model = TemporalAMEModel(n_nodes=8, n_time=4, latent_dim=2, seed=3,
                             device="cpu")
    Y = model.generate_data()
    init = cavi.init_state(torch.Generator().manual_seed(1), 8, 4, 6,
                           structure, 0.1, 0.5)
    kw = dict(structure=structure, update_mode="seq", max_iter=40,
              learning_rate=0.7, tolerance=1e-4)
    before = tchol.spd_solve_inv_kernel.launches
    card = cavi.fit_cavi(Y.to(cuda_device), model.params.to(cuda_device),
                         cavi.CaviState(init.X_mean.to(cuda_device),
                                        init.X_cov.to(cuda_device)), **kw)
    assert tchol.spd_solve_inv_kernel.launches == before + 8 * 4 * card.n_iter
    cpu = cavi.fit_cavi(Y, model.params, init, **kw)
    assert (card.n_iter, card.converged) == (cpu.n_iter, cpu.converged)
    torch.testing.assert_close(card.elbo_history, cpu.elbo_history,
                               rtol=RTOL, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# The non-Gaussian families: K1/K2 in the mean-field engines, K4 in the
# smoothed families
# ---------------------------------------------------------------------------

FAMILY_KINDS = ["Bernoulli", "Poisson", "smoothed Bernoulli",
                "smoothed Poisson"]


def _family_problem(kind):
    """n=40, T=5, r=2 data of the kind's family drawn on the CPU, 30 % of
    the dyads hidden, and an init computed on the CPU."""
    from tame_torch.inference import warm_init_smoothed_family
    from tame_torch.models import sample

    family = kind.split()[-1].lower()
    p = build_params(ModelConfig(n_nodes=40, n_time=5, latent_dim=2,
                                 seed=0))
    Y, _ = sample(p, torch.Generator().manual_seed(0), 40, 5, family=family)
    mask = random_dyad_mask(torch.Generator().manual_seed(1), 40, 5, 0.3)
    if kind == "Bernoulli":
        init = cavi.init_state(torch.Generator().manual_seed(10), 40, 5, 6,
                               "full", 0.1, 0.5)
    elif kind == "Poisson":
        init = cavi.warm_init_state(torch.log(Y + 0.5), p, structure="full",
                                    obs_mask=mask)
    else:
        init = warm_init_smoothed_family(Y, p, family, obs_mask=mask)
    return p, Y, mask, init


def _family_fit(kind, p, Y, mask, init, **kw):
    from tame_torch.inference import (fit_cavi_bernoulli, fit_cavi_poisson,
                                      fit_smoothed_family)

    if kind == "Bernoulli":
        return fit_cavi_bernoulli(Y, p, init, mask=mask, **kw)
    if kind == "Poisson":
        return fit_cavi_poisson(Y, p, init, mask=mask, **kw)
    return fit_smoothed_family(Y, p, init, mask=mask,
                               family=kind.split()[1].lower(), **kw)


def _rejected(kind, out):
    eh = out.elbo_history[:out.n_iter].tolist()
    if kind == "Poisson":
        return torch.isnan(out.deviance_history[:out.n_iter]).nonzero(
        ).ravel().tolist()
    return [i for i in range(1, len(eh)) if eh[i] == eh[i - 1]]


@pytest.mark.parametrize("kind", FAMILY_KINDS)
def test_family_fit_on_card_matches_cpu(cuda_device, kind):
    """Each non-Gaussian fit on the card against the same fit on the CPU
    (the twins) from one init, 60 iterations at tolerance 0: the same
    stop and rejected iterations, the objective within RTOL at every
    iteration; K1 and K2 once per mean-field iteration, K4 once per
    smoothed-family iteration."""
    p, Y, mask, init = _family_problem(kind)
    kw = dict(max_iter=60, tolerance=0.0)
    counters = (tchol.spd_solve_inv_kernel, tchol.logdet_spd_kernel,
                tfs.fused_smoother_kernel)
    before = [c.launches for c in counters]
    card = _family_fit(kind, p.to(cuda_device), Y.to(cuda_device),
                       mask.to(cuda_device),
                       type(init)(*(x.to(cuda_device) for x in init)), **kw)
    launches = [c.launches - b for c, b in zip(counters, before)]
    smoothed = kind.startswith("smoothed")
    assert launches == ([0, 0, 60] if smoothed else [60, 60, 0])
    cpu = _family_fit(kind, p, Y, mask, init, **kw)
    assert (card.n_iter, card.diverged) == (cpu.n_iter, cpu.diverged)
    assert _rejected(kind, card) == _rejected(kind, cpu)
    torch.testing.assert_close(card.elbo_history, cpu.elbo_history,
                               rtol=RTOL, atol=0, equal_nan=True)


@pytest.mark.parametrize("family", ["bernoulli", "poisson"])
def test_family_engine_resume_on_card_is_bitwise(cuda_device, tmp_path,
                                                 family):
    """A mean-field engine on the card killed after 12 iterations in
    segments of 4 and resumed to 20: bit for bit the one-shot fit, which
    is itself reproducible (the Poisson checkpoint carries the guarded
    loop's proposal and step scale)."""
    from tame_torch.inference import (TemporalAMEBernoulliVI,
                                      TemporalAMEPoissonVI)
    from tame_torch.models import sample

    model = TemporalAMEModel(n_nodes=40, n_time=5, latent_dim=2, seed=0,
                             device="cpu")
    model.Y, model.X = sample(model.params, torch.Generator().manual_seed(0),
                              40, 5, family=family)
    model.Y = model.Y.to(cuda_device)
    engine = (TemporalAMEBernoulliVI if family == "bernoulli"
              else TemporalAMEPoissonVI)

    def same(a, b):
        assert a.history.keys() == b.history.keys()
        for k in a.history:
            torch.testing.assert_close(torch.tensor(a.history[k]),
                                       torch.tensor(b.history[k]), rtol=0,
                                       atol=0, equal_nan=True)
        for name in a.state_dict():
            assert torch.equal(getattr(a, name), getattr(b, name)), name

    ref, again = engine(model), engine(model)
    for vi in (ref, again):
        vi.fit(max_iter=20, tolerance=0.0, verbose=False)
    same(ref, again)
    engine(model).fit(max_iter=12, tolerance=0.0, verbose=False,
                      checkpoint_every=4, ckpt_dir=tmp_path / "ck")
    vi = engine(model)
    vi.fit(max_iter=20, tolerance=0.0, verbose=False, checkpoint_every=4,
           ckpt_dir=tmp_path / "ck", resume=True)
    same(vi, ref)


def test_family_smoothed_launches_k4_once_per_iteration(cuda_device):
    """``fit_smoothed_family`` sends every node's trajectory through one
    K4 launch per iteration, rejected iterations included."""
    from tame_torch.inference import fit_smoothed_family

    p, Y, mask, init = _family_problem("smoothed Poisson")
    before = tfs.fused_smoother_kernel.launches
    out = fit_smoothed_family(
        Y.to(cuda_device), p.to(cuda_device),
        type(init)(*(x.to(cuda_device) for x in init)), family="poisson",
        mask=mask.to(cuda_device), max_iter=150, tolerance=1e-5)
    assert tfs.fused_smoother_kernel.launches - before == out.n_iter
    assert not out.diverged
