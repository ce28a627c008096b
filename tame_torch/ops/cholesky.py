"""Batched small-SPD solve, inverse and log-determinant: the CAVI update's
hot ops (counterpart of :mod:`tame.ops.cholesky`).

Every CAVI block phase solves ``(n / num_blocks) * T`` independent d x d SPD
systems (d = 2 + 2r) for ``mu = P^-1 eta`` and ``cov = P^-1``; every ELBO
takes ``n * T`` log-determinants for the entropy.

Dispatch: a CPU tensor takes the plain PyTorch twin; a CUDA tensor launches
the hand-written kernel or raises.  Nothing falls back.

K1 ``spd_solve_inv`` (``csrc/spd.cu``) replaces
``tame/ops/cholesky.py::_chol_solve_inv_kernel`` (via
``_pallas_spd_solve_inv``).  K2 ``logdet_spd`` (same file) replaces
``tame/ops/cholesky.py::_logdet_kernel`` (via ``_pallas_logdet``).  Both
run one thread per system.  For d in :data:`UNROLLED_DIMS` the factor lives
in registers (the unrolled ``template<int D>`` Cholesky of
``csrc/chol.cuh``); every other even d up to :data:`MAX_KERNEL_D` (the JAX
kernels unroll for any d, and an r = 6 model has d = 14) runs a runtime-d
variant with the factor in shared memory.  On the card they are bound by
device-memory
traffic: K1 with the inverse reads d^2 + d and writes d^2 + d floats per
system for ~d^3 flops, far below the H100's flop/byte balance.  Reading a
row-major (B, d, d) batch one system per thread is uncoalesced (adjacent
threads are d^2 floats apart); L1/L2 absorb part of it and a
transposed-batch layout is later work.  The ragged tail is a bounds
check, not the TPU kernel's identity padding.
"""

from __future__ import annotations

import torch

from tame_torch.ops import _ext

UNROLLED_DIMS = (4, 6, 8, 10, 12)  # template<int D> instantiations
MAX_KERNEL_D = 48                  # the runtime-d variants' largest d
KERNEL_D_TEXT = f"{{4, 6, ..., {MAX_KERNEL_D}}}"


def kernel_supports_d(d: int) -> bool:
    """Whether K1, K2 and K4 have a build for state dimension ``d``
    (unrolled or runtime-d): every even d from 4 to :data:`MAX_KERNEL_D`,
    i.e. d = 2 + 2r for r = 1 .. 23."""
    return d % 2 == 0 and 4 <= d <= MAX_KERNEL_D


def _check_kernel_inputs(P: torch.Tensor, *others: torch.Tensor) -> None:
    d = P.shape[-1]
    if not kernel_supports_d(d):
        raise ValueError(
            f"the CUDA SPD kernels are built for d in {KERNEL_D_TEXT}, got "
            f"d={d}")
    for t in (P,) + others:
        if t.dtype != torch.float32:
            raise TypeError(f"CUDA SPD kernels take float32, got {t.dtype}")
        if t.device != P.device:
            raise ValueError("all inputs must be on one device")


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or twin for device {x.device}")


# ---------------------------------------------------------------------------
# Plain PyTorch twins (same contract as the kernels)
# ---------------------------------------------------------------------------

def _cholesky_nan(P: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN for a system that is not positive
    definite, as the unrolled kernel gives (sqrt of a negative pivot)."""
    L, info = torch.linalg.cholesky_ex(P)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def spd_solve_inv_twin(P: torch.Tensor, eta: torch.Tensor,
                       with_inverse: bool = True):
    """P (B, d, d), eta (B, d) -> mu (B, d)[, cov (B, d, d)]."""
    L = _cholesky_nan(P)
    mu = torch.cholesky_solve(eta[..., None], L)[..., 0]
    if not with_inverse:
        return mu
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    return mu, torch.cholesky_solve(eye.expand_as(P), L)


def logdet_spd_twin(P: torch.Tensor) -> torch.Tensor:
    """P (B, d, d) SPD -> log det P (B,)."""
    L = _cholesky_nan(P)
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def spd_solve_inv_kernel(P: torch.Tensor, eta: torch.Tensor,
                         with_inverse: bool = True):
    """Launch K1 on CUDA tensors: P (B, d, d), eta (B, d)."""
    _check_kernel_inputs(P, eta)
    mu, cov = _ext.load().spd_solve_inv(P.contiguous(), eta.contiguous(),
                                        with_inverse)
    spd_solve_inv_kernel.launches += 1
    return (mu, cov) if with_inverse else mu


spd_solve_inv_kernel.launches = 0


def logdet_spd_kernel(P: torch.Tensor) -> torch.Tensor:
    """Launch K2 on a CUDA tensor: P (B, d, d) -> (B,)."""
    _check_kernel_inputs(P)
    out = _ext.load().logdet_spd(P.contiguous())
    logdet_spd_kernel.launches += 1
    return out


logdet_spd_kernel.launches = 0


# ---------------------------------------------------------------------------
# Public entry points (any leading batch shape)
# ---------------------------------------------------------------------------

def batched_spd_solve_inv(P: torch.Tensor, eta: torch.Tensor):
    """``mu = P^-1 eta`` and ``cov = P^-1`` for P (..., d, d),
    eta (..., d)."""
    batch_shape, d = P.shape[:-2], P.shape[-1]
    Pb, eb = P.reshape(-1, d, d), eta.reshape(-1, d)
    solve = spd_solve_inv_kernel if _on_card(Pb) else spd_solve_inv_twin
    mu, cov = solve(Pb, eb, True)
    return mu.reshape(*batch_shape, d), cov.reshape(*batch_shape, d, d)


def batched_spd_solve(P: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """``mu = P^-1 eta`` only (the naive-MF policy's mean solve)."""
    batch_shape, d = P.shape[:-2], P.shape[-1]
    Pb, eb = P.reshape(-1, d, d), eta.reshape(-1, d)
    solve = spd_solve_inv_kernel if _on_card(Pb) else spd_solve_inv_twin
    return solve(Pb, eb, False).reshape(*batch_shape, d)


def batched_logdet_spd(P: torch.Tensor) -> torch.Tensor:
    """Log-determinant of a batch of small SPD matrices (..., d, d) -> (...)."""
    batch_shape, d = P.shape[:-2], P.shape[-1]
    Pb = P.reshape(-1, d, d)
    logdet = logdet_spd_kernel if _on_card(Pb) else logdet_spd_twin
    return logdet(Pb).reshape(batch_shape)
