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
take every even d from 4 to :data:`MAX_KERNEL_D` in one design: a group of
4 to 32 lanes per system (:func:`spd_geometry`, which mirrors the kernel's
rule), row i of P in registers of lane i % G, loops to a compile-time
column capacity, and rows read up to the diagonal in 8- or 16-byte loads,
so a warp reads neighbouring systems as one span.  The group factors P by
a right-looking Cholesky, each pivot and each L entry shuffled from the
lane that holds its row, in the JAX kernel's arithmetic order, so L, the
pivots and log det P come out as that kernel's (and the one-thread CUDA
kernel's that came before) bit for bit.  K2 sums the log pivots; K1 then
solves the columns of [I | eta] by forward and backward substitution, one
lane per column.  K1 with the inverse takes one row a lane up to d = 32;
K1 without it and K2 take narrower groups with several rows a lane, as
their throughput is bound by the shuffles, one issue per warp for each L
entry; up to d = 12, where the entropy's n T systems keep every lane
busy, K2 runs the same Cholesky on one thread per system, which measured
faster there.  Only the lower triangle of P is read, as by the JAX
kernels and the twins.  On the card they are bound by device-memory
traffic: K1 with the inverse reads d^2 + d and writes d^2 + d floats per
system for ~2.3 d^3 flops.  The ragged tail is a bounds check, not the
TPU kernel's identity padding.
"""

from __future__ import annotations

import torch

from tame_torch.ops import _ext

MAX_KERNEL_D = 48  # K1, K2 and K4 take every even d up to this
KERNEL_D_TEXT = f"{{4, 6, ..., {MAX_KERNEL_D}}}"


def kernel_supports_d(d: int) -> bool:
    """Whether K1, K2 and K4 have a build for state dimension ``d``: every
    even d from 4 to :data:`MAX_KERNEL_D`, i.e. d = 2 + 2r for r = 1 .. 23."""
    return d % 2 == 0 and 4 <= d <= MAX_KERNEL_D


def spd_capacity(d: int) -> int:
    """K1/K2's column capacity at state dimension ``d`` (``spd_capacity``
    in ``csrc/spd.cu``): exact up to 16, then 24, 32, 48."""
    return d if d <= 16 else (24 if d <= 24 else (32 if d <= 32 else 48))


def spd_group(capacity: int, narrow: bool = False) -> int:
    """Lanes per system at a column capacity (``spd_group`` in
    ``csrc/spd.cu``): K1 with the inverse 4, 8, 16, then 32; ``narrow``
    (K1 without the inverse, and K2 past d = 12) 4 up to 16, then 8 and
    16, with several rows per lane."""
    c = capacity
    if narrow:
        return 4 if c <= 16 else (8 if c <= 24 else 16)
    return 4 if c <= 4 else (8 if c <= 8 else (16 if c <= 16 else 32))


def spd_geometry(d: int, narrow: bool = False) -> tuple[int, int, int]:
    """``(capacity, lanes per system, systems per block)`` of K1 with the
    inverse (of K1 without it and K2 past d = 12 when ``narrow``; K2 up to
    d = 12 runs one thread per system) at ``d``, as the
    kernel's ``tame_spd_geometry`` gives it; zeros for a d they do not
    take.  A system's rows live in a group of G lanes, row i in lane i % G
    (:func:`spd_group`); a block has 256 threads, or 64 where a lane's rows
    take more than 64 floats."""
    if not kernel_supports_d(d):
        return 0, 0, 0
    c = spd_capacity(d)
    g = spd_group(c, narrow)
    rows = -(-c // g)
    return c, g, (64 if rows * c > 64 else 256) // g


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
    definite, as the kernels give (a pivot that is not positive)."""
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

def _aligned(P: torch.Tensor) -> torch.Tensor:
    """P contiguous and 16-byte aligned, as K1/K2 read it (a copy only for
    a view that starts inside an allocation at an odd offset)."""
    P = P.contiguous()
    return P if P.data_ptr() % 16 == 0 else P.clone()


def spd_solve_inv_kernel(P: torch.Tensor, eta: torch.Tensor,
                         with_inverse: bool = True):
    """Launch K1 on CUDA tensors: P (B, d, d), of which only the lower
    triangle is read, and eta (B, d)."""
    _check_kernel_inputs(P, eta)
    mu, cov = _ext.load().spd_solve_inv(_aligned(P), eta.contiguous(),
                                        with_inverse)
    spd_solve_inv_kernel.launches += 1
    return (mu, cov) if with_inverse else mu


spd_solve_inv_kernel.launches = 0


def logdet_spd_kernel(P: torch.Tensor) -> torch.Tensor:
    """Launch K2 on a CUDA tensor: P (B, d, d), lower triangle read ->
    (B,)."""
    _check_kernel_inputs(P)
    out = _ext.load().logdet_spd(_aligned(P))
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
