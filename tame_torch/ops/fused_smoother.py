"""Fused AR(1) forward-backward smoother over a batch of node trajectories
(counterpart of :mod:`tame.ops.fused_smoother`).

K4 ``fused_smoother`` (``csrc/fused_smoother.cu``) replaces
``tame/ops/fused_smoother.py::_smoother_kernel``: the whole block-
tridiagonal forward elimination and backward substitution of
:func:`tame_torch.ops.tridiag.block_tridiag_smoother` for every node in
one launch, in the JAX layout (D (n, T, d, d), b (n, T, d)).  Its plain
twin, :func:`fused_smoother_twin`, is that function: a Python loop over T
of batched ``cholesky_ex``/``cholesky_solve``/``matmul``.

What bounds it on the card: each node is a chain of T dependent steps of
~5 d^3 flops (two d x d products and an inverse forward, three products
backward) writing ~(3 d^2 + 2 d) * 4 B per step; the bytes are small, so
the latency of the chain is the cost.  The smoothed fit calls it with 125
trajectories per block phase (n = 2000, 16 blocks) and n per Jacobi
sweep, so one thread per node would fill a single SM, and at d = 10 would
spill its three live 10 x 10 matrices.  The kernel runs one thread block
per node instead: the node's working matrices in shared memory
(:func:`fused_smoother_smem_bytes`, independent of T), the d x d products
one entry per thread, the factor of S_t on one thread (the shared
``chol_factor<D>``) and S_t^-1 as d unit-column solves, one per thread.
The TPU kernel's output-reuse trick stays: the forward pass parks S_t^-1
in ``cov`` and c_t in ``mean``, the backward pass overwrites them.

Dispatch: a CPU tensor takes the twin; a CUDA tensor launches K4 or
raises.  The envelope (:func:`fused_smoother_supported`) is d in
{4, 6, 8, 10, 12} and T >= 1 (at T = 1 the backward pass is empty and
``cross_cov`` is (n, 0, d, d)); the shared memory of one block is at most
3,124 B (d = 12), so it bounds nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tame_torch.ops import _ext
from tame_torch.ops.cholesky import KERNEL_DIMS, _on_card
from tame_torch.ops.tridiag import block_tridiag_smoother


def fused_smoother_smem_bytes(d: int) -> int:
    """Static shared memory of one K4 block; mirrors ``SmootherSmem<D>`` in
    ``csrc/fused_smoother.cu`` (five d x d matrices, five d-vectors and
    the logdet), far below the 48 KB a block may declare statically."""
    return 4 * (5 * d * d + 5 * d + 1)


def fused_smoother_supported(n: int, T: int, d: int) -> bool:
    """Whether K4 covers ``n`` trajectories of length ``T`` at state
    dimension ``d``.  Neither ``n`` (one block per node) nor shared memory
    (independent of n and T) bounds it."""
    return d in KERNEL_DIMS and T >= 1


class FusedSmootherOut(NamedTuple):
    mean: torch.Tensor        # (n, T, d)
    cov: torch.Tensor         # (n, T, d, d)
    cross_cov: torch.Tensor   # (n, T-1, d, d)  Cov(X_t, X_{t+1})
    logdet: torch.Tensor      # (n,)


def fused_smoother_twin(D: torch.Tensor, O: torch.Tensor,
                        b: torch.Tensor) -> FusedSmootherOut:
    """Plain PyTorch twin of K4 (same contract)."""
    return FusedSmootherOut(*block_tridiag_smoother(D, O, b))


def fused_smoother_kernel(D: torch.Tensor, O: torch.Tensor,
                          b: torch.Tensor) -> FusedSmootherOut:
    """Launch K4 on CUDA tensors: D (n, T, d, d), O (d, d), b (n, T, d)."""
    n, T, d, _ = D.shape
    if not fused_smoother_supported(n, T, d):
        raise ValueError(
            f"K4 is built for d in {KERNEL_DIMS} and T >= 1, got d={d}, "
            f"T={T}")
    for name, x in (("D", D), ("O", O), ("b", b)):
        if x.dtype != torch.float32:
            raise TypeError(f"K4 takes float32, got {name} {x.dtype}")
        if x.device != D.device:
            raise ValueError("all inputs must be on one device")
    out = _ext.load().fused_smoother(D.contiguous(), O.contiguous(),
                                     b.contiguous())
    fused_smoother_kernel.launches += 1
    return FusedSmootherOut(*out)


fused_smoother_kernel.launches = 0


def fused_smoother(D: torch.Tensor, O: torch.Tensor,
                   b: torch.Tensor) -> FusedSmootherOut:
    """Batched block-tridiagonal smooth of n independent trajectory
    systems: K4 on a CUDA ``D``, the twin on a CPU one."""
    run = fused_smoother_kernel if _on_card(D) else fused_smoother_twin
    return run(D, O, b)
