"""Fused AR(1) forward-backward smoother over a batch of node trajectories
(counterpart of :mod:`tame.ops.fused_smoother`).

K4 ``fused_smoother`` (``csrc/fused_smoother.cu``) replaces
``tame/ops/fused_smoother.py::_smoother_kernel``: the whole block-
tridiagonal forward elimination and backward substitution of
:func:`tame_torch.ops.tridiag.block_tridiag_smoother` for every node in
one launch, in the JAX layout (D (n, T, d, d), b (n, T, d)).  Its plain
twin, :func:`fused_smoother_twin`, is that function: a Python loop over T
of batched ``cholesky_ex``/``cholesky_solve``/``matmul``.

What bounds it on the card: each node is a chain of T dependent forward
steps (two d x d products and an inverse) and T - 1 backward steps (three
products), writing ~(3 d^2 + 2 d) * 4 B per step; the bytes are small, so
the latency of the chain is the cost, not bytes.  The design shortens that
chain.  One warp runs one node: lane i owns row i of every d x d matrix
(rows i and i + 32 past d = 32) and keeps its rows in registers.  Every
loop runs to the column capacity (:func:`fused_smoother_capacity`, a
template constant; d < capacity pads O and b with zeros and D with the
identity), so each product unrolls and its loads issue together.  The
rows other lanes need sit in a per-warp shared-memory slab and are read
in 16-byte loads: four entries of another row in one broadcast, four of
the lane's own row in one load, conflict-free because the row pitch
(:func:`fused_smoother_pitch`) is a multiple of 4 whose quarter is odd
(an odd pitch would break the 16-byte alignment).  Each product computes
the lane's output row with float32 FMAs.  S_t^-1 comes from an in-place
Gauss-Jordan sweep of the SPD S_t without pivoting on the rows in
registers, d warp-wide pivot steps, each a shuffle of the pivot row (no
step on one thread); its pivots
are Cholesky's L_kk^2, so logdet sums their logs, and a pivot that is not
positive makes that node NaN, as the twin does.  The next step's inputs
(D_{t+1}, b_{t+1} forward; the parked S_{t-1}^-1, c_{t-1} backward) are
fetched with ``cp.async`` while the step computes, and the t loop has no
block barrier.  :func:`fused_smoother_warps` packs 1 node per block while
n <= 132 (n = 125 at a block phase of the n = 2000 fit: 125 SMs busy) and
up to 4 per block beyond (n = 2000: 500 blocks of 128 threads).  The TPU
kernel's output-reuse trick stays: the forward pass parks S_t^-1 in ``cov``
and c_t in ``mean``, the backward pass overwrites them, so there is no
scratch.

One design covers every even d from 4 to 48, templated on the column
capacity (exact d up to 16, then 24, 32, 48).  The JAX package's smoothed
fit leaves its Pallas smoother for a ``lax.scan`` at d > 12; the port
keeps K4, which solves the same system (a deliberate difference, ROADMAP
C).

Dispatch: a CPU tensor takes the twin; a CUDA tensor launches K4 or
raises.  The envelope (:func:`fused_smoother_supported`) is every even d
from 4 to 48 and T >= 1 (at T = 1 the backward pass is empty and
``cross_cov`` is (n, 0, d, d)).  A one-node block takes 3,120 B of shared
memory at d = 10, 7,040 B at d = 14 and 60,864 B at d = 48; past 48 KB
the launcher opts in with ``cudaFuncSetAttribute``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tame_torch.ops import _ext
from tame_torch.ops.cholesky import (KERNEL_D_TEXT, _on_card,
                                     kernel_supports_d)
from tame_torch.ops.tridiag import block_tridiag_smoother


MAX_WARPS = 4          # nodes per K4 block
SM_SPREAD = 132        # SMs of an H100 SXM: one node per block up to here
MAX_SMEM_BYTES = 232448  # 227 KB, the most a block may use on sm_90


def fused_smoother_capacity(d: int) -> int:
    """K4's column capacity for state dimension ``d`` (its template
    argument): d itself up to 16, then 24, 32 or 48; the matrices are
    padded to it."""
    if d <= 16:
        return d
    return 24 if d <= 24 else (32 if d <= 32 else 48)


def fused_smoother_pitch(c: int) -> int:
    """Row pitch of K4's shared-memory matrices at capacity ``c``: the
    least multiple of 4 >= c whose quarter is odd, so that 16-byte loads
    of a lane's own row are conflict-free."""
    return (c + 3) // 8 * 8 + 4


def fused_smoother_smem_bytes(d: int, warps: int = 1) -> int:
    """Dynamic shared memory of one K4 block holding ``warps`` nodes;
    mirrors ``smoother_smem`` in ``csrc/fused_smoother.cu``: at the
    capacity c, O and O' (c x pitch each), then per warp four c x pitch
    matrices and five vectors of c rounded up to 4."""
    c = fused_smoother_capacity(d)
    mat = c * fused_smoother_pitch(c)
    vec = (c + 3) // 4 * 4
    return 4 * (2 * mat + warps * (4 * mat + 5 * vec))


def fused_smoother_warps(n: int, d: int) -> int:
    """Nodes per K4 block (``smoother_warps`` in the CUDA source): one per
    block while n <= 132, so the nodes spread over the most SMs, then
    ceil(n / 132) up to four, as shared memory allows."""
    w = min(max(-(-n // SM_SPREAD), 1), MAX_WARPS)
    while w > 1 and fused_smoother_smem_bytes(d, w) > MAX_SMEM_BYTES:
        w -= 1
    return w


def fused_smoother_supported(n: int, T: int, d: int) -> bool:
    """Whether K4 covers ``n`` trajectories of length ``T`` at state
    dimension ``d``.  Neither ``n`` (one warp per node) nor shared memory
    (independent of n and T) bounds it."""
    return kernel_supports_d(d) and T >= 1


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
            f"K4 is built for d in {KERNEL_D_TEXT} and T >= 1, got d={d}, "
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
