"""Whole-fit kernel: the entire damped-CAVI loop in one launch
(counterpart of :mod:`tame.ops.fused_fit`).

K3 ``fused_fit`` (``csrc/fused_fit.cu``) replaces
``tame/ops/fused_fit.py::_fused_fit_kernel``.  At demo-scale configs the
unfused loop is bound by launch count, not arithmetic: one block-mode
iteration at n=15 is 15 phases of ~40 small ops each.  The kernel runs all
iterations — block phases, exact diagnostics, ELBO, stopping rule — in one
512-thread block with ``X_mean``/``X_cov`` resident in shared memory, so a
fit is one launch.  What bounds it is neither bytes nor operations but the
chain of dependent phases on one SM: each phase is a statistics pass over
all nodes, a barrier, the block's closed-form updates and another barrier.
The design shortens each link: a group of 4, 8 or 16 lanes (d = 4; 6, 8;
10, 12) per (node, time) factor, lane k holding row k of the precision; the
partner contraction split over the group's lanes; the inverse, the solve
and the entropy's log-determinant by a Gauss-Jordan sweep whose pivot row
is broadcast by shuffles (no step of a factor's algebra on one thread);
branch-free statistics split over lanes; the fit's constant data (W0, W1,
y0) formed from ``Y`` in the prologue and kept in shared memory where they
fit (:func:`fused_fit_layout`), else in time-major device scratch.

The wrapper does no work before the launch and does not synchronise: the
kernel reads ``Y``, ``R_inv``, ``Sigma0``, ``Q`` and ``Phi`` as they are
and forms the dyad weights, the prior matrices and the log-determinants on
chip (the TPU kernel's SMEM scalars); the learning rate, tolerance and
carry are the launch's arguments.  One device-to-host copy brings back both
histories and the stop statistics (:func:`fused_fit_launch` is the launch
half alone).

Scope (checked by :func:`fused_fit_supported`): structures ``diag``,
``full``, ``block``; ``jacobi`` or ``block`` updates; exact diagnostics
every iteration; float32 weights (no ``mixed_precision``); no mask; d in
:data:`FUSED_DIMS`, the JAX envelope d <= 12 (K1, K2 and K4 also take
larger d; K3 does not); and a problem inside the shared-memory envelope K3
has had since it was ported (:func:`fused_fit_envelope_bytes` within the
227 KB a Hopper block may use: 25 KB at n=15, T=10, d=6; n=100, T=10
inside with 10 blocks, outside as one Jacobi block).  Every shape inside
it has a layout.

Semantics match :func:`tame_torch.inference.cavi.fit_cavi`: once the
stopping rule fires the state freezes and the history slots past the stop
stay NaN.  The plain twin :func:`fused_fit_twin` is that unfused loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tame_torch.ops import _ext
from tame_torch.ops.cholesky import _on_card
from tame_torch.utils import profiling

SMEM_LIMIT_BYTES = 232448  # 227 KB: the most one block may use on sm_90
# d = 2 + 2r for r = 1..5: the sizes K3 is instantiated for, as the JAX
# megakernel's d <= 12 (tame/ops/fused_fit.py, fused_fit_supported).
FUSED_DIMS = (4, 6, 8, 10, 12)
_STRUCTURE_CODES = {"diag": 0, "full": 1, "block": 2}
_RED_FLOATS = 16 * 6  # 16 warps x 6 block-wide sums
STAGED, PADDED = 1, 2  # layout bits (csrc/fused_fit.cu, choose_layout)


def fused_fit_envelope_bytes(n: int, T: int, d: int, num_blocks: int) -> int:
    """Shared memory of the first K3 design at this shape (the state, one
    block's new means and covariances, the statistics, the priors):
    :func:`fused_fit_supported` admits a shape when it is within 227 KB,
    the envelope K3 has kept since it was ported."""
    r = (d - 2) // 2
    per_factor = d + d * d
    floats = (n * T * per_factor                 # X_mean, X_cov
              + (n // num_blocks) * T * per_factor  # phase scratch
              + T * (2 + 4 * r + 3 * r * r)      # global statistics
              + 5 * d * d                        # prior matrices
              + 8 * 6                            # block reduction
              + 1)                               # running flag
    return 4 * floats


def fused_fit_smem_bytes(n: int, T: int, d: int, num_blocks: int,
                         layout: int) -> int:
    """Dynamic shared memory of one K3 fit in ``layout`` (bits
    :data:`STAGED`, :data:`PADDED`); mirrors ``make_layout`` in
    ``csrc/fused_fit.cu``."""
    mp = d + (1 if layout & PADDED else 0)
    moments = (d - 1) ** 2 + d
    bsT = (n // num_blocks) * T
    floats = (n * T * mp + n * T * d * mp        # X_mean, X_cov rows
              + 4 * d * mp                       # prior matrices
              + max(bsT * mp + T * moments, _RED_FLOATS)  # scratch, moments
              + 1)                               # running flag
    if layout & STAGED:
        floats += 2 * T * n * n + T * n * (n | 1)  # W0, W1, y0
    return 4 * floats


def fused_fit_layout(n: int, T: int, d: int, num_blocks: int) -> int:
    """The layout K3 runs this shape with: the first of (staged + padded,
    staged, padded, neither) whose shared memory fits 227 KB, -1 if none
    does; mirrors ``choose_layout`` in ``csrc/fused_fit.cu``."""
    if n < 1 or T < 1 or num_blocks < 1 or n % num_blocks:
        return -1
    for layout in (STAGED | PADDED, STAGED, PADDED, 0):
        if fused_fit_smem_bytes(n, T, d, num_blocks, layout) <= SMEM_LIMIT_BYTES:
            return layout
    return -1


def fused_fit_supported(n: int, T: int, d: int, *, structure: str,
                        update_mode: str, diag_mode: str, elbo_every: int,
                        num_blocks: Optional[int] = None,
                        mixed_precision: bool = False) -> bool:
    """Whether K3 covers this fit configuration and size."""
    if (structure not in _STRUCTURE_CODES
            or update_mode not in ("jacobi", "block")
            or diag_mode != "exact" or elbo_every != 1 or mixed_precision
            or d not in FUSED_DIMS):
        return False
    if update_mode == "jacobi":
        num_blocks = 1
    elif num_blocks is None or n % num_blocks != 0:
        return False
    return fused_fit_envelope_bytes(n, T, d, num_blocks) <= SMEM_LIMIT_BYTES


class FusedFitOut(NamedTuple):
    X_mean: torch.Tensor         # (n, T, d)
    X_cov: torch.Tensor          # (n, T, d, d)
    elbo_history: torch.Tensor   # (buf,) on the CPU, NaN past the stop
    mse_history: torch.Tensor    # (buf,)
    n_iter: int
    converged: bool
    diverged: bool
    last_elbo: float             # convergence carry (segmented fits)
    pat_count: int


def fused_fit_twin(Y, R_inv, Sigma0, Q, Phi, X_mean0, X_cov0, max_iter,
                   learning_rate, tolerance, carry_elbo=None, carry_pat=0, *,
                   r: int, buf_size: int, patience: int = 3,
                   corrected: bool = False, structure: str = "full",
                   num_blocks: int = 1) -> FusedFitOut:
    """Plain PyTorch twin of K3: the unfused loop, which stops (freezes)
    where the kernel's stopping rule fires."""
    from tame_torch.inference import cavi
    from tame_torch.models.params import AMEParams

    if X_mean0.shape[-1] != 2 + 2 * r:
        raise ValueError("X_mean0's last axis must be d = 2 + 2r")
    params = AMEParams(Sigma=Sigma0[:2, :2], Psi=Sigma0[2:, 2:],
                       R=torch.linalg.inv(R_inv), R_inv=R_inv, Phi=Phi, Q=Q,
                       Sigma0=Sigma0)
    res = cavi.fit_loop(
        Y, params, cavi.CaviState(X_mean0, X_cov0), structure=structure,
        update_mode="jacobi" if num_blocks == 1 else "block",
        num_blocks=num_blocks, max_iter=max_iter,
        learning_rate=learning_rate, tolerance=tolerance, patience=patience,
        corrected=corrected, elbo_every=1, buf_size=buf_size,
        carry_elbo=carry_elbo, carry_patience=carry_pat)
    return FusedFitOut(*res)


def fused_fit_launch(Y, R_inv, Sigma0, Q, Phi, X_mean0, X_cov0, max_iter,
                     learning_rate, tolerance, carry_elbo=None, carry_pat=0,
                     *, r: int, buf_size: int, patience: int = 3,
                     corrected: bool = False, structure: str = "full",
                     num_blocks: int = 1):
    """Launch K3 on CUDA tensors without synchronising: returns
    ``(X_mean, X_cov, hist)`` on the card, ``hist`` holding the ELBO
    history, the MSE history (``buf_size`` slots each) and n_iter,
    converged, diverged, pat_count, last_elbo."""
    n, _, T, _ = Y.shape
    d = 2 + 2 * r
    if d not in FUSED_DIMS:
        raise ValueError(f"K3 is built for d in {FUSED_DIMS}, got d={d}")
    if n % num_blocks != 0:
        raise ValueError(f"num_blocks={num_blocks} must divide n={n}")
    if max_iter > buf_size:
        raise ValueError("buf_size must hold max_iter history slots")
    layout = fused_fit_layout(n, T, d, num_blocks)
    if layout < 0:
        raise ValueError(f"K3 has no layout for n={n}, T={T}, d={d} within "
                         f"{SMEM_LIMIT_BYTES} bytes of shared memory")

    def f32(x):
        return x.to(device=Y.device, dtype=torch.float32).contiguous()

    Xm0, Xc0 = f32(X_mean0), f32(X_cov0)
    Xm, Xc = torch.empty_like(Xm0), torch.empty_like(Xc0)
    hist = torch.empty(2 * buf_size + 5, dtype=torch.float32,
                       device=Y.device)
    gdata = torch.empty(0 if layout & STAGED else 4 * T * n * n,
                        dtype=torch.float32, device=Y.device)
    _ext.load().fused_fit(
        f32(Y), f32(R_inv), f32(Sigma0), f32(Q), f32(Phi), Xm0, Xc0, Xm, Xc,
        hist, gdata, num_blocks, int(max_iter), int(carry_pat), patience,
        _STRUCTURE_CODES[structure], corrected, float(learning_rate),
        float(tolerance),
        float("-inf") if carry_elbo is None else float(carry_elbo))
    fused_fit_kernel.launches += 1
    return Xm, Xc, hist


def fused_fit_kernel(Y, R_inv, Sigma0, Q, Phi, X_mean0, X_cov0, max_iter,
                     learning_rate, tolerance, carry_elbo=None, carry_pat=0,
                     **kw) -> FusedFitOut:
    """Launch K3 on CUDA tensors; one readback after the launch."""
    Xm, Xc, hist = fused_fit_launch(Y, R_inv, Sigma0, Q, Phi, X_mean0,
                                    X_cov0, max_iter, learning_rate,
                                    tolerance, carry_elbo, carry_pat, **kw)
    buf = kw["buf_size"]
    with profiling.span("loop.readback"):
        h = hist.cpu()
        profiling.count(profiling.SYNCS)
    n_iter, conv, div, pat, last = h[2 * buf:].tolist()
    return FusedFitOut(X_mean=Xm, X_cov=Xc, elbo_history=h[:buf],
                       mse_history=h[buf:2 * buf], n_iter=int(n_iter),
                       converged=bool(conv), diverged=bool(div),
                       last_elbo=last, pat_count=int(pat))


fused_fit_kernel.launches = 0


def fused_fit(Y, R_inv, Sigma0, Q, Phi, X_mean0, X_cov0, max_iter,
              learning_rate, tolerance, carry_elbo=None, carry_pat=0,
              **kw) -> FusedFitOut:
    """Run the whole CAVI fit: K3 on a CUDA ``Y``, the twin on a CPU one.

    ``num_blocks=1`` is the Jacobi step; ``num_blocks>1`` runs that many
    sequential block-Gauss-Seidel phases per iteration.
    """
    run = fused_fit_kernel if _on_card(Y) else fused_fit_twin
    return run(Y, R_inv, Sigma0, Q, Phi, X_mean0, X_cov0, max_iter,
               learning_rate, tolerance, carry_elbo, carry_pat, **kw)
