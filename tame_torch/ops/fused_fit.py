"""Whole-fit kernel: the entire damped-CAVI loop in one launch
(counterpart of :mod:`tame.ops.fused_fit`).

K3 ``fused_fit`` (``csrc/fused_fit.cu``) replaces
``tame/ops/fused_fit.py::_fused_fit_kernel``.  At demo-scale configs the
unfused loop is bound by launch count, not arithmetic: one block-mode
iteration at n=15 is 15 phases of ~40 small ops each.  The kernel runs all
iterations — block phases, exact diagnostics, ELBO, stopping rule — in one
thread block with ``X_mean``/``X_cov`` resident in shared memory, so a fit
is one launch.  It is bound by the latency of one SM (few factors per
phase, phases in sequence); running many fits across SMs is later work.

Scope (checked by :func:`fused_fit_supported`): structures ``diag``,
``full``, ``block``; ``jacobi`` or ``block`` updates; exact diagnostics
every iteration; float32 weights (no ``mixed_precision``); no mask; d in
:data:`FUSED_DIMS`, the JAX envelope d <= 12 (K1, K2 and K4 also take
larger d; K3 does not); and the fit's shared
memory (:func:`fused_fit_smem_bytes`) within the 227 KB a Hopper block may
use.  At d=6 the state alone is (d + d^2) n T 4 B: 25 KB at n=15, T=10
(inside) and 168 KB at n=100, T=10 (inside with 10 blocks, outside as one
Jacobi block, whose phase scratch doubles it).

Semantics match :func:`tame_torch.inference.cavi.fit_cavi`: once the
stopping rule fires the state freezes and the history slots past the stop
stay NaN.  The plain twin :func:`fused_fit_twin` is that unfused loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tame_torch.ops import _ext
from tame_torch.ops.cholesky import _on_card

SMEM_LIMIT_BYTES = 232448  # 227 KB: the most one block may use on sm_90
# d = 2 + 2r for r = 1..5: the sizes K3 is instantiated for, as the JAX
# megakernel's d <= 12 (tame/ops/fused_fit.py, fused_fit_supported).
FUSED_DIMS = (4, 6, 8, 10, 12)
_STRUCTURE_CODES = {"diag": 0, "full": 1, "block": 2}


def fused_fit_smem_bytes(n: int, T: int, d: int, num_blocks: int) -> int:
    """Dynamic shared memory of one K3 fit; mirrors ``smem_floats`` in
    ``csrc/fused_fit.cu``."""
    r = (d - 2) // 2
    per_factor = d + d * d
    floats = (n * T * per_factor                 # X_mean, X_cov
              + (n // num_blocks) * T * per_factor  # phase scratch
              + T * (2 + 4 * r + 3 * r * r)      # global statistics
              + 5 * d * d                        # prior matrices
              + 8 * 6                            # block reduction
              + 1)                               # running flag
    return 4 * floats


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
    return fused_fit_smem_bytes(n, T, d, num_blocks) <= SMEM_LIMIT_BYTES


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


def fused_fit_kernel(Y, R_inv, Sigma0, Q, Phi, X_mean0, X_cov0, max_iter,
                     learning_rate, tolerance, carry_elbo=None, carry_pat=0,
                     *, r: int, buf_size: int, patience: int = 3,
                     corrected: bool = False, structure: str = "full",
                     num_blocks: int = 1) -> FusedFitOut:
    """Launch K3 on CUDA tensors."""
    n, _, T, _ = Y.shape
    d = 2 + 2 * r
    if d not in FUSED_DIMS:
        raise ValueError(f"K3 is built for d in {FUSED_DIMS}, got d={d}")
    if n % num_blocks != 0:
        raise ValueError(f"num_blocks={num_blocks} must divide n={n}")
    if max_iter > buf_size:
        raise ValueError("buf_size must hold max_iter history slots")
    f32 = torch.float32
    Y = Y.to(f32)
    p, q = R_inv[0, 0], R_inv[0, 1]
    y0 = Y[..., 0].contiguous()
    W0 = (p * y0 + q * Y[..., 1]).contiguous()
    W1 = (q * y0 + p * Y[..., 1]).contiguous()
    Q_inv = torch.linalg.inv(Q)
    pri = torch.stack([torch.linalg.inv(Sigma0), Q_inv, Q_inv @ Phi,
                       Phi.T @ Q_inv @ Phi, Phi]).to(f32).contiguous()
    scal = torch.stack([p, q, R_inv[0, 0] + R_inv[1, 1],
                        -torch.linalg.slogdet(R_inv)[1],
                        torch.linalg.slogdet(Sigma0)[1],
                        torch.linalg.slogdet(Q)[1]]).tolist()
    Xm0 = X_mean0.to(f32).contiguous()
    Xc0 = X_cov0.to(f32).contiguous()
    Xm, Xc = torch.empty_like(Xm0), torch.empty_like(Xc0)
    eh = torch.full((buf_size,), float("nan"), dtype=f32, device=Y.device)
    mh = torch.full_like(eh, float("nan"))
    stats = torch.zeros(5, dtype=f32, device=Y.device)
    _ext.load().fused_fit(
        W0, W1, W0.sum(1).contiguous(), W1.sum(1).contiguous(), y0, Xm0, Xc0,
        pri, Xm, Xc, eh, mh, stats, num_blocks, int(max_iter),
        int(carry_pat), patience, _STRUCTURE_CODES[structure], corrected,
        float(learning_rate), float(tolerance), *scal,
        float("-inf") if carry_elbo is None else float(carry_elbo))
    fused_fit_kernel.launches += 1
    n_iter, conv, div, pat, last = stats.tolist()
    return FusedFitOut(X_mean=Xm, X_cov=Xc, elbo_history=eh.cpu(),
                       mse_history=mh.cpu(), n_iter=int(n_iter),
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
