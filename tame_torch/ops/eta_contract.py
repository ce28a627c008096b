"""The eta contraction of time-major dyad weights: ``W[t] @ z(Z[:, t])`` per
time step, float32 sums (counterpart of the Pallas probe kernel
``scripts/layout_probe3.py::_eta_kernel``).

    out[i, t, k] = sum_j W[t, i, j] * z(Z[j, t, k])

W is (T, m, n) float32 or bf16: m rows of the (T, n, n) weights the
engines store time-major (``cavi.TimeMajorWeights``), partners at unit
stride, rows and time steps at any stride, so a block's stripe of rows is
read in place.  Z is the caller's (n, T, R) float32 panel at any strides
(e.g. the state's ``U`` or ``V`` columns) and out the (m, T, R) float32
layout the engines assemble from.  ``z`` rounds Z to bf16 for bf16
weights, as the JAX package's ``preferred_element_type=float32`` products
do, and leaves float32 weights' panels unrounded: a float32 fit stays
float32.  It is the engines' ``W0 @ V`` / ``W1 @ U`` contraction
(``cavi._eta_contract``): the block steps' stripes, the Jacobi step, the
stats diagnostics' ``W0 @ [V | U]`` halves and the seq sweep's rows.

K7 ``eta_contract`` (``csrc/eta_contract.cu``) replaces
``scripts/layout_probe3.py::_eta_kernel``.  The TPU kernel padded Z to a
(T, N, 128) bf16 copy on every call to fill the MXU's lanes; K7 reads the
caller's panel in place, rounds it (bf16 weights) as it stages it in
shared memory, and streams W once with 16-byte loads (one element at a
time when a row is not 16-byte aligned), float32 FMAs on the CUDA cores:
a 125-row stripe at n=2000, T=50, R=4 is bound by its 25 MB of bf16
weights (8.0 us at 3.35 TB/s; 50 MB, 15.4 us in float32).  Its plain
twin, :func:`eta_contract_twin`, is one float32 ``bmm`` of the same values
(each product of two bf16 values is exact in float32); the two differ only
in the order of the sums.

Envelope: any T, m and n, 1 <= R <= :data:`MAX_R` (4r at the engines'
largest r, 23, where K1 and K2 stop at d = 48); the twin
also takes float64 weights and panel (the CPU's float64 reference fits).
Dispatch: a CPU tensor takes the twin; a CUDA tensor launches K7 or
raises.  Nothing falls back.
"""

from __future__ import annotations

import torch

from tame_torch.ops import _ext
from tame_torch.ops.cholesky import _on_card

MAX_R = 92  # widest panel: the stats diagnostics' 4r at r = 23 (d = 48)
# the panel's dtype for each weights' dtype K7 takes
_PANELS = {torch.bfloat16: torch.float32, torch.float32: torch.float32}


def _check(W: torch.Tensor, Z: torch.Tensor, panels=_PANELS) -> None:
    if panels.get(W.dtype) != Z.dtype:
        raise TypeError(f"K7 takes bf16 or float32 weights and a float32 "
                        f"panel, got {W.dtype} and {Z.dtype}")
    if (W.dim() != 3 or Z.dim() != 3 or Z.shape[0] != W.shape[2]
            or Z.shape[1] != W.shape[0]):
        raise ValueError(f"weights {tuple(W.shape)} and panel "
                         f"{tuple(Z.shape)} are not (T, m, n) and (n, T, R)")
    if not 1 <= Z.shape[2] <= MAX_R:
        raise ValueError(f"K7 is built for 1 <= R <= {MAX_R}, got "
                         f"R={Z.shape[2]}")


def eta_contract_twin(W: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K7 (same contract): bf16 weights widened to
    float32 against ``Z`` rounded to bf16 and back, or float32 (float64)
    weights against ``Z``; one float32 (float64) ``bmm``, (m, T, R) out."""
    _check(W, Z, {**_PANELS, torch.float64: torch.float64})
    if W.dtype == torch.bfloat16:
        W, Z = W.float(), Z.to(torch.bfloat16).float()
    return torch.bmm(W, Z.transpose(0, 1)).transpose(0, 1)


def eta_contract_kernel(W: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Launch K7 on CUDA tensors: W (T, m, n) bf16 or float32 with its
    partners at unit stride, Z (n, T, R) float32 -> (m, T, R) float32."""
    _check(W, Z)
    if not (W.is_cuda and Z.device == W.device):
        raise ValueError("K7 takes CUDA tensors on one device")
    if W.shape[2] > 1 and W.stride(2) != 1:
        raise ValueError("K7 reads the weights' partners at unit stride")
    out = _ext.load().eta_contract(W, Z)
    eta_contract_kernel.launches += 1
    return out


eta_contract_kernel.launches = 0


def eta_contract(W: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """``out[i, t] = W[t, i] @ z(Z[:, t])`` for every row and time step,
    float32 (m, T, R): K7 on a CUDA ``W``, the twin on a CPU one."""
    run = eta_contract_kernel if _on_card(W) else eta_contract_twin
    return run(W, Z)
