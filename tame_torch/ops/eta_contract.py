"""The eta contraction in the (t, i, j) weight layout: ``W[t] @ bf16(Z[t])``
per time step, bf16 weights and float32 sums (counterpart of the Pallas
probe kernel ``scripts/layout_probe3.py::_eta_kernel``).

    out[t, i, r] = sum_j W[t, i, j] * bf16(Z[t, j, r])

W is (T, N, N) bf16, Z is (T, N, R) float32 and out (T, N, R) float32.  It
is the engine's ``W0 @ V`` / ``W1 @ U`` contraction (``cavi._eta_contract``)
with the weights stored time-major, so no permute copy stands between the
data and the product.  No engine calls it yet: ``scripts.layout_probe3``
measures it against the engine's own path, and its numbers decide whether
the engines take this layout.

K7 ``eta_contract`` (``csrc/eta_contract.cu``) replaces
``scripts/layout_probe3.py::_eta_kernel``.  The TPU kernel padded Z to a
(T, N, 128) bf16 copy on every call to fill the MXU's lanes; K7 reads the
caller's float32 Z in place, rounds it to bf16 as it stages it in shared
memory, and streams W once with 16-byte loads (two-byte loads when N is not
a multiple of 8), float32 FMAs on the CUDA cores: at N=2000, T=50, R=4 it
is bound by the 400 MB of W (0.120 ms at 3.35 TB/s).  Its plain twin,
:func:`eta_contract_twin`, is a float32 einsum of the bf16 values (each
product of two bf16 values is exact in float32, as in
``cavi._eta_contract``'s CPU branch); the two differ only in the order of
the sums.

Envelope: any T and N, 1 <= R <= :data:`MAX_R`.  Dispatch: a CPU tensor
takes the twin; a CUDA tensor launches K7 or raises.  Nothing falls back.
"""

from __future__ import annotations

import torch

from tame_torch.ops import _ext
from tame_torch.ops.cholesky import _on_card

MAX_R = 16  # widest panel the kernel is built for


def _check(W: torch.Tensor, Z: torch.Tensor) -> None:
    if W.dtype != torch.bfloat16 or Z.dtype != torch.float32:
        raise TypeError(f"K7 takes bf16 weights and a float32 panel, got "
                        f"{W.dtype} and {Z.dtype}")
    if (W.dim() != 3 or W.shape[1] != W.shape[2] or Z.dim() != 3
            or Z.shape[:2] != W.shape[:2]):
        raise ValueError(f"weights {tuple(W.shape)} and panel "
                         f"{tuple(Z.shape)} are not (T, N, N) and (T, N, R)")
    if not 1 <= Z.shape[2] <= MAX_R:
        raise ValueError(f"K7 is built for 1 <= R <= {MAX_R}, got "
                         f"R={Z.shape[2]}")


def eta_contract_twin(W: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K7 (same contract): the bf16 weights and ``Z``
    rounded to bf16, widened to float32, one einsum."""
    _check(W, Z)
    return torch.einsum("tij,tjr->tir", W.float(),
                        Z.to(torch.bfloat16).float())


def eta_contract_kernel(W: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Launch K7 on CUDA tensors: W (T, N, N) bf16, Z (T, N, R) float32
    -> (T, N, R) float32."""
    _check(W, Z)
    if not (W.is_cuda and Z.device == W.device):
        raise ValueError("K7 takes CUDA tensors on one device")
    out = _ext.load().eta_contract(W.contiguous(), Z.contiguous())
    eta_contract_kernel.launches += 1
    return out


eta_contract_kernel.launches = 0


def eta_contract(W: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """``W[t] @ bf16(Z[t])`` for every t, float32 out: K7 on a CUDA ``W``,
    the twin on a CPU one."""
    run = eta_contract_kernel if _on_card(W) else eta_contract_twin
    return run(W, Z)
