"""One-pass dual dyadic contraction: ``y0 @ Z`` and ``y0' @ Z`` together
(counterpart of :mod:`tame.ops.dual_contract`).

Both products of one observation-sized ``(T, n, n)`` tensor from a single
read of it.  No engine calls it: the reciprocity identity in
``cavi._data_mean_cross_terms`` recovers the stats diagnostics' two cross
terms from one ``W0 @ [V | U]`` product instead (see the JAX module's
history note); it stays for workloads that need row and column products of
a tensor without that structure.

Layout (:func:`pad_data`, once per fit): bf16 ``(T, n, cols_pad)`` with
the columns padded with zeros to a multiple of 8, so each row starts on a
16-byte boundary for the kernel's 16-byte loads.  Rows are not padded.

K6 ``dual_contract`` (``csrc/dual_contract.cu``) replaces
``tame/ops/dual_contract.py::_dual_kernel`` (via ``dual_contract_padded``).
The TPU kernel carries the column sums in its output block across
sequential grid steps; Hopper blocks run in no order, so K6 adds each row
tile's column partials into a zeroed float32 output with ``atomicAdd``:
``ceil(n / 128)`` partial sums per entry, added in an order that changes
from run to run, so results differ between runs at float32 rounding
(~1e-6 relative at n=2000).  Its plain twin, :func:`dual_contract_twin`,
is the bf16-rounded reference of ``tests/test_inference.py``: two float32
einsums.

Dispatch: a CPU tensor takes the twin; a CUDA tensor launches K6 or
raises.  Nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tame_torch.ops import _ext
from tame_torch.ops.cholesky import _on_card

COL_ALIGN = 8   # bf16 values per 16-byte load
MAX_M = 16      # widest panel the kernel is built for


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_data(y0: torch.Tensor) -> torch.Tensor:
    """A ``(T, n, n)`` data tensor in the kernel's bf16 layout
    ``(T, n, cols_pad)``, on its device."""
    T, n, _ = y0.shape
    Wp = torch.zeros(T, n, _pad_to(n, COL_ALIGN), dtype=torch.bfloat16,
                     device=y0.device)
    Wp[..., :n] = y0
    return Wp


def _check(Wp: torch.Tensor, Z: torch.Tensor) -> None:
    T, n, cols_pad = Wp.shape
    if Wp.dtype != torch.bfloat16 or Z.dtype != torch.float32:
        raise TypeError(f"K6 takes bf16 data and a float32 panel, got "
                        f"{Wp.dtype} and {Z.dtype}")
    if Z.shape[:2] != (T, n) or cols_pad < n or cols_pad % COL_ALIGN:
        raise ValueError(f"data {tuple(Wp.shape)} does not fit panel "
                         f"{tuple(Z.shape)}")


def dual_contract_twin(Wp: torch.Tensor, Z: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K6 (same contract): the bf16 data and ``Z``
    rounded to bf16, then two float32 einsums."""
    _check(Wp, Z)
    n = Wp.shape[1]
    W = Wp[..., :n].float()
    Zb = Z.to(torch.bfloat16).float()
    return (torch.einsum("tij,tjm->tim", W, Zb),
            torch.einsum("tij,tim->tjm", W, Zb))


def dual_contract_kernel(Wp: torch.Tensor, Z: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6 on CUDA tensors: Wp (T, n, cols_pad) bf16, Z (T, n, m)
    float32 with m <= 16 -> (row, col), each (T, n, m) float32."""
    _check(Wp, Z)
    if Z.shape[-1] > MAX_M:
        raise ValueError(f"K6 is built for m <= {MAX_M}, got {Z.shape[-1]}")
    if Z.device != Wp.device:
        raise ValueError("all inputs must be on one device")
    row, col = _ext.load().dual_contract(Wp.contiguous(), Z.contiguous())
    dual_contract_kernel.launches += 1
    return row, col


dual_contract_kernel.launches = 0


def dual_contract_padded(Wp: torch.Tensor, Z: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(row, col) = (W Z, W' Z)`` per time step against data already in
    the :func:`pad_data` layout: K6 on CUDA tensors, the twin on CPU
    ones."""
    run = dual_contract_kernel if _on_card(Wp) else dual_contract_twin
    return run(Wp, Z)


def dual_contract(y0: torch.Tensor, Z: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convenience wrapper: :func:`pad_data` then
    :func:`dual_contract_padded`."""
    return dual_contract_padded(pad_data(y0), Z)
