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
sequential grid steps; Hopper blocks run in no order, so K6 gives each time
step a cluster of :data:`CLUSTER` blocks, each owning a stripe of 64-row
tiles, and sums the column partials of each 128-column chunk over the
cluster's blocks in rank order through distributed shared memory.  Both
products run on the tensor cores from one staged bf16 tile; no atomics, so
a launch gives the same bits every time.  A launch takes up to
:data:`SLICE` columns of ``Z``; the wrapper launches once per slice, so any
``m`` is taken (``W`` is read once per slice).  :func:`launch_layout`
mirrors the kernel's grid, cluster and shared memory, which grows with
``n``; the wrapper refuses an ``n`` whose block would exceed 227 KB.  Its
plain twin, :func:`dual_contract_twin`, is the bf16-rounded reference of
``tests/test_inference.py``: two float32 einsums.

Dispatch: a CPU tensor takes the twin; a CUDA tensor launches K6 or
raises.  Nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tame_torch.ops import _ext
from tame_torch.ops.cholesky import _on_card

COL_ALIGN = 8   # bf16 values per 16-byte load
SLICE = 16      # columns of Z per launch
CLUSTER = 8     # blocks per time step
ROW_TILE = 64   # rows per staged tile
CHUNK = 128     # columns per staged tile
STAGES = 3      # depth of the tile ring
MAX_SMEM_BYTES = 232448  # 227 KB per block on sm_90


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


def slices(m: int) -> list:
    """``(k0, width)`` of each launch over a panel of ``m`` columns."""
    return [(k0, min(SLICE, m - k0)) for k0 in range(0, m, SLICE)]


def smem_bytes(n: int, width: int) -> int:
    """Dynamic shared memory of one K6 block at ``n`` for a slice of
    ``width`` columns (``tame_dual_contract_smem_bytes``): the tile ring,
    two chunks' and the stripe's bf16 Z rows, two chunks' column partials
    and the stripe's float32 row sums."""
    mp = 8 if width <= 8 else 16
    zp = 24 if mp == 16 else 8   # bf16 per staged Z row
    rows = -(-(-(-n // ROW_TILE)) // CLUSTER) * ROW_TILE
    return (STAGES * ROW_TILE * CHUNK * 2 + 2 * CHUNK * zp * 2
            + rows * zp * 2 + 2 * CHUNK * mp * 4 + rows * 16 * 4)


def launch_layout(T: int, n: int, m: int) -> dict:
    """K6's launches for ``(T, n, m)``: per slice a grid of
    ``(CLUSTER, T)`` blocks in clusters of ``CLUSTER`` and the block's
    shared memory."""
    return {"grid": (CLUSTER, T), "cluster": CLUSTER,
            "slices": slices(m),
            "smem_bytes": [smem_bytes(n, w) for _, w in slices(m)]}


def _check_launch(T: int, n: int, m: int) -> None:
    if T > 65535:
        raise ValueError(f"K6 takes T <= 65535, got {T}")
    if m and max(launch_layout(T, n, m)["smem_bytes"]) > MAX_SMEM_BYTES:
        raise ValueError(f"K6 at n={n} needs more than the {MAX_SMEM_BYTES}"
                         f" bytes of shared memory a block may use")


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
    """Launch K6 on CUDA tensors, once per :data:`SLICE` columns of ``Z``:
    Wp (T, n, cols_pad) bf16, Z (T, n, m) float32 -> (row, col), each
    (T, n, m) float32."""
    _check(Wp, Z)
    if Z.device != Wp.device:
        raise ValueError("all inputs must be on one device")
    _check_launch(*Z.shape)
    Wp, Z = Wp.contiguous(), Z.contiguous()
    row, col = torch.empty_like(Z), torch.empty_like(Z)
    ext = _ext.load()
    for k0, _ in slices(Z.shape[-1]):
        ext.dual_contract(Wp, Z, row, col, k0)
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
