"""Int8 packed-mask panel contraction: ``(mask rows) @ Z`` at 1 byte per
entry (counterpart of :mod:`tame.ops.masked_contract`).

Missing-data fits contract the (n, n, T) 0/1 observation mask against
per-(node, time) feature panels every iteration (masked partner counts,
sums and Grams: ``cavi._masked_obs_precision``,
``cavi._masked_residual_stats``).  :func:`pack_mask` stores the mask once
as int8, block-major ``(num_blocks, T, bs_pad, n_pad)`` as the JAX
package lays it out, so a block Gauss-Seidel phase reads one stripe and a
full-mask contraction loops the stripes.  The port's padding: rows are
not padded (``bs_pad = bs``; the kernel masks the ragged row tile), and
partners are padded to a multiple of 16 so every mask row starts on a
16-byte boundary for the kernel's 16-byte loads.  Padded entries are zero.

K5 ``masked_contract`` (``csrc/masked_contract.cu``) replaces
``tame/ops/masked_contract.py::_kernel`` (via ``packed_rows_contract``).
It reads the caller's float32 ``(n, T, K)`` panel in place and rounds it
to bf16 as it stages it, instead of padding it to a ``(T, n_pad, 128)``
bf16 copy on every call (the copy the JAX docstring names as why the TPU
kernel lost), and writes ``(bs_pad, T, K)`` directly, so nothing is
transposed afterwards.  Each output's arithmetic is fixed (four
partner-quarter accumulators, each fed the same ``mma.sync`` steps in the
same order, summed ((q0 + q1) + q2) + q3), so its bits do not depend on
the schedule: a cluster of four blocks per (128-row tile, t, 64-column
tile), block rank q running quarter q of every 128-partner chunk, fed by a
ring of ``cp.async`` stages (:func:`launch_layout` mirrors the grid).
What bounds it and what its design does about it: see the source's note.
Its plain twin,
:func:`packed_rows_contract_twin`, is the same function in f32 PyTorch.

Dispatch: a CPU tensor takes the twin; a CUDA tensor launches K5 or
raises.  Nothing falls back.
"""

from __future__ import annotations

import torch

from tame_torch.ops import _ext
from tame_torch.ops.cholesky import _on_card

COL_ALIGN = 16  # partners per 16-byte int8 load
QUARTERS = 4    # blocks per cluster, one per partner quarter
ROW_TILE = 128  # mask rows per block
COL_TILE = 64   # panel columns per block
STAGES = 3      # raw steps in the cp.async ring
MASK_PITCH = 48   # bytes per raw mask row (32 partners + pad)
PANEL_PITCH = 68  # floats per raw panel row (64 columns + pad)
FRAG_PITCH = 80   # bytes per bf16 fragment-tile row (32 partners + pad)
MAX_SMEM_BYTES = 232448  # 227 KB per block on sm_90


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_mask(mask: torch.Tensor, num_blocks: int) -> torch.Tensor:
    """Pack an (n, n, T) 0/1 observation mask into the kernel layout
    ``(num_blocks, T, bs_pad, n_pad) int8`` (once, at fit start), on the
    mask's device."""
    n, _, T = mask.shape
    if n % num_blocks:
        raise ValueError(f"num_blocks={num_blocks} must divide n={n}")
    bs = n // num_blocks
    out = torch.zeros(num_blocks, T, bs, _pad_to(n, COL_ALIGN),
                      dtype=torch.int8, device=mask.device)
    m8 = mask.to(torch.int8).permute(2, 0, 1)                # (T, n, n)
    out[..., :n] = m8.reshape(T, num_blocks, bs, n).transpose(0, 1)
    return out


def pack_rows(mask: torch.Tensor, rows) -> list:
    """Pack row slices of an (m, n, T) 0/1 mask as K5 stripes: one
    ``(T, len, n_pad) int8`` stripe per slice of ``rows`` (any lengths, an
    empty one included), laid out as an entry of :func:`pack_mask`, on
    the mask's device.  The stripes of ``num_blocks`` equal slices that
    tile n are :func:`pack_mask`'s blocks."""
    n_pad = _pad_to(mask.shape[1], COL_ALIGN)
    stripes = []
    for sl in rows:
        part = mask[sl].to(torch.int8).permute(2, 0, 1)      # (T, len, n)
        out = torch.zeros(part.shape[:2] + (n_pad,), dtype=torch.int8,
                          device=mask.device)
        out[..., :part.shape[2]] = part
        stripes.append(out)
    return stripes


def _check_stripe(Mp: torch.Tensor, Z: torch.Tensor) -> None:
    T, _, n_pad = Mp.shape
    n, TZ, _ = Z.shape
    if Mp.dtype != torch.int8 or Z.dtype != torch.float32:
        raise TypeError(f"K5 takes an int8 mask and a float32 panel, got "
                        f"{Mp.dtype} and {Z.dtype}")
    if TZ != T or n > n_pad or n_pad % COL_ALIGN:
        raise ValueError(f"mask stripe {tuple(Mp.shape)} does not fit panel "
                         f"{tuple(Z.shape)}")


def smem_bytes() -> int:
    """K5's dynamic shared memory per block (``smem_bytes`` in the source):
    the ring of raw (mask, panel) steps of one partner quarter, which the
    quarter sums reuse, and two bf16 fragment tiles."""
    return (STAGES * (ROW_TILE * MASK_PITCH + 32 * PANEL_PITCH * 4)
            + 2 * (ROW_TILE + COL_TILE) * FRAG_PITCH)


def launch_layout(T: int, bs_pad: int, K: int) -> dict:
    """K5's launch for one stripe: the grid (partner quarter, 128-row tile,
    t and 64-column tile), clusters of :data:`QUARTERS` along its first
    axis, and the block's shared memory."""
    return {"grid": (QUARTERS, -(-bs_pad // ROW_TILE),
                     T * -(-K // COL_TILE)),
            "cluster": QUARTERS, "smem_bytes": smem_bytes()}


def packed_rows_contract_twin(Mp: torch.Tensor,
                              Z: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K5 (same contract): the int8 mask as float
    times ``Z`` rounded to bf16 and back, summed in float32."""
    _check_stripe(Mp, Z)
    n = Z.shape[0]
    Zb = Z.to(torch.bfloat16).float()
    return torch.einsum("tij,jtk->itk", Mp[..., :n].float(), Zb)


def packed_rows_contract_kernel(Mp: torch.Tensor,
                                Z: torch.Tensor) -> torch.Tensor:
    """Launch K5 on CUDA tensors: Mp (T, bs_pad, n_pad) int8, Z (n, T, K)
    float32 -> (bs_pad, T, K) float32."""
    _check_stripe(Mp, Z)
    if Z.device != Mp.device:
        raise ValueError("all inputs must be on one device")
    if launch_layout(Mp.shape[0], Mp.shape[1], Z.shape[2])["grid"][2] > 65535:
        raise ValueError("K5 takes T * ceil(K / 64) <= 65535")
    out = _ext.load().masked_contract(Mp.contiguous(), Z.contiguous())
    packed_rows_contract_kernel.launches += 1
    return out


packed_rows_contract_kernel.launches = 0


def packed_rows_contract(Mp: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Contract one packed block stripe (an entry of :func:`pack_mask`)
    against a feature panel: ``out[i, t] = sum_j M[t, i, j] bf16(Z[j, t])``
    of shape ``(bs_pad, T, K)`` (callers slice the true rows).  K5 on a
    CUDA mask, the twin on a CPU one."""
    run = packed_rows_contract_kernel if _on_card(Mp) \
        else packed_rows_contract_twin
    return run(Mp, Z)
