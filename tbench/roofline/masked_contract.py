"""K5's work from shapes: one launch contracts an int8 mask stripe of
``bs`` rows (partners padded to a multiple of 16) against the float32
``(n, T, K)`` panel, which it reads and rounds to bf16 as it stages it,
and writes the float32 ``(bs, T, K)`` sums; its ``2 bs n T K``
operations run on the tensor cores in bf16, so its bound takes their
peak rate.  A masked Good-SMF iteration runs ``num_blocks`` stripes
against the step's (1 + 2r + 3r^2)-column partner panel and
``num_blocks`` against the stats diagnostics' (4 + 5r + 2r^2)-column
moment panel, which goes in as two bf16 halves side by side (twice the
columns)."""

from __future__ import annotations

from tbench.roofline.counts import F32
from tbench.roofline.peaks import HBM_BYTES_PER_S

BF16_TENSOR_FLOPS = 989e12  # dense bf16 on the tensor cores (H100 SXM)
COL_ALIGN = 16              # partners per 16-byte int8 load


def k5(bs: int, n: int, T: int, K: int):
    """``(bytes, operations)`` of one launch."""
    n_pad = -(-n // COL_ALIGN) * COL_ALIGN
    n_bytes = T * bs * n_pad + F32 * n * T * K + F32 * bs * T * K
    return n_bytes, 2 * bs * n * T * K


def bound_s(bs: int, n: int, T: int, K: int) -> float:
    """The least time of one launch: its bytes over the memory rate or its
    operations over the bf16 tensor rate, whichever is larger."""
    n_bytes, flops = k5(bs, n, T, K)
    return max(n_bytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS)


def panel_widths(r: int):
    """The panels' column counts, each taken by ``num_blocks`` launches an
    iteration: the step's partner panel and the diagnostics' moment panel
    in its two halves."""
    return 1 + 2 * r + 3 * r * r, 2 * (4 + 5 * r + 2 * r * r)
