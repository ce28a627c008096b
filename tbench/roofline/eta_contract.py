"""K7's work from shapes: one launch contracts ``m`` rows of the
time-major dyad weights, stored in float32 or bf16, against the float32
``(n, T, R)`` panel and writes the float32 ``(m, T, R)`` sums; its
``2 m n T R`` operations are float32 FMAs on the CUDA cores, so its bound
takes the float32 peak.  An iteration of a block step runs two launches a
block (``W0 @ V`` and ``W1 @ U`` of the block's stripe, ``R = r``); the
stats diagnostics add one launch over the whole matrix against ``[V | U]``,
``R = 2r``, or ``4r`` where the weights are bf16 (the panel's two bf16
halves side by side)."""

from __future__ import annotations

from tbench.roofline.counts import F32
from tbench.roofline.peaks import bound_s as card_bound_s

BF16 = 2


def k7(m: int, n: int, T: int, R: int, w_bytes: int):
    """``(bytes, operations)`` of one launch: the weights' rows at their
    stored width, the panel and the sums, each once."""
    n_bytes = w_bytes * T * m * n + F32 * n * T * R + F32 * m * T * R
    return n_bytes, 2 * m * n * T * R


def bound_s(m: int, n: int, T: int, R: int, w_bytes: int) -> float:
    """The least time of one launch (bytes or float32 operations)."""
    return card_bound_s(*k7(m, n, T, R, w_bytes))


def iteration_launches(n: int, T: int, r: int, fit: dict):
    """``(m, R)`` of each K7 launch of one iteration of a block-step fit
    with the cell's ``fit`` settings."""
    blocks = fit["num_blocks"]
    out = [(n // blocks, r)] * (2 * blocks)
    if fit["diag_mode"] == "stats":
        out.append((n, 4 * r if fit["mixed_precision"] else 2 * r))
    return out


def iteration_bound_s(n: int, T: int, r: int, fit: dict) -> float:
    """The least time of one iteration's K7 launches."""
    w_bytes = BF16 if fit["mixed_precision"] else F32
    return sum(bound_s(m, n, T, R, w_bytes)
               for m, R in iteration_launches(n, T, r, fit))
