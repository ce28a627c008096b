"""Bytes and operations of the port's kernels and of a fit's iteration,
from shapes alone.  Each input byte is read once and each output byte
written once; multiply-adds count as two operations; everything is
float32 (4 bytes).

The kernels' counts are those of the bring-up records (their bound
column): K1 solves B systems of size d with the inverse, K2 takes B
log-determinants, K3 runs a whole fit, K4 smooths n trajectories of T
steps.
"""

from __future__ import annotations

F32 = 4


def history_buffer(max_iter: int) -> int:
    """History slots a fit returns: the next power of two >= max(max_iter,
    64)."""
    buf = 64
    while buf < max_iter:
        buf *= 2
    return buf


def k1(B: int, d: int):
    """K1, ``mu = P^-1 eta`` and ``P^-1`` for B systems: P and eta in, mu
    and the inverse out; a Cholesky factor (d^3 / 3), the inverse (2 d^3)
    and the mean (2 d^2) per system."""
    n_bytes = F32 * B * 2 * (d * d + d)
    flops = 2 * B * (d**3 / 3 + 2 * d * d + 2 * d**3)
    return n_bytes, flops


def k2(B: int, d: int):
    """K2, log det P for B systems: P in, one number out; a Cholesky factor
    per system."""
    return F32 * B * (d * d + 1), 2 * B * d**3 / 3


def fit_flops(n: int, T: int, d: int, num_blocks: int, n_iter: int) -> float:
    """A Good-SMF fit's operations: per block phase the three partner Grams
    over all n nodes, the two weight-times-means products of the block's
    rows and the block's solves with inverse; per iteration the exact
    diagnostics (dyadic means and residual sums) and the entropy's
    factors."""
    r = (d - 2) // 2
    bs = n // num_blocks
    phase = (3 * 2 * n * T * r * r + 2 * 2 * bs * n * T * r
             + 2 * bs * T * (d**3 / 3 + 2 * d**3 + 2 * d * d))
    diagnostics = n * n * T * (2 * r + 6) + 2 * n * T * d**3 / 3
    return n_iter * (num_blocks * phase + diagnostics)


def k3(n: int, T: int, d: int, num_blocks: int, n_iter: int, max_iter: int):
    """K3, one whole Good-SMF fit of ``n_iter`` iterations: Y, R^-1, three
    d x d prior matrices and the initial state in; the state, both
    histories and five stop statistics out."""
    state = n * T * (d + d * d)
    n_bytes = F32 * (2 * n * n * T + 4 + 3 * d * d + 2 * state
                     + 2 * history_buffer(max_iter) + 5)
    return n_bytes, fit_flops(n, T, d, num_blocks, n_iter)


def smoother_flops(n: int, T: int, d: int) -> float:
    """Block elimination of n trajectories: forward two d x d products, a
    factor and an inverse per step; backward three products per step."""
    return n * T * d**3 * (4 + 1 / 3 + 2) + n * (T - 1) * 6 * d**3


def k4(n: int, T: int, d: int):
    """K4: the diagonal blocks, the coupling block and the right sides in;
    means, marginal and lag-one covariances and log-determinants out."""
    n_bytes = F32 * (n * T * d * d + d * d + n * T * d + n * T * d
                     + n * T * d * d + n * (T - 1) * d * d + n)
    return n_bytes, smoother_flops(n, T, d)


def smoothed_iteration_flops(n: int, T: int, d: int,
                             num_blocks: int) -> float:
    """A smoothed-family iteration's operations: the Good-SMF iteration's
    partner statistics and products, :func:`smoother_flops` per block in
    place of the solves, and the exact diagnostics' dyadic means."""
    r = (d - 2) // 2
    bs = n // num_blocks
    phase = (3 * 2 * n * T * r * r + 2 * 2 * bs * n * T * r
             + smoother_flops(bs, T, d))
    return num_blocks * phase + n * n * T * (2 * r + 6)


def iteration(n: int, T: int, d: int, flops: float, masked: bool):
    """``(bytes per iteration, bytes per fit, operations per iteration)`` of
    a fit whatever implements it, given its kind's operations per
    unmasked iteration.  The network (both directions, and the mask as
    one bit a dyad-time) must be read once per iteration where it exceeds
    the card's L2 cache, else once per fit; so must the state.  A mask
    adds its partner contraction against the (1 + 2r + 3r^2)-column panel
    of each phase."""
    from tbench.roofline.peaks import L2_BYTES

    r = (d - 2) // 2
    data = F32 * 2 * n * n * T + (n * n * T / 8 if masked else 0)
    state = F32 * 2 * n * T * (d + d * d)
    resident = data + state <= L2_BYTES
    if masked:
        flops += 2 * n * n * T * (1 + 2 * r + 3 * r * r)
    per_iter = 0.0 if resident else data + state
    return per_iter, (data + state if resident else 0.0), flops
