"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12       # device memory
F32_FLOPS = 67e12               # float32 outside the tensor cores
L2_BYTES = 50 * 2**20           # on-chip L2 cache


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
