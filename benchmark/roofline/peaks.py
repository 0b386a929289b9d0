"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): the float32 rate outside the tensor cores
and the HBM3 rate."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and float32 operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
