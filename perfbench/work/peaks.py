"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit)."""

#: f32 operations per second outside the tensor cores
F32_FLOPS = 67e12
#: HBM3 bytes per second
HBM_BYTES = 3.35e12


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    """The least time the chip could take: the larger of the bytes over the
    bandwidth and the f32 operations over the f32 rate."""
    return max(nbytes / HBM_BYTES, flops / F32_FLOPS)
