"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): float32 outside the tensor cores, since the
configurations run float32 with TF32 off, and HBM3 bandwidth."""

F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: operations over the peak rate or
    bytes over the bandwidth, whichever is longer."""
    return max(ops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
