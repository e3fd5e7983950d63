"""The published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet,
dense rates, at its full power limit of 700 W; a run states the card's
``power.limit`` beside every share of them)."""

PEAK_BYTES = 3.35e12    # HBM3, bytes/s
# float32 outside the tensor cores, a fused multiply-add counted as two
# (the kernels are built with --fmad=false and issue none, so for them it is
# twice their single-issue rate)
PEAK_F32 = 67e12
PEAK_F64 = 34e12        # float64 outside the tensor cores
# INT32, one operation per lane and clock: 132 SMs x 64 lanes x 1.98 GHz
PEAK_INT = 16.7e12


def bound_s(nbytes: float, flops: float = 0.0, int_ops: float = 0.0, f64: bool = False) -> float:
    """The least time a launch can take: the larger of its bytes over the
    memory rate and its operations over their pipe's rate (float and
    integer operations issue side by side, so the larger of the two)."""
    return max(nbytes / PEAK_BYTES, flops / (PEAK_F64 if f64 else PEAK_F32), int_ops / PEAK_INT)
