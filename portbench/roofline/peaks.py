"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit).  No 32-bit integer rate is published; integer work is held
to the float32 rate outside the tensor cores, which no integer pipe of the
card exceeds, so a least time from it is a true lower bound."""

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_OPS_PER_S = 67e12  # float32, non-tensor


def least_seconds(nbytes: float, nops: float) -> float:
    """The larger of the time to move the bytes and to do the operations."""
    return max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_OPS_PER_S)
