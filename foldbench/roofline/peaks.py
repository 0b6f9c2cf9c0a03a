"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates), against which a kernel's least time is counted."""

# HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer ALU operations: a quarter of the 67 TFLOP/s float32
# figure (64 INT32 lanes per SM per clock instead of 128 FP32 lanes, no
# fused multiply-add pair)
INT32_OPS_PER_S = 67e12 / 4


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth and integer operations over their peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
