"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W): the yardstick of every roofline and MFU share. A
card set below 700 W (``power.limit``) runs slower under load; the run
prints the limit beside the shares."""

F32_FLOPS = 67e12  # float32 outside the tensor cores (TF32 off)
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12


def least_seconds(flops: float, bytes_moved: float, flops_peak: float = F32_FLOPS) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / flops_peak, bytes_moved / HBM_BYTES)
