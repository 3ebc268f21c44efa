"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit): the yardstick of every roofline and MFU figure."""

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def least_seconds(ops: float, nbytes: float, peak_ops: float = BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory's."""
    return max(ops / peak_ops, nbytes / HBM_BYTES)
