"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

BF16_FLOPS_PER_S = 989e12     # bf16 / fp16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12     # HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations at
    the bf16 peak and the bytes at the HBM rate."""
    return max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
