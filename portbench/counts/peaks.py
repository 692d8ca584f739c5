"""Published peaks of one NVIDIA H100 SXM (data sheet; dense, at the full
700 W power limit)."""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the bf16 tensor-core peak and the bytes at the HBM peak."""
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES)
