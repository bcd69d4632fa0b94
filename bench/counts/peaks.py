"""Published peaks of one NVIDIA H100 SXM5 (80 GB HBM3), from NVIDIA's data
sheet: dense rates without sparsity, at the 700 W power limit.  A card set
below that limit runs slower under load; every run prints the card's limit
beside its numbers."""

#: bf16 tensor-core FLOP/s, dense
BF16_FLOPS = 989.4e12
#: HBM3 bytes/s
HBM_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_S)
