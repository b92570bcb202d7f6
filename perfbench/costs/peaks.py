"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core
GPU datasheet: dense rates, without sparsity, at the 700 W limit)."""
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute
    and the memory bound."""
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
