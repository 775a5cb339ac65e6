"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): the bf16 tensor-core rate and the HBM3 rate.  Every share
of a peak or a roofline in this benchmark is stated against them."""

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops: float, n_bytes: float) -> float:
    """The least time the chip could take for the work: the larger of its
    operations at the bf16 peak and its bytes at the HBM rate."""
    return max(flops / BF16_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S)
