"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
full 700 W power limit). A share of a peak is stated against these, with
the card's power limit beside it."""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12            # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
