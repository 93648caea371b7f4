"""Published peaks of the card, for roofline shares (NVIDIA's H100 SXM
data sheet, at its full 700 W power limit)."""

#: HBM3 bandwidth of one H100 SXM, bytes a second
H100_HBM_BYTES_S = 3.35e12
