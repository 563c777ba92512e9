"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data
sheet, dense rates without sparsity, at the full 700 W power limit.
A card set below 700 W reaches less: every result names the card's
``power.limit`` beside these peaks."""

BF16_FLOPS = 989e12      # tensor cores, bf16 / fp16
HBM_BYTES_PER_S = 3.35e12
POWER_LIMIT_W = 700.0
