"""The yardstick's table of peaks: one NVIDIA H100 SXM 80 GB, NVIDIA's
data sheet, dense rates without sparsity, at the full 700 W power limit
(run.py prints the card's own limit beside every share of a peak)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {'float32': 67e12,      # outside the tensor cores: TF32 off
         'bfloat16': 989e12}
