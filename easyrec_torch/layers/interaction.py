"""Feature-interaction layers.

Counterpart of easyrec_tpu/layers/interaction.py: FM (:13-28).
"""

from __future__ import annotations

import torch
from torch import nn


class FM(nn.Module):
  """Second-order factorization machine over stacked fields: input
  [B, F, D] -> sum-square minus square-sum over the field axis, [B, D]
  (use_variant) or summed to [B, 1]."""

  def __init__(self, use_variant: bool = False):
    super().__init__()
    self.use_variant = use_variant

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    s = x.sum(dim=1)
    out = 0.5 * (s * s - (x * x).sum(dim=1))
    if self.use_variant:
      return out
    return out.sum(dim=-1, keepdim=True)
