"""Feature-interaction layers.

Counterpart of easyrec_tpu/layers/interaction.py: FM (:13-28), CrossNet
(:31-45) and DotInteraction (:73-87). CrossNet keeps flax's parameter
names and shapes (`w_<i>` [d, 1], `b_<i>` [d]), so convert.py carries
them as they are.
"""

from __future__ import annotations

import math
from typing import Optional

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


class CrossNet(nn.Module):
  """DCN-v1 cross layers: x_{l+1} = x0 * (x_l w_l) + b_l + x_l, each w_l
  [d, 1] glorot-uniform (flax's, over that shape) and b_l zero."""

  def __init__(self, dim: int, num_layers: int = 3,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    self.num_layers = num_layers
    limit = math.sqrt(6.0 / (dim + 1))
    for i in range(num_layers):
      w = torch.empty(dim, 1)
      with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)
      self.register_parameter('w_%d' % i, nn.Parameter(w.to(device)))
      self.register_parameter('b_%d' % i, nn.Parameter(
          torch.zeros(dim, device=device)))

  def forward(self, x0: torch.Tensor) -> torch.Tensor:
    x = x0
    for i in range(self.num_layers):
      xw = x @ getattr(self, 'w_%d' % i)             # [B, 1]
      x = x0 * xw + getattr(self, 'b_%d' % i) + x
    return x


class DotInteraction(nn.Module):
  """DLRM's pairwise dot interaction over stacked fields: input [B, F, D]
  -> the upper triangle of X X^T, [B, F(F-1)/2] (with the diagonal,
  [B, F(F+1)/2], under self_interaction), row by row as
  jnp.triu_indices orders it."""

  def __init__(self, self_interaction: bool = False):
    super().__init__()
    self.self_interaction = self_interaction

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    inter = torch.bmm(x, x.transpose(1, 2))           # [B, F, F]
    f = x.shape[1]
    rows, cols = torch.triu_indices(
        f, f, offset=0 if self.self_interaction else 1, device=x.device)
    return inter[:, rows, cols]
