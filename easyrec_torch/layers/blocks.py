"""Sequence encoder blocks.

Counterpart of easyrec_tpu/layers/blocks.py: TextCNN (:85-113), the
text_cnn sequence combiner's encoder. Its convolutions are flax's nn.Conv
with VALID padding; a flax Conv kernel [W, Cin, Cout] is nn.Conv1d's
weight [Cout, Cin, W] with its axes reversed, so convert.py carries it by
the transpose it gives every kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

# stddev of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


class TextCNN(nn.Module):
  """seq [B, L, D] (times mask [B, L] where given) -> parallel 1-D
  convolutions of widths `filter_sizes`, relu, a max over time,
  concatenated: [B, sum(num_filters)]."""

  def __init__(self, in_features: int,
               filter_sizes: Sequence[int] = (2, 3, 4),
               num_filters: Sequence[int] = (128, 64, 64),
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    self.n_convs = 0
    for i, (width, filters) in enumerate(zip(filter_sizes, num_filters)):
      conv = nn.Conv1d(in_features, int(filters), int(width), device=device)
      # flax's lecun_normal over fan_in = width * Cin, bias 0
      std = (1.0 / (int(width) * in_features)) ** 0.5 / _TRUNC_STD
      with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
        conv.weight.mul_(std)
        conv.bias.zero_()
      self.add_module('conv_%d' % i, conv)
      self.n_convs += 1
    self.out_features = sum(int(f) for f in num_filters[:self.n_convs])

  def forward(self, seq: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is not None:
      seq = seq * mask[:, :, None]
    x = seq.transpose(1, 2)                          # [B, D, L]
    pools = [F.relu(getattr(self, 'conv_%d' % i)(x)).amax(dim=2)
             for i in range(self.n_convs)]
    return torch.cat(pools, dim=-1)
