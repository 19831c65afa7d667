"""DIN target attention.

Counterpart of easyrec_tpu/layers/attention.py DinAttention (:21-60) with
its softmax normaliser: an MLP scores each history step from
[q, h, q-h, q*h], padded steps are masked to -1e9 before the softmax, rows
whose mask is empty get zero weights after it, and the weighted sum of the
history is the output. The score MLP is a plain DNN (no BatchNorm) whose
last layer is linear, named att_dnn as in the flax tree.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from easyrec_torch.layers.dnn import DNN

_NEG_INF = -1e9


class DinAttention(nn.Module):
  """query [B, D], keys [B, L, D], mask [B, L] -> [B, D]."""

  def __init__(self, dim: int, attention_dims: Sequence[int] = (32, 16),
               activation: str = 'relu',
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    self.att_dnn = DNN(4 * dim, tuple(attention_dims) + (1,),
                       activation=activation, use_bn=False,
                       use_final_activation=False, generator=generator,
                       device=device)

  def forward(self, query: torch.Tensor, keys: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    q = query[:, None, :].expand_as(keys)
    att_in = torch.cat([q, keys, q - keys, q * keys], dim=-1)
    scores = self.att_dnn(att_in)[..., 0]                      # [B, L]
    scores = torch.where(mask > 0, scores,
                         torch.full_like(scores, _NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    weights = weights * (mask.sum(dim=-1, keepdim=True) > 0)
    return torch.einsum('bl,bld->bd', weights, keys)
