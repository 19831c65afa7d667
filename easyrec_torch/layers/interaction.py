"""Feature-interaction layers.

Counterpart of easyrec_tpu/layers/interaction.py: FM (:13-28), CrossNet
(:31-45), CrossNetV2 (:48-70), DotInteraction (:73-87) and CIN (:90-110).
CrossNet and CIN keep flax's parameter names and shapes (`w_<i>` [d, 1],
`b_<i>` [d]; CIN's `w_<i>` [F0 * Fk, H]), so convert.py carries them as
they are; CrossNetV2's layers are Dense modules named as flax names them
(`w_<i>`, or `u_<i>` and `v_<i>` when low-rank).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from easyrec_torch.layers.dnn import Dense, flax_init


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


class CrossNetV2(nn.Module):
  """DCN-v2 cross layers: x_{l+1} = x0 * (W x_l + b) + x_l, W low-rank
  (u_<i> then v_<i>) when projection_dim > 0. Pass `x` to start from a
  state other than x0: the backbone's recurrent Cross feeds [x0, x_l]
  pairs through one shared step."""

  def __init__(self, dim: int, num_layers: int = 3, projection_dim: int = 0,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.num_layers = num_layers
    self.low_rank = projection_dim > 0
    for i in range(num_layers):
      if self.low_rank:
        self.add_module('u_%d' % i, Dense(dim, projection_dim,
                                          use_bias=False, **kw))
        self.add_module('v_%d' % i, Dense(projection_dim, dim, **kw))
      else:
        self.add_module('w_%d' % i, Dense(dim, dim, **kw))

  def forward(self, x0: torch.Tensor,
              x: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x is None:
      x = x0
    for i in range(self.num_layers):
      if self.low_rank:
        wx = getattr(self, 'v_%d' % i)(getattr(self, 'u_%d' % i)(x))
      else:
        wx = getattr(self, 'w_%d' % i)(x)
      x = x0 * wx + x
    return x


class CIN(nn.Module):
  """xDeepFM's Compressed Interaction Network: x [B, F0, D]; each layer
  compresses the outer product of x with the previous map along the field
  axes by w_<i> [F0 * Fk, H] (glorot-uniform) and sum-pools it over D;
  the pools concatenate, [B, sum(H)]."""

  def __init__(self, num_fields: int,
               hidden_feature_sizes: Sequence[int] = (128, 128),
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    self.sizes = tuple(int(h) for h in hidden_feature_sizes)
    fk = num_fields
    for i, h in enumerate(self.sizes):
      self.register_parameter('w_%d' % i, nn.Parameter(flax_init(
          (num_fields * fk, h), 'glorot_uniform', generator).to(device)))
      fk = h
    self.out_features = sum(self.sizes)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, f0, d = x.shape
    xk = x
    outputs = []
    for i in range(len(self.sizes)):
      z = torch.einsum('bfd,bgd->bfgd', x, xk).reshape(b, -1, d)
      xk = torch.einsum('bmd,mh->bhd', z, getattr(self, 'w_%d' % i))
      outputs.append(xk.sum(dim=-1))
    return torch.cat(outputs, dim=-1)
