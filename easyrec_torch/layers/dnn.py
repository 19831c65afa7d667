"""Dense tower: Dense(+BatchNorm)(+activation) per layer.

Counterpart of easyrec_tpu/layers/dnn.py (DNN, :55-100), with the flax
defaults it relies on carried over exactly:
  - Dense kernels start from flax's default lecun_normal (truncated normal,
    stddev 1/sqrt(fan_in) before truncation at two deviations), biases 0;
  - BatchNorm is flax's: batch statistics with the fast variance
    E[x^2] - E[x]^2 clipped at 0, eps 1e-5, and running averages with
    momentum 0.99 (torch's 0.01) updated with that BIASED variance — so it
    is written here rather than taken from torch.nn.BatchNorm1d, which
    tracks the unbiased one.
Submodule names follow the flax parameter tree (dense_<i>, bn_<i>) so
`convert.py` maps the two one to one.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

# stddev of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def get_activation(name: str) -> Callable:
  """Reference activation names (incl. tf.nn.*) -> torch functions."""
  key = (name or 'relu').lower().split('.')[-1]
  table = {
      'relu': F.relu,
      'relu6': F.relu6,
      'gelu': lambda x: F.gelu(x, approximate='tanh'),
      'swish': F.silu,
      'silu': F.silu,
      'sigmoid': torch.sigmoid,
      'tanh': torch.tanh,
      'elu': F.elu,
      'selu': F.selu,
      'softplus': F.softplus,
      'leaky_relu': lambda x: F.leaky_relu(x, 0.01),
      'identity': lambda x: x,
      'linear': lambda x: x,
      'none': lambda x: x,
  }
  if key not in table:
    raise NotImplementedError('activation %r is not ported' % name)
  return table[key]


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
  """flax's default Dense kernel init on a torch [out, in] weight."""
  fan_in = weight.shape[1]
  std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
  with torch.no_grad():
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.mul_(std)
  return weight


class Dense(nn.Linear):
  """nn.Linear with flax Dense's initialisation."""

  def __init__(self, in_features: int, out_features: int,
               generator: Optional[torch.Generator] = None,
               device=None):
    super().__init__(in_features, out_features, device=device)
    lecun_normal_(self.weight, generator)
    with torch.no_grad():
      self.bias.zero_()


class BatchNorm(nn.Module):
  """flax.linen.BatchNorm over axis 0 (see the module docstring)."""

  def __init__(self, features: int, momentum: float = 0.99,
               eps: float = 1e-5, device=None):
    super().__init__()
    self.momentum = momentum
    self.eps = eps
    self.weight = nn.Parameter(torch.ones(features, device=device))
    self.bias = nn.Parameter(torch.zeros(features, device=device))
    self.register_buffer('running_mean', torch.zeros(features, device=device))
    self.register_buffer('running_var', torch.ones(features, device=device))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.training:
      mean = x.mean(dim=0)
      var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
      with torch.no_grad():
        self.running_mean.mul_(self.momentum).add_(
            (1 - self.momentum) * mean)
        self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
    else:
      mean, var = self.running_mean, self.running_var
    mul = torch.rsqrt(var + self.eps) * self.weight
    return (x - mean) * mul + self.bias


def has_dnn(msg, name: str) -> bool:
  """Whether the DNN field `name` of a config message is set with units."""
  return msg.HasField(name) and len(getattr(msg, name).hidden_units) > 0


class DNN(nn.Module):
  """Config-driven dense stack (protos DNN semantics)."""

  def __init__(self, in_features: int, hidden_units: Sequence[int],
               activation: str = 'relu', use_bn: bool = True,
               dropout_ratio: Sequence[float] = (),
               use_final_activation: bool = True,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    self.act = get_activation(activation)
    self.hidden_units = tuple(hidden_units)
    self.use_bn = use_bn
    self.use_final_activation = use_final_activation
    if any(r > 0 for r in dropout_ratio):
      raise NotImplementedError('DNN dropout_ratio is not ported')
    width = in_features
    for i, units in enumerate(self.hidden_units):
      self.add_module('dense_%d' % i, Dense(width, units, generator, device))
      if use_bn:
        self.add_module('bn_%d' % i, BatchNorm(units, device=device))
      width = units
    self.out_features = width

  @classmethod
  def from_config(cls, cfg, in_features: int, **kwargs) -> 'DNN':
    return cls(in_features, tuple(cfg.hidden_units),
               activation=cfg.activation or 'relu', use_bn=cfg.use_bn,
               dropout_ratio=tuple(cfg.dropout_ratio), **kwargs)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    last = len(self.hidden_units) - 1
    for i in range(last + 1):
      x = getattr(self, 'dense_%d' % i)(x)
      if self.use_bn:
        x = getattr(self, 'bn_%d' % i)(x)
      if i < last or self.use_final_activation:
        x = self.act(x)
    return x
