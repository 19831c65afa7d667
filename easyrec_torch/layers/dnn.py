"""Dense towers: Dense(+BatchNorm)(+activation)(+dropout) per layer.

Counterpart of easyrec_tpu/layers/dnn.py: get_activation (:16-41), Dice
(:44-54), DNN (:57-100), the kernel initialisers (:103-115), MLP
(:118-174) and Highway (:177-200), with the flax defaults they rely on
carried over exactly:
  - Dense kernels start from flax's default lecun_normal (truncated normal,
    stddev 1/sqrt(fan_in) before truncation at two deviations), biases 0;
    MLP's from the initialiser its config names (he_uniform by default);
  - BatchNorm is flax's: batch statistics over every axis but the last (in
    a world of processes, over the global batch: parallel/mesh.py),
    with the fast variance E[x^2] - E[x]^2 clipped at 0, eps 1e-5, and
    running averages with momentum 0.99 (torch's 0.01) updated with that
    BIASED variance — so it is written here rather than taken from
    torch.nn.BatchNorm1d, which tracks the unbiased one;
  - under a bf16 compute_dtype (train_config.compute_dtype, JAX
    models/base.py:35 and DNN :71-100) a DNN casts its input to bf16, runs
    each Dense on the bf16-rounded kernel and bias (the product rounded to
    bf16, then the bias added in bf16), its BatchNorm's statistics in f32
    with the output rounded to bf16, and returns bf16; a Dense outside it
    promotes a bf16 input to its f32 weight, as flax's does. Parameters
    and optimizer state stay f32. (The JAX MLP has the same field, which
    no caller of the JAX package sets: a backbone's MLP runs in f32 under
    bf16 in both packages);
  - dropout is flax's inverted dropout: in training each element is kept
    with probability 1 - rate and scaled by 1 / (1 - rate), in eval it is
    the identity. Its mask is drawn from the generator set_generator gives
    the model (the trainer's, seeded from random_seed), never from torch's
    global one; torch cannot draw flax's masks, so the two packages agree
    on the rate of the mask and not on the mask.
Submodule names follow the flax parameter tree (dense_<i>, bn_<i>,
dice_<i>) so `convert.py` maps the two one to one.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from easyrec_torch.parallel import mesh

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
      'softmax': lambda x: torch.softmax(x, dim=-1),
      'leaky_relu': lambda x: F.leaky_relu(x, 0.01),
      'identity': lambda x: x,
      'linear': lambda x: x,
      'none': lambda x: x,
      'dice': None,  # a module with parameters: Dice, made by the tower
  }
  if key not in table:
    raise ValueError('unknown activation %r' % name)
  return table[key]


def _fans(shape: Sequence[int], batch_axis: Sequence[int] = ()):
  """flax's _compute_fans with in_axis -2, out_axis -1."""
  size = math.prod(shape)
  batch = math.prod(shape[a] for a in batch_axis)
  receptive = size / shape[-2] / shape[-1] / batch
  return shape[-2] * receptive, shape[-1] * receptive


def flax_init(shape: Sequence[int], kind: str,
              generator: Optional[torch.Generator] = None,
              batch_axis: Sequence[int] = ()) -> torch.Tensor:
  """A float32 tensor of flax's `shape` drawn like flax's initialiser
  `kind`: glorot_/he_/lecun_ uniform or normal (the normals truncated at
  two deviations and rescaled, as variance_scaling does), zeros or ones.
  The same distribution, not the same draw."""
  shape = tuple(int(d) for d in shape)
  if kind in ('zeros', 'ones'):
    return torch.full(shape, 0.0 if kind == 'zeros' else 1.0)
  family, dist = kind.rsplit('_', 1)
  fan_in, fan_out = _fans(shape, batch_axis)
  scale, denom = {'glorot': (1.0, (fan_in + fan_out) / 2.0),
                  'he': (2.0, fan_in), 'lecun': (1.0, fan_in)}[family]
  variance = scale / denom
  out = torch.empty(shape)
  with torch.no_grad():
    if dist == 'uniform':
      limit = math.sqrt(3.0 * variance)
      out.uniform_(-limit, limit, generator=generator)
    else:
      nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
      out.mul_(math.sqrt(variance) / _TRUNC_STD)
  return out


_KERNEL_INITS = ('glorot_uniform', 'glorot_normal', 'he_uniform',
                 'he_normal', 'lecun_uniform', 'lecun_normal', 'zeros',
                 'ones')


def kernel_init_name(name: str) -> str:
  """MLP's initialiser by config name (JAX _kernel_init, :103-115):
  unknown names fall back to glorot_uniform."""
  key = (name or 'glorot_uniform').lower()
  return key if key in _KERNEL_INITS else 'glorot_uniform'


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
  """nn.Linear with flax Dense's initialisation: lecun_normal kernels (or
  the flax initialiser `kernel_init` names), biases `bias_init`."""

  def __init__(self, in_features: int, out_features: int,
               generator: Optional[torch.Generator] = None,
               device=None, use_bias: bool = True,
               kernel_init: str = 'lecun_normal', bias_init: float = 0.0):
    super().__init__(in_features, out_features, bias=use_bias,
                     device=device)
    with torch.no_grad():
      if kernel_init == 'lecun_normal':
        lecun_normal_(self.weight, generator)
      else:
        self.weight.copy_(flax_init((in_features, out_features),
                                    kernel_init, generator).T)
      if use_bias:
        self.bias.fill_(bias_init)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if x.dtype != self.weight.dtype:
      x = x.to(self.weight.dtype)      # flax promotes a bf16 input to f32
    return super().forward(x)

  def forward_in(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=dtype): input, kernel and bias in `dtype`, the
    product rounded to it before the bias is added."""
    if dtype == self.weight.dtype:
      return self(x)
    y = x.to(dtype) @ self.weight.to(dtype).T
    return y if self.bias is None else y + self.bias.to(dtype)


class BatchNorm(nn.Module):
  """flax.linen.BatchNorm over every axis but the last (see the module
  docstring); without use_scale / use_bias it has no weight / bias, as
  Dice's has none."""

  def __init__(self, features: int, momentum: float = 0.99,
               eps: float = 1e-5, device=None, use_scale: bool = True,
               use_bias: bool = True):
    super().__init__()
    self.momentum = momentum
    self.eps = eps
    self.weight = nn.Parameter(torch.ones(features, device=device)) \
        if use_scale else None
    self.bias = nn.Parameter(torch.zeros(features, device=device)) \
        if use_bias else None
    self.register_buffer('running_mean', torch.zeros(features, device=device))
    self.register_buffer('running_var', torch.ones(features, device=device))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.training:
      dims = tuple(range(x.ndim - 1))
      if mesh.active_world() is None:
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
      else:
        # statistics of the global batch (mesh.step_scope): one all-reduce
        # of the sums and the row count
        n = torch.tensor([float(x.numel() // x.shape[-1])],
                         dtype=x.dtype, device=x.device)
        sums = mesh.batch_sum(torch.cat([x.sum(dim=dims),
                                         (x * x).sum(dim=dims), n]))
        f = x.shape[-1]
        mean = sums[:f] / sums[-1]
        var = torch.clamp(sums[f:2 * f] / sums[-1] - mean * mean, min=0.0)
      with torch.no_grad():
        self.running_mean.mul_(self.momentum).add_(
            (1 - self.momentum) * mean)
        self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
    else:
      mean, var = self.running_mean, self.running_var
    mul = torch.rsqrt(var + self.eps)
    if self.weight is not None:
      mul = mul * self.weight
    y = (x - mean) * mul
    return y if self.bias is None else y + self.bias


class Stochastic(nn.Module):
  """A layer that draws random numbers in training: from `generator`,
  which set_generator gives every such layer of a model. A draw with no
  generator set raises: no layer falls back on torch's global one."""

  generator: Optional[torch.Generator] = None

  def rng(self) -> torch.Generator:
    if self.generator is None:
      raise RuntimeError('%s draws in training but has no generator: '
                         'call layers.dnn.set_generator(model, generator)'
                         % type(self).__name__)
    return self.generator


def set_generator(model: nn.Module, generator: torch.Generator) -> None:
  """Give every Stochastic layer of `model` the generator it draws from
  (a generator on the device the model runs on)."""
  for m in model.modules():
    if isinstance(m, Stochastic):
      m.generator = generator


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator
            ) -> torch.Tensor:
  """flax's inverted dropout: keep with probability 1 - rate, scaled."""
  if rate >= 1.0:
    return torch.zeros_like(x)
  keep = torch.rand(x.shape, generator=generator, device=x.device) \
      < 1.0 - rate
  return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dropout(Stochastic):
  """flax.linen.Dropout: inverted dropout in training, the identity in
  eval and at rate 0."""

  def __init__(self, rate: float):
    super().__init__()
    self.rate = float(rate)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if not self.training or self.rate <= 0.0:
      return x
    return dropout(x, self.rate, self.rng())


class Dice(nn.Module):
  """The data-adaptive activation of DIN (JAX Dice, :44-54):
  p * x + (1 - p) * alpha * x with p = sigmoid(BN(x)), alpha zero-
  initialised and the BatchNorm without scale and bias (momentum 0.99,
  eps 1e-9), named BatchNorm_0 as flax names it."""

  def __init__(self, features: int, device=None):
    super().__init__()
    self.alpha = nn.Parameter(torch.zeros(features, device=device))
    self.BatchNorm_0 = BatchNorm(features, eps=1e-9, device=device,
                                 use_scale=False, use_bias=False)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    p = torch.sigmoid(self.BatchNorm_0(x))
    return p * x + (1 - p) * self.alpha * x


def has_dnn(msg, name: str) -> bool:
  """Whether the DNN field `name` of a config message is set with units."""
  return msg.HasField(name) and len(getattr(msg, name).hidden_units) > 0


class DNN(nn.Module):
  """Config-driven dense stack (protos DNN semantics). A two-tower
  embedding head ends in a plain linear layer: use_final_activation and
  use_final_bn off (JAX DNN, :66-71)."""

  def __init__(self, in_features: int, hidden_units: Sequence[int],
               activation: str = 'relu', use_bn: bool = True,
               dropout_ratio: Sequence[float] = (),
               use_final_activation: bool = True,
               generator: Optional[torch.Generator] = None, device=None,
               use_final_bn: bool = True,
               compute_dtype: torch.dtype = torch.float32):
    super().__init__()
    self.compute_dtype = compute_dtype
    self.act = get_activation(activation)
    self.hidden_units = tuple(hidden_units)
    self.use_final_activation = use_final_activation
    last = len(self.hidden_units) - 1
    width = in_features
    for i, units in enumerate(self.hidden_units):
      self.add_module('dense_%d' % i, Dense(width, units, generator, device))
      if use_bn and (i < last or use_final_bn):
        self.add_module('bn_%d' % i, BatchNorm(units, device=device))
      if self.act is None and (i < last or use_final_activation):
        self.add_module('dice_%d' % i, Dice(units, device=device))
      if i < len(dropout_ratio) and dropout_ratio[i] > 0:
        self.add_module('dropout_%d' % i, Dropout(dropout_ratio[i]))
      width = units
    self.out_features = width

  @classmethod
  def from_config(cls, cfg, in_features: int, **kwargs) -> 'DNN':
    return cls(in_features, tuple(cfg.hidden_units),
               activation=cfg.activation or 'relu', use_bn=cfg.use_bn,
               dropout_ratio=tuple(cfg.dropout_ratio), **kwargs)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    last = len(self.hidden_units) - 1
    dt = self.compute_dtype
    for i in range(last + 1):
      x = getattr(self, 'dense_%d' % i).forward_in(x, dt)
      if hasattr(self, 'bn_%d' % i):
        x = getattr(self, 'bn_%d' % i)(x.to(torch.float32)).to(dt)
      if i < last or self.use_final_activation:
        x = self.act(x) if self.act is not None else \
            getattr(self, 'dice_%d' % i)(x)
      if hasattr(self, 'dropout_%d' % i):
        x = getattr(self, 'dropout_%d' % i)(x)
    return x


class MLP(nn.Module):
  """The backbone's dense stack (JAX MLP, :118-174; protos MLP): per
  layer a Dense (with a bias only where use_bias, or use_final_bias on the
  last; kernels from `initializer`, he_uniform by default), BatchNorm
  (use_bn, use_final_bn on the last) before the activation or, under
  use_bn_after_activation, after it, the activation (final_activation on
  the last, relu by default; dice a Dice module), then dropout."""

  def __init__(self, in_features: int, hidden_units: Sequence[int],
               activation: str = 'relu', use_bn: bool = True,
               use_final_bn: bool = True, final_activation: str = 'relu',
               use_bias: bool = False, dropout_ratio: Sequence[float] = (),
               use_final_bias: bool = False,
               use_bn_after_activation: bool = False,
               kernel_initializer: str = 'glorot_uniform',
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    self.hidden_units = tuple(int(u) for u in hidden_units)
    self.use_bn_after_activation = use_bn_after_activation
    init = kernel_init_name(kernel_initializer)
    n = len(self.hidden_units)
    self.acts = []
    width = in_features
    for i, units in enumerate(self.hidden_units):
      is_last = i == n - 1
      self.add_module('dense_%d' % i, Dense(
          width, units, generator, device,
          use_bias=use_final_bias if is_last else use_bias,
          kernel_init=init))
      if use_final_bn if is_last else use_bn:
        self.add_module('bn_%d' % i, BatchNorm(units, device=device))
      act = get_activation(final_activation if is_last else activation)
      if act is None:
        self.add_module('dice_%d' % i, Dice(units, device=device))
      self.acts.append(act)
      if i < len(dropout_ratio) and dropout_ratio[i] > 0:
        self.add_module('dropout_%d' % i, Dropout(dropout_ratio[i]))
      width = units
    self.out_features = width

  @classmethod
  def from_config(cls, cfg, in_features: int, **kwargs) -> 'MLP':
    """From an MLP message (JAX MLP.from_config)."""
    return cls(in_features, tuple(cfg.hidden_units),
               activation=cfg.activation or 'relu', use_bn=cfg.use_bn,
               use_final_bn=cfg.use_final_bn,
               final_activation=cfg.final_activation or 'relu',
               use_bias=cfg.use_bias,
               dropout_ratio=tuple(cfg.dropout_ratio),
               use_final_bias=cfg.use_final_bias,
               use_bn_after_activation=cfg.use_bn_after_activation,
               kernel_initializer=cfg.initializer or 'he_uniform',
               **kwargs)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i, act in enumerate(self.acts):
      x = getattr(self, 'dense_%d' % i)(x)
      bn = getattr(self, 'bn_%d' % i, None)
      if bn is not None and not self.use_bn_after_activation:
        x = bn(x)
      x = act(x) if act is not None else getattr(self, 'dice_%d' % i)(x)
      if bn is not None and self.use_bn_after_activation:
        x = bn(x)
      if hasattr(self, 'dropout_%d' % i):
        x = getattr(self, 'dropout_%d' % i)(x)
    return x


class Highway(nn.Module):
  """Highway tower (JAX Highway, :177-200): input_proj to emb_size, then
  per layer a sigmoid gate (bias init_gate_bias) mixing act(transform(x))
  (dropped out at dropout_rate) with x."""

  def __init__(self, in_features: int, emb_size: int,
               activation: str = 'relu', dropout_rate: float = 0.0,
               init_gate_bias: float = -3.0, num_layers: int = 1,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.act = get_activation(activation)
    self.num_layers = num_layers
    self.input_proj = Dense(in_features, emb_size, **kw)
    for i in range(num_layers):
      self.add_module('gate_%d' % i, Dense(emb_size, emb_size,
                                           bias_init=init_gate_bias, **kw))
      self.add_module('transform_%d' % i, Dense(emb_size, emb_size, **kw))
    self.drop = Dropout(dropout_rate)
    self.out_features = emb_size

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = self.input_proj(x)
    for i in range(self.num_layers):
      gate = torch.sigmoid(getattr(self, 'gate_%d' % i)(x))
      nonlin = self.drop(self.act(getattr(self, 'transform_%d' % i)(x)))
      x = gate * nonlin + (1 - gate) * x
    return x
