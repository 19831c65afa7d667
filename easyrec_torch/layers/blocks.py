"""Backbone building blocks: gates, PPNet, TextCNN, AITM, sequence
augmentation, auxiliary losses, EinsumDense and LayerNorm.

Counterpart of easyrec_tpu/layers/blocks.py (whole): GateNN (:20-35),
PPNet (:38-82), TextCNN (:85-113; also the text_cnn sequence combiner's
encoder), Gate (:116-136), AITMTower (:139-174), SeqAugment (:177-224),
AuxiliaryLoss (:227-258), EinsumDense (:261-283) and LayerNorm (:286-290).
TextCNN's convolutions are flax's nn.Conv with VALID padding; a flax Conv
kernel [W, Cin, Cout] is nn.Conv1d's weight [Cout, Cin, W] with its axes
reversed, so convert.py carries it by the transpose it gives every kernel,
and EinsumDense keeps its kernel the same way. Submodule names follow the
flax tree.

The JAX AuxiliaryLoss sows its loss into flax's `losses` collection, which
the trainer adds to the total; here it appends (path, value) to the list
`sink` it was given (the backbone's, models/backbone.py), by the path the
flax collection would hold it under.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from easyrec_torch.layers.attention import LayerNorm as FlaxLayerNorm
from easyrec_torch.losses.losses import batch_mean
from easyrec_torch.parallel.mesh import whole_batch
from easyrec_torch.layers.dnn import (MLP, BatchNorm, Dense, Dropout,
                                      Stochastic, flax_init, get_activation)

# stddev of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


class TextCNN(nn.Module):
  """seq [B, L, D] (times mask [B, L] where given) -> parallel 1-D
  convolutions of widths `filter_sizes`, relu, a max over time,
  concatenated: [B, sum(num_filters)]."""

  def __init__(self, in_features: int,
               filter_sizes: Sequence[int] = (2, 3, 4),
               num_filters: Sequence[int] = (128, 64, 64),
               activation: str = 'relu',
               mlp_hidden_units: Sequence[int] = (),
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    self.act = get_activation(activation)
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
    if mlp_hidden_units:
      self.mlp = MLP(self.out_features, mlp_hidden_units,
                     generator=generator, device=device)
      self.out_features = self.mlp.out_features

  def forward(self, seq: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is not None:
      seq = seq * mask[:, :, None]
    x = seq.transpose(1, 2)                          # [B, D, L]
    pools = [self.act(getattr(self, 'conv_%d' % i)(x)).amax(dim=2)
             for i in range(self.n_convs)]
    out = torch.cat(pools, dim=-1)
    return self.mlp(out) if hasattr(self, 'mlp') else out


class GateNN(nn.Module):
  """Two dense layers ending in 2 * sigmoid (PPNet's gate): `hidden`
  (hidden_dim, else output_dim wide) with the activation and dropout, then
  `gate`."""

  def __init__(self, in_features: int, output_dim: int, hidden_dim: int = 0,
               activation: str = 'relu', dropout_rate: float = 0.0,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    hidden = hidden_dim or output_dim
    self.act = get_activation(activation)
    self.hidden = Dense(in_features, hidden, **kw)
    self.drop = Dropout(dropout_rate)
    self.gate = Dense(hidden, output_dim, **kw)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = self.drop(self.act(self.hidden(x)))
    return 2.0 * torch.sigmoid(self.gate(x))


class PPNet(nn.Module):
  """Parameter Personalization Net: called with [general_input,
  gate_input]; a GateNN over [stop_gradient(x), gate_input] (or the gate
  input alone) scales the input once (mode lazy, `gate_in`) or every
  hidden layer (eager, `gate_<i>`); the layers are Dense, BatchNorm, the
  activation and dropout."""

  def __init__(self, in_features: int, gate_features: int,
               hidden_units: Sequence[int], gate_hidden_dim: int = 0,
               activation: str = 'relu', dropout_ratio: Sequence[float] = (),
               mode: str = 'eager', full_gate_input: bool = True,
               use_bn: bool = True,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.act = get_activation(activation)
    self.eager = mode == 'eager'
    self.full_gate_input = full_gate_input
    self.use_bn = use_bn
    self.hidden_units = tuple(int(u) for u in hidden_units)
    gate_in = in_features + gate_features if full_gate_input \
        else gate_features
    if not self.eager:
      self.gate_in = GateNN(gate_in, in_features, gate_hidden_dim, **kw)
    width = in_features
    for i, units in enumerate(self.hidden_units):
      self.add_module('dense_%d' % i, Dense(width, units, **kw))
      if use_bn:
        self.add_module('bn_%d' % i, BatchNorm(units, device=device))
      if i < len(dropout_ratio) and dropout_ratio[i] > 0:
        self.add_module('dropout_%d' % i, Dropout(dropout_ratio[i]))
      if self.eager:
        self.add_module('gate_%d' % i, GateNN(gate_in, units,
                                              gate_hidden_dim, **kw))
      width = units
    self.out_features = width

  def forward(self, inputs) -> torch.Tensor:
    if not isinstance(inputs, (list, tuple)) or len(inputs) != 2:
      raise ValueError(
          'PPNet expects [general_input, gate_input]: set '
          'merge_inputs_into_list: true on the backbone block (got %s)'
          % type(inputs).__name__)
    x, gate_feats = inputs
    gate_in = torch.cat([x.detach(), gate_feats], dim=-1) \
        if self.full_gate_input else gate_feats
    if not self.eager:
      x = x * self.gate_in(gate_in)
    for i in range(len(self.hidden_units)):
      x = getattr(self, 'dense_%d' % i)(x)
      if self.use_bn:
        x = getattr(self, 'bn_%d' % i)(x)
      x = self.act(x)
      if hasattr(self, 'dropout_%d' % i):
        x = getattr(self, 'dropout_%d' % i)(x)
      if self.eager:
        x = x * getattr(self, 'gate_%d' % i)(gate_in)
    return x


class Gate(nn.Module):
  """Weighted sum over a list: element `weight_index` is the weight
  [B, >= K] of the K others [B, D]; then `top_mlp` where set."""

  def __init__(self, in_features: int = 0, weight_index: int = 0,
               mlp_hidden_units: Sequence[int] = (),
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    self.weight_index = weight_index
    if mlp_hidden_units:
      self.top_mlp = MLP(in_features, mlp_hidden_units, generator=generator,
                         device=device)

  def forward(self, inputs) -> torch.Tensor:
    if len(inputs) <= 1:
      raise ValueError('Gate input must be a list of >= 2 elements')
    w = inputs[self.weight_index]
    others = [v for i, v in enumerate(inputs) if i != self.weight_index]
    stacked = torch.stack(others, dim=1)                 # [B, K, D]
    out = torch.einsum('bk,bkd->bd', w[:, :len(others)], stacked)
    return self.top_mlp(out) if hasattr(self, 'top_mlp') else out


class AITMTower(nn.Module):
  """Adaptive Information Transfer (AITM): called with [current,
  previous towers...]; each previous output (gradient stopped where
  stop_gradient) through its transfer MLP and projection, attended with
  the projected current one by q/k/v over the K candidates."""

  def __init__(self, in_features: int, prev_features: Sequence[int],
               project_dim: int = 0,
               transfer_hidden_units: Sequence[int] = (),
               stop_gradient: bool = True,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    dim = project_dim or in_features
    self.dim = dim
    self.stop_gradient = stop_gradient
    self.proj_current = Dense(in_features, dim, **kw)
    self.n_prev = len(prev_features)
    for i, width in enumerate(prev_features):
      if transfer_hidden_units:
        mlp = MLP(width, transfer_hidden_units, **kw)
        self.add_module('transfer_%d' % i, mlp)
        width = mlp.out_features
      self.add_module('proj_prev_%d' % i, Dense(width, dim, **kw))
    for name in ('q', 'k', 'v'):
      self.add_module(name, Dense(dim, dim, **kw))

  def forward(self, inputs) -> torch.Tensor:
    if not isinstance(inputs, (list, tuple)):
      return inputs
    current, prevs = inputs[0], list(inputs[1:])
    if not prevs:
      return current
    infos = [self.proj_current(current)]
    for i, p in enumerate(prevs):
      if self.stop_gradient:
        p = p.detach()
      if hasattr(self, 'transfer_%d' % i):
        p = getattr(self, 'transfer_%d' % i)(p)
      infos.append(getattr(self, 'proj_prev_%d' % i)(p))
    u = torch.stack(infos, dim=1)                        # [B, K, dim]
    scores = torch.sum(self.q(u) * self.k(u), dim=-1) / math.sqrt(
        float(self.dim))
    w = torch.softmax(scores, dim=1)
    return torch.einsum('bk,bkd->bd', w, self.v(u))


class SeqAugment(Stochastic):
  """CL4SRec's random augmentation of a [B, L, D] sequence in training:
  each row takes one of (chosen uniformly per row) its masked form
  (positions kept with probability 1 - mask_rate), its cropped form (a
  random window of max(int(L (1 - crop_rate)), 1) steps kept) or its
  reordered form (the steps permuted by one permutation of the batch).
  [seq, mask, extras...] keeps mask and extras; the identity in eval."""

  def __init__(self, mask_rate: float = 0.6, crop_rate: float = 0.2,
               reorder_rate: float = 0.6):
    super().__init__()
    self.mask_rate = mask_rate
    self.crop_rate = crop_rate
    self.reorder_rate = reorder_rate

  def forward(self, inputs):
    extra = []
    if isinstance(inputs, (list, tuple)):
      seq = inputs[0]
      mask = inputs[1] if len(inputs) > 1 else None
      extra = list(inputs[2:])
    else:
      seq, mask = inputs, None
    if not self.training:
      return [seq, mask] + extra if mask is not None else seq
    gen = self.rng()
    dev = seq.device
    b, length = seq.shape[0], seq.shape[1]
    keep = torch.rand((b, length), generator=gen, device=dev) < \
        1.0 - self.mask_rate
    masked = seq * keep[:, :, None].to(seq.dtype)
    win = max(int(length * (1.0 - self.crop_rate)), 1)
    start = torch.randint(0, length - win + 1, (b, 1), generator=gen,
                          device=dev)
    pos = torch.arange(length, device=dev)[None, :]
    in_win = (pos >= start) & (pos < start + win)
    cropped = seq * in_win[:, :, None].to(seq.dtype)
    perm = torch.randperm(length, generator=gen, device=dev)
    reordered = seq[:, perm, :]
    choice = torch.randint(0, 3, (b,), generator=gen, device=dev)
    out = torch.where((choice == 0)[:, None, None], masked,
                      torch.where((choice == 1)[:, None, None], cropped,
                                  reordered))
    if mask is not None:
      return [out, mask] + extra
    return out


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
  return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                         min=1e-9)


class AuxiliaryLoss(nn.Module):
  """An extra loss between inputs[0] and inputs[1] (l2_loss, cosine, or
  info_nce / nce at `temperature`), times loss_weight, appended to `sink`
  as (path, value); returns inputs[0]."""

  def __init__(self, sink: List, path: str, loss_type: str = 'l2_loss',
               loss_weight: float = 1.0, temperature: float = 0.1):
    super().__init__()
    self.sink = sink
    self.path = path
    self.loss_type = loss_type
    self.loss_weight = loss_weight
    self.temperature = temperature

  def forward(self, inputs) -> torch.Tensor:
    x1, x2 = inputs[0], inputs[1]
    if self.loss_type == 'cosine':
      loss = -batch_mean(torch.sum(_l2_normalize(x1) * _l2_normalize(x2),
                                   dim=-1))
    elif self.loss_type in ('info_nce', 'nce'):
      # in-batch columns of the global batch (parallel/mesh.py)
      with whole_batch(x1, x2) as (g1, g2):
        logits = _l2_normalize(g1) @ _l2_normalize(g2).T / self.temperature
        loss = torch.mean(
            -torch.diagonal(torch.log_softmax(logits, dim=-1)))
    else:
      loss = batch_mean(torch.sum(torch.square(x1 - x2), dim=-1))
    self.sink.append((self.path, self.loss_weight * loss))
    return x1


class EinsumDense(nn.Module):
  """A dense layer as an einsum `equation` (keras EinsumDense): the kernel
  shape comes from the input's and output_shape's axes; kept as `weight`
  with flax's kernel axes reversed; `bias` over bias_axes; then the
  activation where named."""

  def __init__(self, in_shape: Sequence[int], equation: str,
               output_shape: Sequence[int], activation: str = '',
               bias_axes: str = '',
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    lhs, out_spec = equation.split('->')
    in_spec, kernel_spec = lhs.split(',')
    dims = dict(zip(in_spec, in_shape))
    for ax, size in zip(out_spec[1:], output_shape):
      dims.setdefault(ax, int(size))
    kernel_shape = tuple(dims[ax] for ax in kernel_spec)
    self.equation = equation
    self.weight = nn.Parameter(flax_init(
        kernel_shape, 'glorot_uniform', generator).permute(
            *reversed(range(len(kernel_shape)))).contiguous().to(device))
    if bias_axes:
      self.bias = nn.Parameter(torch.zeros(
          tuple(dims[ax] for ax in bias_axes), device=device))
    self.act = get_activation(activation) if activation else None

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    kernel = self.weight.permute(*reversed(range(self.weight.ndim)))
    out = torch.einsum(self.equation, x, kernel)
    if hasattr(self, 'bias'):
      out = out + self.bias
    return self.act(out) if self.act is not None else out


class LayerNorm(nn.Module):
  """The registry's LayerNorm: flax's LayerNorm, named LayerNorm_0 as the
  JAX wrapper's unnamed submodule is."""

  def __init__(self, features: int, device=None):
    super().__init__()
    self.LayerNorm_0 = FlaxLayerNorm(features, device=device)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.LayerNorm_0(x)
