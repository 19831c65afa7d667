"""Layer registry for the backbone DSL: KerasLayer.class_name -> layer.

Counterpart of easyrec_tpu/layers/keras_registry.py (whole): every class
name its registry registers, with the same Parameter reads and defaults,
the adapters over layers that take structured inputs (_DINAdapter,
_BSTAdapter, _MHAAdapter, _DotAttention, _TransformerAdapter, _MMoEAdapter,
_FMAdapter, _CrossAdapter, _FieldsInput, :75-519) and the tf.keras
fallbacks (Dense, LayerNorm, Dropout, Add, Multiply, Concatenate, Flatten,
BatchNorm, Dice, GateNN, :628-757).

flax builds a layer's parameters at its first call, from the input it
sees; a torch module needs its widths when it is made. So a builder here
returns a callable `layer(x)`, and the modules behind it are made at the
layer's first call through `scope` (models/backbone.py _Scope: the package
the block runs in), under the names flax gives them:
  - a named module `name` (`<block>_l<i>`, `<block>_l<i>_r<j>`) for the
    layers flax names, adapters included, with their submodules named as
    the JAX adapters name theirs (`din`, `bst`, `mha`, `mmoe`, `mb`,
    `CrossNetV2_0`, `Dense_0`, `BatchNorm_0`, `gate_nn`);
  - `<Class>_<n>` in the package's own scope for the inner module of
    _SingleInput and _FieldsInput (Highway, Bilinear, FiBiNet, MaskNet,
    CIN, SENet, Dice), which the JAX builders make inside the package's
    compact call, so flax names it there by its class and a counter.
A layer runs in the package's mode (module.training).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from easyrec_torch.layers import blocks as B
from easyrec_torch.layers import fibinet as FB
from easyrec_torch.layers import interaction as IX
from easyrec_torch.layers import numeric_embedding as NE
from easyrec_torch.layers.attention import (BSTEncoder, DinAttention,
                                            MultiHeadSelfAttention,
                                            TransformerBlock)
from easyrec_torch.layers.dnn import (MLP, BatchNorm, Dense, Dice, Dropout,
                                      Highway, get_activation, lecun_normal_)
from easyrec_torch.layers.multi_task import MMoE
from easyrec_torch.layers.param import Parameter

_BUILDERS: Dict[str, Callable] = {}


def register_layer(*names: str):
  def deco(fn):
    for n in names:
      _BUILDERS[n.lower()] = fn
    return fn
  return deco


def has_layer(class_name: str) -> bool:
  return class_name.lower() in _BUILDERS


def build_keras_layer(keras_layer, name: str, scope) -> Callable:
  """The layer of a KerasLayer message, as a callable on its input."""
  key = keras_layer.class_name.lower()
  if key not in _BUILDERS:
    raise ValueError('unknown keras layer class %r; known: %s' %
                     (keras_layer.class_name, sorted(_BUILDERS)))
  return _BUILDERS[key](Parameter.from_keras_layer(keras_layer), name,
                        scope)


def _cat(x):
  """A list merged along the last axis (the JAX _SingleInput's rule)."""
  if isinstance(x, (list, tuple)):
    return torch.cat(list(x), dim=-1) if len(x) > 1 else x[0]
  return x


def _named(scope, name: str, make: Callable, prep: Callable = None):
  """A layer whose module is `name` in scope, made by make(x) at its
  first call on the (prepared) input x."""
  def layer(x):
    if prep is not None:
      x = prep(x)
    return scope.child(name, lambda: make(x))(x)
  return layer


def _inner(scope, cls_name: str, make: Callable, prep: Callable = _cat):
  """_SingleInput / _FieldsInput: the inner module is named in the
  package's scope by its class and the package's counter, when built."""
  return _named(scope, scope.autoname(cls_name), make, prep)


def _fields(x):
  """The JAX _FieldsInput's rule: a list of [B, D] (3-D members
  contributing their fields one by one) stacked to [B, F, D]; a single
  3-D member or a tensor passes."""
  if isinstance(x, (list, tuple)):
    if len(x) == 1 and x[0].ndim == 3:
      return x[0]
    flat = []
    for v in x:
      flat.extend(v.unbind(dim=1) if v.ndim == 3 else [v])
    return torch.stack(flat, dim=1)
  return x


# --------------------------------------------------------------------------
# adapters with parameters of their own
# --------------------------------------------------------------------------


class _DINAdapter(nn.Module):
  """[seq, mask, query] -> DIN attention [B, D]; without a target
  feature the masked mean of seq is the query; a query of another width
  is projected by `query_proj`."""

  def __init__(self, inputs, attention_dims, attention_normalizer,
               activation, need_target_feature, kw):
    super().__init__()
    seq = inputs[0]
    self.need_target_feature = need_target_feature
    d = seq.shape[-1]
    if need_target_feature and len(inputs) > 2 and inputs[2].shape[-1] != d:
      self.query_proj = Dense(inputs[2].shape[-1], d, **kw)
    self.din = DinAttention(d, attention_dims, activation=activation,
                            attention_normalizer=attention_normalizer, **kw)

  def forward(self, inputs):
    seq, mask = inputs[0], inputs[1]
    if self.need_target_feature and len(inputs) > 2:
      query = inputs[2]
    else:
      denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
      query = (seq * mask[:, :, None]).sum(dim=1) / denom
    if hasattr(self, 'query_proj'):
      query = self.query_proj(query)
    return self.din(query, seq, mask)


class _BSTAdapter(nn.Module):
  """[seq, mask(, target)] -> the BST encoding (`bst`)."""

  def __init__(self, inputs, p, kw):
    super().__init__()
    seq = inputs[0]
    target = inputs[2] if len(inputs) > 2 else None
    self.bst = BSTEncoder(
        seq.shape[-1], seq.shape[1], p['hidden_size'],
        target_features=0 if target is None else target.shape[-1],
        num_layers=p['num_layers'], num_heads=p['num_heads'],
        intermediate_size=p['intermediate_size'],
        max_position=p['max_position'], use_position=p['use_position'],
        output_all_tokens=p['output_all_tokens'],
        target_item_position=p['target_item_position'],
        reserve_target_position=p['reserve_target_position'],
        pre_ln=p['pre_ln'], hidden_dropout=p['hidden_dropout'],
        attention_dropout=p['attention_dropout'], **kw)

  def forward(self, inputs):
    target = inputs[2] if len(inputs) > 2 else None
    return self.bst(inputs[0], inputs[1], target)


class _MHAAdapter(nn.Module):
  """Self-attention over [B, F, D], or [x, mask] (`mha`)."""

  def __init__(self, inputs, num_heads, key_dim, kw):
    super().__init__()
    x = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
    self.mha = MultiHeadSelfAttention(x.shape[-1], num_heads, key_dim, **kw)

  def forward(self, inputs):
    if isinstance(inputs, (list, tuple)):
      return self.mha(inputs[0], inputs[1])
    return self.mha(inputs)


class _DotAttention(nn.Module):
  """keras.layers.Attention over [query, value(, key)]: softmax(q k^T)
  times value; scores scaled by a learned scalar (`scale`, 1 at first)
  under use_scale, or by 1/sqrt(d) under scale_by_dim."""

  def __init__(self, use_scale, scale_by_dim):
    super().__init__()
    self.scale_by_dim = scale_by_dim
    if use_scale:
      self.weight = nn.Parameter(torch.ones(()))

  def forward(self, inputs):
    q = inputs[0]
    v = inputs[1] if len(inputs) > 1 else q
    k = inputs[2] if len(inputs) > 2 else v
    scores = torch.einsum('bqd,bkd->bqk', q, k)
    if hasattr(self, 'weight'):
      scores = scores * self.weight
    elif self.scale_by_dim:
      scores = scores / float(q.shape[-1]) ** 0.5
    return torch.einsum('bqk,bkd->bqd', torch.softmax(scores, dim=-1), v)


class Embed(nn.Module):
  """flax nn.Embed: `embedding` [vocab, dim], flax's default init (the
  truncated normal of variance 1/dim)."""

  def __init__(self, vocab: int, dim: int, generator=None):
    super().__init__()
    w = torch.empty(dim, vocab)
    lecun_normal_(w.T, generator)
    self.embedding = nn.Parameter(w.T.contiguous())

  def forward(self, ids: torch.Tensor) -> torch.Tensor:
    return self.embedding[ids.to(torch.int64)]


class _TransformerAdapter(nn.Module):
  """Token-id or embedding transformer encoder: ids embedded by
  `tok_emb` (with vocab_size), other widths projected by `input_proj`,
  `position_emb` where use_position, blocks `block_<i>`, the output
  masked; every token, or the masked mean with output_all_tokens off."""

  def __init__(self, inputs, p, kw):
    super().__init__()
    x = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
    h = p['hidden_size']
    self.output_all_tokens = p['output_all_tokens']
    self.vocab_size = p['vocab_size']
    if x.ndim == 2 and self.vocab_size:
      self.tok_emb = Embed(self.vocab_size, h, **kw)
    elif x.shape[-1] != h:
      self.input_proj = Dense(x.shape[-1], h, **kw)
    if p['use_position']:
      self.position_emb = nn.Parameter(
          torch.randn((p['max_position'], h), generator=kw['generator']) *
          0.02)
    self.num_layers = p['num_layers']
    for i in range(self.num_layers):
      self.add_module('block_%d' % i, TransformerBlock(
          h, p['num_heads'], p['intermediate_size'],
          hidden_dropout=p['hidden_dropout'], attention_dropout=0.1, **kw))

  def forward(self, inputs):
    if isinstance(inputs, (list, tuple)):
      x, mask = inputs[0], inputs[1]
    else:
      x, mask = inputs, None
    if x.ndim == 2 and self.vocab_size:
      x = self.tok_emb(x)
    elif hasattr(self, 'input_proj'):
      x = self.input_proj(x)
    if mask is None:
      mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
    if hasattr(self, 'position_emb'):
      x = x + self.position_emb[None, :x.shape[1], :]
    for i in range(self.num_layers):
      x = getattr(self, 'block_%d' % i)(x, mask)
    x = x * mask[:, :, None]
    if self.output_all_tokens:
      return x
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    return x.sum(dim=1) / denom


class _MMoEAdapter(nn.Module):
  """The backbone's MMoE (`mmoe`): a LIST of per-task mixtures."""

  def __init__(self, x, num_task, num_expert, expert_hidden_units, kw):
    super().__init__()
    self.mmoe = MMoE(x.shape[-1], num_task, num_expert, expert_hidden_units,
                     **kw)

  def forward(self, x):
    return self.mmoe(_cat(x))


class _MaskBlockSelf(nn.Module):
  """MaskBlock (`mb`) on [hidden, mask_input], or on x masked by itself."""

  def __init__(self, x, output_size, reduction_factor, input_layer_norm, kw):
    super().__init__()
    h, m = (x[0], x[1]) if isinstance(x, (list, tuple)) else (x, x)
    self.mb = FB.MaskBlock(h.shape[-1], m.shape[-1], output_size,
                           reduction_factor=reduction_factor,
                           input_layer_norm=input_layer_norm, **kw)

  def forward(self, x):
    if isinstance(x, (list, tuple)):
      return self.mb(x[0], x[1])
    return self.mb(x, x)


class _CrossAdapter(nn.Module):
  """DCN-v2 Cross (`CrossNetV2_0`): a tensor runs num_layers steps from
  x0; a pair is the recurrent block's [x0, x_l], one shared step a call."""

  def __init__(self, x, num_layers, projection_dim, kw):
    super().__init__()
    dim = x[0].shape[-1] if isinstance(x, (list, tuple)) and len(x) == 2 \
        else _cat(x).shape[-1]
    self.CrossNetV2_0 = IX.CrossNetV2(dim, num_layers, projection_dim, **kw)

  def forward(self, inputs):
    if isinstance(inputs, (list, tuple)) and len(inputs) == 2:
      x0, x = inputs
      if x0.shape[-1] != x.shape[-1]:
        raise ValueError(
            'Cross with two inputs is the [x0, x_l] pair convention '
            '(reference dcn_backbone recurrent pattern) and needs equal '
            'dims, got %d vs %d; concatenate the inputs into one block '
            'first if you want a plain cross over their concat'
            % (x0.shape[-1], x.shape[-1]))
      return self.CrossNetV2_0(x0, x)
    return self.CrossNetV2_0(_cat(inputs))


class _KerasDense(nn.Module):
  """keras Dense (`Dense_0`) and its activation."""

  def __init__(self, x, units, activation, use_bias, kw):
    super().__init__()
    self.Dense_0 = Dense(x.shape[-1], units, use_bias=use_bias, **kw)
    self.act = get_activation(activation) if activation else None

  def forward(self, x):
    x = self.Dense_0(_cat(x))
    return self.act(x) if self.act is not None else x


class _KerasBatchNorm(nn.Module):
  """keras BatchNormalization (`BatchNorm_0`)."""

  def __init__(self, x, momentum):
    super().__init__()
    self.BatchNorm_0 = BatchNorm(x.shape[-1], momentum=momentum)

  def forward(self, x):
    return self.BatchNorm_0(_cat(x))


class _KerasGateNN(nn.Module):
  """The registry's GateNN (`gate_nn`), output_dim defaulting to the
  input's width."""

  def __init__(self, x, output_dim, hidden_dim, activation, dropout_rate,
               kw):
    super().__init__()
    self.gate_nn = B.GateNN(x.shape[-1], output_dim or x.shape[-1],
                            hidden_dim, activation, dropout_rate, **kw)

  def forward(self, x):
    return self.gate_nn(_cat(x))


def _combine(mode: str):
  """Add / Multiply / Concatenate over a list of same-shaped tensors."""
  def layer(inputs):
    xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if mode == 'concat':
      return torch.cat(list(xs), dim=-1) if len(xs) > 1 else xs[0]
    out = xs[0]
    for v in xs[1:]:
      out = out + v if mode == 'add' else out * v
    return out
  return layer


# --------------------------------------------------------------------------
# builders
# --------------------------------------------------------------------------


def _units(mlp) -> tuple:
  return tuple(int(u) for u in mlp.hidden_units) if mlp is not None else ()


@register_layer('MLP')
def _build_mlp(p: Parameter, name: str, scope):
  def make(x):
    return MLP(x.shape[-1], tuple(int(u) for u in p.get_list('hidden_units')),
               activation=p.get_str('activation', 'relu'),
               use_bn=p.get_bool('use_bn', True),
               use_final_bn=p.get_bool('use_final_bn', True),
               final_activation=p.get_str('final_activation', 'relu'),
               use_bias=p.get_bool('use_bias', False),
               dropout_ratio=tuple(p.get_list('dropout_ratio')),
               use_final_bias=p.get_bool('use_final_bias', False),
               use_bn_after_activation=p.get_bool('use_bn_after_activation',
                                                  False),
               kernel_initializer=p.get_str('initializer', 'he_uniform'),
               **scope.kw)
  return _named(scope, name, make)


@register_layer('Highway', 'HighWayTower')
def _build_highway(p: Parameter, name: str, scope):
  return _inner(scope, 'Highway', lambda x: Highway(
      x.shape[-1], p.get_int('emb_size', 64),
      activation=p.get_str('activation', 'relu'),
      dropout_rate=p.get_float('dropout_rate', 0.0),
      init_gate_bias=p.get_float('init_gate_bias', -3.0),
      num_layers=p.get_int('num_layers', 1), **scope.kw))


@register_layer('Gate', 'WeightedGate')
def _build_gate(p: Parameter, name: str, scope):
  units = _units(p.get_pb('mlp'))

  def make(x):
    width = [v for i, v in enumerate(x)
             if i != p.get_int('weight_index', 0)][0].shape[-1]
    return B.Gate(width, weight_index=p.get_int('weight_index', 0),
                  mlp_hidden_units=units, **scope.kw)
  return _named(scope, name, make)


@register_layer('PPNet')
def _build_ppnet(p: Parameter, name: str, scope):
  mlp = p.get_pb('mlp')
  gate = p.get_pb('gate_params')
  units = _units(mlp)
  dropout = tuple(mlp.dropout_ratio) if mlp is not None else ()
  gate_hidden = int(getattr(gate, 'hidden_dim', 0) or 0) \
      if gate is not None else 0

  def make(x):
    if not isinstance(x, (list, tuple)) or len(x) != 2:
      raise ValueError(
          'PPNet expects [general_input, gate_input]: set '
          'merge_inputs_into_list: true on the backbone block (got %s)'
          % type(x).__name__)
    return B.PPNet(x[0].shape[-1], x[1].shape[-1], units,
                   gate_hidden_dim=gate_hidden, dropout_ratio=dropout,
                   mode=p.get_str('mode', 'eager'),
                   full_gate_input=p.get_bool('full_gate_input', True),
                   **scope.kw)
  return _named(scope, name, make)


@register_layer('TextCNN')
def _build_textcnn(p: Parameter, name: str, scope):
  units = _units(p.get_pb('mlp'))

  def make(x):
    seq = x[0] if isinstance(x, (list, tuple)) else x
    return B.TextCNN(
        seq.shape[-1],
        tuple(int(v) for v in p.get_list('filter_sizes', (2, 3, 4))),
        tuple(int(v) for v in p.get_list('num_filters', (128, 64, 64))),
        activation=p.get_str('activation', 'relu'),
        mlp_hidden_units=units, **scope.kw)

  def layer(x):
    mod = scope.child(name, lambda: make(x))
    if isinstance(x, (list, tuple)):
      return mod(x[0], x[1])
    return mod(x)
  return layer


def _num_features(x) -> int:
  """The numeric embeddings' feature count: [B, N], or [B] as one."""
  return x.shape[-1] if x.ndim > 1 else 1


@register_layer('PeriodicEmbedding')
def _build_periodic(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: NE.PeriodicEmbedding(
      _num_features(x), p.get_int('embedding_dim', 16),
      sigma=p.get_float('sigma', 1.0),
      add_linear_layer=p.get_bool('add_linear_layer', True),
      linear_activation=p.get_str('linear_activation', 'relu'),
      output_3d_tensor=p.get_bool('output_3d_tensor', False),
      output_tensor_list=p.get_bool('output_tensor_list', False),
      **scope.kw))


@register_layer('AutoDisEmbedding')
def _build_autodis(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: NE.AutoDisEmbedding(
      _num_features(x), p.get_int('embedding_dim', 16),
      p.get_int('num_bins', 16),
      temperature=p.get_float('temperature', 1.0),
      keep_prob=p.get_float('keep_prob', 0.8),
      output_3d_tensor=p.get_bool('output_3d_tensor', False),
      output_tensor_list=p.get_bool('output_tensor_list', False),
      **scope.kw))


@register_layer('NaryDisEmbedding')
def _build_narydis(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: NE.NaryDisEmbedding(
      _num_features(x), p.get_int('embedding_dim', 16),
      carries=tuple(int(c) for c in p.get_list('carries', (2, 9))),
      multiplier=p.get_float('multiplier', 1.0),
      intra_ary_pooling=p.get_str('intra_ary_pooling', 'sum'),
      inter_ary_pooling=p.get_str('inter_ary_pooling', 'concat'),
      output_3d_tensor=p.get_bool('output_3d_tensor', False),
      output_tensor_list=p.get_bool('output_tensor_list', False),
      **scope.kw))


@register_layer('SENet')
def _build_senet(p: Parameter, name: str, scope):
  return _inner(scope, 'SENet', lambda x: FB.SENet(
      x.shape[1], x.shape[2],
      reduction_ratio=p.get_int('reduction_ratio', 4),
      num_squeeze_group=p.get_int('num_squeeze_group', 2),
      use_skip_connection=p.get_bool('use_skip_connection', True),
      use_output_layer_norm=p.get_bool('use_output_layer_norm', True),
      **scope.kw), prep=_fields)


@register_layer('BiLinear', 'Bilinear')
def _build_bilinear(p: Parameter, name: str, scope):
  return _inner(scope, 'Bilinear', lambda x: FB.Bilinear(
      x.shape[1], x.shape[2], type=p.get_str('type', 'interaction'),
      use_plus=p.get_bool('use_plus', True),
      num_output_units=p.get_int('num_output_units', 0), **scope.kw))


@register_layer('FiBiNet')
def _build_fibinet(p: Parameter, name: str, scope):
  senet = p.get_pb('senet')
  bilinear = p.get_pb('bilinear')
  mlp = p.get_pb('mlp')
  return _inner(scope, 'FiBiNet', lambda x: FB.FiBiNet(
      x.shape[1], x.shape[2],
      senet_reduction_ratio=int(senet.reduction_ratio) if senet else 4,
      senet_num_squeeze_group=int(senet.num_squeeze_group) if senet else 2,
      bilinear_type=str(bilinear.type) if bilinear else 'interaction',
      bilinear_output_units=int(bilinear.num_output_units)
      if bilinear else 0,
      mlp_hidden_units=_units(mlp), **scope.kw))


@register_layer('MaskBlock')
def _build_maskblock(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: _MaskBlockSelf(
      x, p.get_int('output_size', 64), p.get_float('reduction_factor', 1.0),
      p.get_bool('input_layer_norm', False), scope.kw))


@register_layer('MaskNet')
def _build_masknet(p: Parameter, name: str, scope):
  sizes, reds = [], []
  if p.is_struct:
    for blk in p.get_list('mask_blocks'):
      sizes.append(int(blk.get('output_size', 64)))
      reds.append(float(blk.get('reduction_factor', 1.0)))
  else:
    for blk in p.get('mask_blocks'):
      sizes.append(int(blk.output_size) or 64)
      reds.append(float(blk.reduction_factor) or 1.0)
  units = _units(p.get_pb('mlp'))
  return _inner(scope, 'MaskNet', lambda x: FB.MaskNet(
      x.shape[-1], tuple(sizes) or (64, 64), tuple(reds),
      use_parallel=p.get_bool('use_parallel', True),
      mlp_hidden_units=units,
      input_layer_norm=p.get_bool('input_layer_norm', True), **scope.kw))


@register_layer('FM')
def _build_fm(p: Parameter, name: str, scope):
  fm = IX.FM(use_variant=p.get_bool('use_variant', False))

  def layer(x):
    if isinstance(x, (list, tuple)):
      dims = {int(v.shape[-1]) for v in x}
      if len(dims) != 1:
        raise ValueError('all embedding dims must be equal in FM layer: '
                         '%s' % sorted(dims))
      x = torch.stack(list(x), dim=1)
    if x.ndim != 3:
      raise ValueError('input of FM layer must be a 3d tensor or a list '
                       'of 2d tensors, got shape %s' % (tuple(x.shape),))
    return fm(x)
  return layer


@register_layer('Cross')
def _build_cross(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: _CrossAdapter(
      x, p.get_int('num_layers', 1) or 1, p.get_int('projection_dim', 0),
      scope.kw))


@register_layer('CIN')
def _build_cin(p: Parameter, name: str, scope):
  sizes = tuple(int(v) for v in p.get_list('hidden_feature_sizes',
                                           (128, 128)))
  return _inner(scope, 'CIN', lambda x: IX.CIN(x.shape[1], sizes,
                                               **scope.kw))


@register_layer('DotInteraction')
def _build_dot_interaction(p: Parameter, name: str, scope):
  dot = IX.DotInteraction(p.get_bool('self_interaction', False))
  return lambda x: dot(_fields(x))


@register_layer('MMoE')
def _build_mmoe(p: Parameter, name: str, scope):
  mlp = p.get_pb('expert_mlp')
  units = tuple(mlp.hidden_units) if mlp is not None else (64,)
  return _named(scope, name, lambda x: _MMoEAdapter(
      _cat(x), p.get_int('num_task', 2), p.get_int('num_expert', 4), units,
      scope.kw))


@register_layer('AITMTower', 'AITM')
def _build_aitm(p: Parameter, name: str, scope):
  units = _units(p.get_pb('transfer_mlp'))

  def layer(x):
    # a tensor, or a list with no previous tower, passes (no parameters)
    if not isinstance(x, (list, tuple)):
      return x
    if len(x) < 2:
      return x[0]
    return scope.child(name, lambda: B.AITMTower(
        x[0].shape[-1], [v.shape[-1] for v in x[1:]],
        project_dim=p.get_int('project_dim', 0),
        transfer_hidden_units=units,
        stop_gradient=p.get_bool('stop_gradient', True), **scope.kw))(x)
  return layer


@register_layer('DIN', 'DINEncoder')
def _build_din(p: Parameter, name: str, scope):
  dnn = p.get_pb('attention_dnn')
  dims = tuple(dnn.hidden_units) if dnn is not None else (32, 16)
  act = (dnn.activation or 'relu') if dnn is not None else 'relu'
  return _named(scope, name, lambda x: _DINAdapter(
      x, dims, p.get_str('attention_normalizer', 'softmax'), act,
      p.get_bool('need_target_feature', True), scope.kw))


@register_layer('BST', 'BSTEncoder')
def _build_bst(p: Parameter, name: str, scope):
  cfg = dict(
      hidden_size=p.get_int('hidden_size', 64),
      num_layers=p.get_int('num_hidden_layers', 1),
      num_heads=p.get_int('num_attention_heads', 4),
      intermediate_size=p.get_int('intermediate_size', 128),
      max_position=p.get_int('max_position_embeddings', 512),
      use_position=p.get_bool('use_position_embeddings', True),
      hidden_dropout=p.get_float('hidden_dropout_prob', 0.1),
      attention_dropout=p.get_float('attention_probs_dropout_prob', 0.1),
      output_all_tokens=p.get_bool('output_all_token_embeddings', False),
      target_item_position=p.get_str('target_item_position', 'head'),
      reserve_target_position=p.get_bool('reserve_target_position', True),
      pre_ln=p.get_bool('pre_ln', False))
  return _named(scope, name, lambda x: _BSTAdapter(x, cfg, scope.kw))


@register_layer('Attention')
def _build_attention(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: _DotAttention(
      p.get_bool('use_scale', False), p.get_bool('scale_by_dim', False)))


@register_layer('MultiHeadAttention')
def _build_mha(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: _MHAAdapter(
      x, p.get_int('num_heads', 4), p.get_int('key_dim', 16), scope.kw))


@register_layer('Transformer', 'TransformerEncoder', 'TransformerBlock',
                'TextEncoder')
def _build_transformer(p: Parameter, name: str, scope):
  tr = p.get_pb('transformer')
  src = Parameter(tr, False) if tr is not None else p
  cfg = dict(
      hidden_size=src.get_int('hidden_size', 64),
      num_layers=src.get_int('num_hidden_layers', 1),
      num_heads=src.get_int('num_attention_heads', 4),
      intermediate_size=src.get_int('intermediate_size', 128),
      vocab_size=src.get_int('vocab_size', 0),
      max_position=src.get_int('max_position_embeddings', 512),
      use_position=src.get_bool('use_position_embeddings', False),
      hidden_dropout=src.get_float('hidden_dropout_prob', 0.1),
      output_all_tokens=src.get_bool('output_all_token_embeddings', True))
  return _named(scope, name, lambda x: _TransformerAdapter(x, cfg, scope.kw))


@register_layer('SeqAugment', 'SeqAugmentOps')
def _build_seq_augment(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: B.SeqAugment(
      mask_rate=p.get_float('mask_rate', 0.6),
      crop_rate=p.get_float('crop_rate', 0.2),
      reorder_rate=p.get_float('reorder_rate', 0.6)))


@register_layer('AuxiliaryLoss')
def _build_aux_loss(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: B.AuxiliaryLoss(
      scope.sink, '%s/%s/aux_loss' % (scope.path, name),
      loss_type=p.get_str('loss_type', 'l2_loss'),
      loss_weight=p.get_float('loss_weight', 1.0),
      temperature=p.get_float('temperature', 0.1)))


@register_layer('EinsumDense')
def _build_einsum_dense(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: B.EinsumDense(
      tuple(x.shape), p.get_str('equation', 'bd,de->be'),
      tuple(int(v) for v in p.get_list('output_shape', (64,))),
      activation=p.get_str('activation', ''),
      bias_axes=p.get_str('bias_axes', ''), **scope.kw))


@register_layer('LayerNorm', 'LayerNormalization')
def _build_layer_norm(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: B.LayerNorm(x.shape[-1]))


@register_layer('Dropout')
def _build_dropout(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: Dropout(p.get_float('rate', 0.5)))


@register_layer('Dense')
def _build_dense(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: _KerasDense(
      _cat(x), p.get_int('units', 64), p.get_str('activation', ''),
      p.get_bool('use_bias', True), scope.kw))


@register_layer('Add')
def _build_add(p: Parameter, name: str, scope):
  return _combine('add')


@register_layer('Multiply')
def _build_multiply(p: Parameter, name: str, scope):
  return _combine('multiply')


@register_layer('Concatenate')
def _build_concatenate(p: Parameter, name: str, scope):
  return _combine('concat')


@register_layer('Flatten')
def _build_flatten(p: Parameter, name: str, scope):
  def layer(x):
    if isinstance(x, (list, tuple)):
      x = torch.cat([v.reshape(v.shape[0], -1) for v in x], -1)
    return x.reshape(x.shape[0], -1)
  return layer


@register_layer('BatchNormalization', 'BatchNorm')
def _build_batch_norm(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: _KerasBatchNorm(
      _cat(x), p.get_float('momentum', 0.99)))


@register_layer('Dice')
def _build_dice(p: Parameter, name: str, scope):
  return _inner(scope, 'Dice', lambda x: Dice(x.shape[-1]))


@register_layer('GateNN')
def _build_gate_nn(p: Parameter, name: str, scope):
  return _named(scope, name, lambda x: _KerasGateNN(
      _cat(x), p.get_int('output_dim', 0), p.get_int('hidden_dim', 0),
      p.get_str('activation', 'relu'), p.get_float('dropout_rate', 0.0),
      scope.kw))
