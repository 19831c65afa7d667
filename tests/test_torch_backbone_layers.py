"""Every class of the backbone's layer registry (easyrec_torch/layers/
keras_registry.py) against its flax counterpart (easyrec_tpu/layers/
keras_registry.py) on the CPU: the same KerasLayer text through both
registries, inside a scope as a backbone block runs it, the flax variables
carried to the port by convert.py; the port's state_dict keys are the
flax tree's, and the outputs (and BatchNorm's statistics, in train mode,
and the losses sown) agree.

Tolerance: 1e-5 relative and absolute (f32 on both sides; matmul and
reduction orders differ, a few ulp per layer), as tests/
test_torch_rank_zoo.py holds the zoo's layers. Attention runs under
EASYREC_ATTN_IMPL=stock, where the two are one math in f32."""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from google.protobuf import text_format as pb_text

from easyrec_torch import convert
from easyrec_torch.config import text_format as t_text
from easyrec_torch.layers import dnn as t_dnn
from easyrec_torch.layers import keras_registry as t_reg
from easyrec_torch.models import backbone as t_bb
from easyrec_tpu.layers import keras_registry as j_reg
from easyrec_tpu.protos import layers_pb2

TOL = dict(rtol=1e-5, atol=1e-5)
B = 16


def _x(*shape, seed=0, scale=1.0):
  return (np.random.default_rng(seed).standard_normal((B,) + shape) *
          scale).astype(np.float32)


def _mask(length, seed=9):
  lens = np.random.default_rng(seed).integers(0, length + 1, B)
  return (np.arange(length)[None, :] < lens[:, None]).astype(np.float32)


def _st(**fields):
  """st_params text of a Struct: numbers, strings, bools, lists of
  numbers."""
  out = []
  for k, v in fields.items():
    if isinstance(v, bool):
      val = 'bool_value: %s' % ('true' if v else 'false')
    elif isinstance(v, str):
      val = 'string_value: "%s"' % v
    elif isinstance(v, (list, tuple)):
      val = 'list_value { %s }' % ' '.join(
          'values { number_value: %s }' % x for x in v)
    else:
      val = 'number_value: %s' % v
    out.append('fields { key: "%s" value: { %s } }' % (k, val))
  return 'st_params { %s }' % ' '.join(out)


# (id, class_name, params text, inputs, train-mode parity)
CASES = [
    ('mlp_dice_bias', 'MLP', 'mlp { hidden_units: [8, 4] activation: "dice"'
     ' use_bias: true use_final_bias: true }', lambda: _x(6), True),
    ('mlp_post_bn_softmax', 'MLP', 'mlp { hidden_units: [8, 5] '
     'use_bn_after_activation: true final_activation: "softmax" '
     'initializer: "glorot_normal" }', lambda: _x(6), True),
    ('mlp_st_params', 'MLP', _st(hidden_units=[8, 3], activation='tanh',
                                 use_final_bn=False), lambda: _x(6), True),
    ('highway', 'Highway', 'highway { emb_size: 8 num_layers: 2 '
     'init_gate_bias: -1.0 }', lambda: [_x(3), _x(4, seed=1)], True),
    ('highway_tower', 'HighWayTower', 'highway { emb_size: 5 }',
     lambda: _x(4), True),
    ('gate', 'Gate', 'gate { mlp { hidden_units: 4 } }',
     lambda: [_x(3), _x(5, seed=1), _x(5, seed=2)], True),
    ('weighted_gate', 'WeightedGate', 'gate { weight_index: 2 }',
     lambda: [_x(5, seed=1), _x(5, seed=2), _x(3)], True),
    ('ppnet_eager', 'PPNet', 'ppnet { mlp { hidden_units: [8, 4] } '
     'gate_params { output_dim: 4 hidden_dim: 6 } mode: "eager" }',
     lambda: [_x(6), _x(3, seed=1)], True),
    ('ppnet_lazy', 'PPNet', 'ppnet { mlp { hidden_units: [8, 4] } '
     'gate_params { output_dim: 4 } mode: "lazy" full_gate_input: false }',
     lambda: [_x(6), _x(3, seed=1)], True),
    ('text_cnn', 'TextCNN', 'text_cnn { filter_sizes: [2, 3] '
     'num_filters: [4, 3] activation: "tanh" mlp { hidden_units: 4 } }',
     lambda: [_x(6, 5), _mask(6)], True),
    ('periodic_list', 'PeriodicEmbedding', 'periodic_embedding { '
     'embedding_dim: 6 sigma: 0.5 output_tensor_list: true }',
     lambda: _x(3), True),
    ('periodic_3d', 'PeriodicEmbedding', 'periodic_embedding { '
     'embedding_dim: 6 sigma: 0.5 add_linear_layer: false '
     'output_3d_tensor: true }', lambda: _x(3), True),
    ('autodis', 'AutoDisEmbedding', 'auto_dis_embedding { embedding_dim: 4 '
     'num_bins: 5 temperature: 0.8 }', lambda: _x(3), True),
    ('narydis_concat', 'NaryDisEmbedding', 'nary_dis_embedding { '
     'embedding_dim: 4 carries: [2, 9] multiplier: 1000 }',
     lambda: np.abs(_x(3, scale=10.0)), True),
    ('narydis_mean', 'NaryDisEmbedding', 'nary_dis_embedding { '
     'embedding_dim: 4 carries: [3, 5] intra_ary_pooling: "mean" '
     'inter_ary_pooling: "mean" output_3d_tensor: true }',
     lambda: _x(3, scale=100.0), True),
    ('senet_list', 'SENet', 'senet { reduction_ratio: 2 }',
     lambda: [_x(4, seed=s) for s in range(4)], True),
    ('senet_3d', 'SENet', 'senet { num_squeeze_group: 1 '
     'use_skip_connection: false use_output_layer_norm: false }',
     lambda: _x(4, 6), True),
    ('bilinear_all', 'BiLinear', 'bilinear { type: "all" '
     'num_output_units: 5 }', lambda: _x(4, 3), True),
    ('bilinear_each', 'Bilinear', 'bilinear { type: "each" }',
     lambda: _x(4, 3), True),
    ('bilinear_sum', 'Bilinear', 'bilinear { type: "interaction" '
     'use_plus: false num_output_units: 6 }', lambda: _x(4, 3), True),
    ('fibinet', 'FiBiNet', 'fibinet { senet { reduction_ratio: 2 } '
     'bilinear { type: "each" num_output_units: 8 } '
     'mlp { hidden_units: 4 } }', lambda: _x(4, 4), True),
    ('mask_block_pair', 'MaskBlock', 'mask_block { output_size: 5 '
     'reduction_factor: 2.0 input_layer_norm: true }',
     lambda: [_x(6), _x(4, seed=1)], True),
    ('mask_block_self', 'MaskBlock', 'mask_block { output_size: 5 }',
     lambda: _x(6), True),
    ('masknet_parallel', 'MaskNet', 'masknet { mask_blocks { output_size: 5'
     ' } mask_blocks { output_size: 4 reduction_factor: 0.5 } '
     'mlp { hidden_units: 3 } }', lambda: _x(6), True),
    ('masknet_serial', 'MaskNet', 'masknet { mask_blocks { output_size: 5 '
     '} mask_blocks { output_size: 4 } use_parallel: false '
     'input_layer_norm: false }', lambda: _x(6), True),
    ('fm_list', 'FM', 'fm { use_variant: true }',
     lambda: [_x(4, seed=s) for s in range(3)], True),
    ('fm_3d', 'FM', '', lambda: _x(3, 4), True),
    ('cross_low_rank', 'Cross', _st(num_layers=2, projection_dim=3),
     lambda: _x(6), True),
    ('cross_pair', 'Cross', '', lambda: [_x(6), _x(6, seed=1)], True),
    ('cin', 'CIN', 'cin { hidden_feature_sizes: [4, 3] }',
     lambda: _x(3, 4), True),
    ('dot_self', 'DotInteraction', _st(self_interaction=True),
     lambda: [_x(4), _x(3, 4, seed=1)], True),
    ('mmoe', 'MMoE', 'mmoe { num_task: 2 num_expert: 3 '
     'expert_mlp { hidden_units: [6, 4] } }', lambda: _x(5), True),
    ('aitm', 'AITMTower', 'aitm { project_dim: 6 '
     'transfer_mlp { hidden_units: 4 } }',
     lambda: [_x(5), _x(3, seed=1)], True),
    ('aitm_alias_alone', 'AITM', 'aitm {}', lambda: _x(5), True),
    ('din', 'DIN', 'din { attention_dnn { hidden_units: [6] '
     'activation: "sigmoid" } }',
     lambda: [_x(5, 4), _mask(5), _x(3, seed=1)], True),
    ('din_mean_query', 'DINEncoder', 'din { attention_dnn { hidden_units: '
     '[6] } need_target_feature: false attention_normalizer: "sigmoid" }',
     lambda: [_x(5, 4), _mask(5)], True),
    ('bst_target', 'BST', 'bst { hidden_size: 8 num_hidden_layers: 2 '
     'num_attention_heads: 2 intermediate_size: 12 hidden_dropout_prob: 0 '
     'attention_probs_dropout_prob: 0 max_position_embeddings: 4 '
     'output_all_token_embeddings: true }',
     lambda: [_x(5, 6), _mask(5), _x(3, seed=1)], True),
    ('bst_tail_no_target', 'BSTEncoder', 'bst { hidden_size: 8 '
     'num_hidden_layers: 1 num_attention_heads: 2 intermediate_size: 8 '
     'target_item_position: "tail" pre_ln: true '
     'output_all_token_embeddings: false }',
     lambda: [_x(5, 6), _mask(5)], False),
    ('attention_scale', 'Attention', 'attention { use_scale: true }',
     lambda: [_x(3, 4), _x(5, 4, seed=1)], True),
    ('attention_by_dim', 'Attention', 'attention { scale_by_dim: true }',
     lambda: [_x(3, 4), _x(5, 4, seed=1), _x(5, 4, seed=2)], True),
    ('mha', 'MultiHeadAttention', 'multi_head_attention { num_heads: 2 '
     'key_dim: 3 }', lambda: [_x(5, 4), _mask(5)], True),
    ('transformer_ids', 'Transformer', 'transformer { hidden_size: 8 '
     'num_hidden_layers: 1 num_attention_heads: 2 intermediate_size: 8 '
     'vocab_size: 20 use_position_embeddings: true '
     'max_position_embeddings: 10 output_all_token_embeddings: false }',
     lambda: np.random.default_rng(0).integers(0, 20, (B, 6)).astype(
         np.int32), False),
    ('text_encoder', 'TextEncoder', 'text_encoder { transformer { '
     'hidden_size: 8 num_hidden_layers: 2 num_attention_heads: 2 '
     'intermediate_size: 8 } }', lambda: [_x(5, 6), _mask(5)], False),
    ('transformer_encoder', 'TransformerEncoder', _st(
        hidden_size=6, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=8), lambda: _x(5, 6), False),
    ('transformer_block', 'TransformerBlock', _st(hidden_size=4),
     lambda: _x(5, 6), False),
    ('seq_augment', 'SeqAugment', 'seq_aug { mask_rate: 0.5 }',
     lambda: [_x(5, 4), _mask(5), _x(3)], False),
    ('seq_augment_ops', 'SeqAugmentOps', '', lambda: _x(5, 4), False),
    ('aux_l2', 'AuxiliaryLoss', '', lambda: [_x(4), _x(4, seed=1)], True),
    ('aux_cosine', 'AuxiliaryLoss', _st(loss_type='cosine',
                                        loss_weight=0.5),
     lambda: [_x(4), _x(4, seed=1)], True),
    ('aux_info_nce', 'AuxiliaryLoss', _st(loss_type='info_nce',
                                          temperature=0.2),
     lambda: [_x(4), _x(4, seed=1)], True),
    ('aux_nce', 'AuxiliaryLoss', _st(loss_type='nce'),
     lambda: [_x(4), _x(4, seed=1)], True),
    ('einsum_dense', 'EinsumDense', _st(equation='bld,de->ble',
                                        output_shape=[5, 3],
                                        bias_axes='e', activation='relu'),
     lambda: _x(5, 4), True),
    ('einsum_dense_2d', 'EinsumDense', _st(output_shape=[3]),
     lambda: _x(4), True),
    ('layer_norm', 'LayerNorm', '', lambda: _x(6), True),
    # a 3-D input; over an axis of only 3 features the fast variance
    # E[x^2] - E[x]^2 that both packages use keeps few digits, so the
    # axis is 6 wide as in layer_norm
    ('layer_normalization', 'LayerNormalization', '', lambda: _x(5, 6),
     True),
    ('dropout', 'Dropout', _st(rate=0.3), lambda: _x(6), False),
    ('dense', 'Dense', _st(units=4, activation='relu'),
     lambda: [_x(3), _x(2, seed=1)], True),
    ('dense_no_bias', 'Dense', _st(units=3, use_bias=False),
     lambda: _x(4), True),
    ('add', 'Add', '', lambda: [_x(4, seed=s) for s in range(3)], True),
    ('multiply', 'Multiply', '', lambda: [_x(4, seed=s) for s in range(3)],
     True),
    ('concatenate', 'Concatenate', '',
     lambda: [_x(4), _x(2, seed=1)], True),
    ('flatten', 'Flatten', '', lambda: [_x(2, 3), _x(4, seed=1)], True),
    ('batch_norm', 'BatchNorm', _st(momentum=0.9), lambda: _x(5), True),
    ('batch_normalization', 'BatchNormalization', '',
     lambda: [_x(2), _x(3, seed=1)], True),
    ('dice', 'Dice', '', lambda: _x(5), True),
    ('gate_nn', 'GateNN', _st(hidden_dim=6, activation='tanh'),
     lambda: [_x(3), _x(4, seed=1)], True),
    ('gate_nn_out', 'GateNN', _st(output_dim=2), lambda: _x(3), True),
]


class _Holder(fnn.Module):
  """A flax scope as a backbone block's: the layer `blk_l0` and any
  module its builder makes unnamed."""
  pb: object

  @fnn.compact
  def __call__(self, x, training: bool = False):
    return j_reg.build_keras_layer(self.pb, 'blk_l0')(x, training)


def _torch_tree(x):
  if isinstance(x, (list, tuple)):
    return [_torch_tree(v) for v in x]
  return torch.from_numpy(np.ascontiguousarray(x))


def _leaves(x):
  if isinstance(x, (list, tuple)):
    return [leaf for v in x for leaf in _leaves(v)]
  return [x]


class _Layer:
  """The port's side: the registry's layer in a _Scope, made by a build
  pass in eval mode."""

  def __init__(self, pb, x):
    self.state = t_bb.BuildState(torch.Generator().manual_seed(0))
    self.scope = t_bb._Scope(self.state, 'blk')
    self.pb = pb
    self.state.building = True
    self.scope.eval()
    with torch.no_grad():
      self(x)
    self.state.building = False

  def __call__(self, x):
    self.scope._cursor = {}
    self.state.sink.clear()
    return t_reg.build_keras_layer(self.pb, 'blk_l0', self.scope)(x)


def _both(class_name, params):
  text = 'class_name: "%s" %s' % (class_name, params)
  return (t_text.parse(text, 'KerasLayer'),
          pb_text.Parse(text, layers_pb2.KerasLayer()))


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_layer_matches_flax(case, monkeypatch):
  monkeypatch.setenv('EASYREC_ATTN_IMPL', 'stock')
  _, class_name, params, make_x, train = case
  t_pb, j_pb = _both(class_name, params)
  x = make_x()
  module = _Holder(j_pb)
  rngs = {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1),
          'augment': jax.random.PRNGKey(2)}
  variables = module.init(rngs, x, False)
  rng = np.random.default_rng(5)
  variables = {k: jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * rng.random(np.shape(a)).astype(
          np.float32), v) for k, v in variables.items()
      if k in ('params', 'batch_stats')}
  layer = _Layer(t_pb, _torch_tree(x))
  sd = convert.flax_to_state_dict(variables.get('params', {}),
                                  variables.get('batch_stats'), root=None)
  assert sorted(sd) == sorted(layer.scope.state_dict())
  layer.scope.load_state_dict(sd)
  for training in ([False, True] if train else [False]):
    want, mutated = module.apply(variables, x, training, rngs=rngs,
                                 mutable=['batch_stats', 'losses'])
    layer.scope.train(training)
    got = layer(_torch_tree(x))
    got_l, want_l = _leaves(got), _leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
      np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    sown = jax.tree_util.tree_leaves(mutated.get('losses', {}))
    assert len(sown) == len(layer.state.sink)
    for (path, value), want_v in zip(layer.state.sink, sown):
      assert path == 'blk/blk_l0/aux_loss'
      np.testing.assert_allclose(float(value), float(want_v), **TOL)
    if training and 'batch_stats' in mutated:
      _, stats = convert.state_dict_to_flax(layer.scope.state_dict(),
                                            root=None)
      jax.tree_util.tree_map(
          lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                  rtol=1e-5, atol=1e-6),
          stats, jax.device_get(mutated['batch_stats']))
      variables = dict(variables, batch_stats=mutated['batch_stats'])


def test_every_registered_name_is_ported_alike():
  """The port registers every class name the JAX registry does, and the
  names that share a builder there share one here (the aliases)."""
  def groups(builders):
    by_fn = {}
    for name, fn in builders.items():
      by_fn.setdefault(fn, set()).add(name)
    return sorted(sorted(g) for g in by_fn.values())
  assert groups(t_reg._BUILDERS) == groups(j_reg._BUILDERS)
  with pytest.raises(ValueError, match='unknown keras layer'):
    t_reg.build_keras_layer(t_text.parse('class_name: "NoSuchLayer"',
                                         'KerasLayer'), 'x', None)


def test_dropout_layers_draw_from_the_generator():
  """The registry's Dropout in training: the kept share within 4 sigma of
  1 - rate over 10^5 elements, the kept values scaled by 1 / (1 - rate),
  one generator seed giving one mask; eval is the identity."""
  t_pb, _ = _both('Dropout', _st(rate=0.3))
  x = torch.ones(1000, 100)
  layer = _Layer(t_pb, x)
  layer.scope.eval()
  assert torch.equal(layer(x), x)
  layer.scope.train()
  t_dnn.set_generator(layer.scope, torch.Generator().manual_seed(3))
  y = layer(x)
  kept = (y != 0).float().mean().item()
  assert abs(kept - 0.7) < 4 * np.sqrt(0.7 * 0.3 / x.numel())
  np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.7, rtol=1e-6)
  t_dnn.set_generator(layer.scope, torch.Generator().manual_seed(3))
  assert torch.equal(layer(x), y)
