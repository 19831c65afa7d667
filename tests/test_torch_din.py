"""The Taobao DIN slice of the port against the JAX package: the sequence
id path (split_hash, SequenceFeature and num_buckets IdFeature transforms,
synthetic sequences, the fused table's layout), DinAttention and the
MultiTowerDIN forward with flax parameters carried across by convert.py,
three train steps of a small DIN against the JAX Trainer with the fused
update (K3) and without it (K1 + K2), and the train CLI on the CPU."""

import functools
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.data import input_pipeline as t_input
from easyrec_torch.features import feature_spec as t_fs
from easyrec_torch.layers import attention as t_att
from easyrec_torch.models import base as t_base
from easyrec_torch.models import rank as t_rank  # noqa: F401 (registers)
from easyrec_torch.ops import embedding as t_emb
from easyrec_torch.ops import hashing as t_hashing
from easyrec_torch.ops import kernels
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_torch.utils import flagship as t_flagship
from easyrec_torch.utils import synthetic as t_synth
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.data import input_pipeline as j_input
from easyrec_tpu.features import feature_spec as j_fs
from easyrec_tpu.layers import attention as j_att
from easyrec_tpu.models import base as j_base
from easyrec_tpu.models import zoo  # noqa: F401 (registers)
from easyrec_tpu.ops import embedding as j_emb
from easyrec_tpu.ops import hashing as j_hashing
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.train.trainer import Trainer as JTrainer
from easyrec_tpu.utils import flagship as j_flagship
from easyrec_tpu.utils.synthetic import synthetic_batch
from tests.test_torch_config import _assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# f32 on both sides; matmul, softmax and reduction orders differ (XLA vs
# ATen): a few ulp of relative error per layer
TOL = dict(rtol=1e-5, atol=1e-5)

CONFIG = '''
train_input_path: "synthetic"
eval_input_path: "synthetic"
train_config {
  optimizer_config { adam_optimizer { learning_rate {
    exponential_decay_learning_rate { initial_learning_rate: 0.01
      decay_steps: 2 decay_factor: 0.5 min_learning_rate: 0.004 } } } }
  num_steps: 3
  log_step_count_steps: 1
}
eval_config { metrics_set { auc {} } }
data_config {
  batch_size: 64 label_fields: "clk" input_type: DummyInput
  input_fields { input_name: "clk" input_type: FLOAT }
  input_fields { input_name: "user_id" input_type: STRING }
  input_fields { input_name: "brand" input_type: STRING }
  input_fields { input_name: "cate_id" input_type: STRING }
  input_fields { input_name: "price" input_type: INT32 }
  input_fields { input_name: "tag_brand_list" input_type: STRING }
  input_fields { input_name: "tag_category_list" input_type: STRING }
}
feature_config {
  features { input_names: "user_id" feature_type: IdFeature
             embedding_dim: 16 hash_bucket_size: 500 }
  features { input_names: "brand" feature_type: IdFeature
             embedding_dim: 16 hash_bucket_size: 500 }
  features { input_names: "cate_id" feature_type: IdFeature
             embedding_dim: 16 hash_bucket_size: 400 }
  features { input_names: "price" feature_type: IdFeature
             embedding_dim: 16 num_buckets: 50 }
  features { input_names: "tag_brand_list" feature_type: SequenceFeature
             separator: "|" embedding_dim: 16 hash_bucket_size: 500
             max_seq_len: 8 }
  features { input_names: "tag_category_list"
             feature_type: SequenceFeature separator: "|"
             embedding_dim: 16 hash_bucket_size: 400 max_seq_len: 8 }
}
model_config {
  model_class: "MultiTowerDIN"
  feature_groups { group_name: "user" feature_names: "user_id"
                   wide_deep: DEEP }
  feature_groups { group_name: "item"
                   feature_names: ["brand", "cate_id", "price"]
                   wide_deep: DEEP }
  seq_att_groups {
    group_name: "din"
    seq_att_map { key: "brand" hist_seq: "tag_brand_list" }
    seq_att_map { key: "cate_id" hist_seq: "tag_category_list" }
  }
  multi_tower {
    towers { input: "user" dnn { hidden_units: [16, 8] use_bn: %(bn)s } }
    towers { input: "item" dnn { hidden_units: [16, 8] use_bn: %(bn)s } }
    din_towers { input: "din" dnn { hidden_units: [8, 1] } }
    final_dnn { hidden_units: [8] use_bn: %(bn)s }
    l2_regularization: 1e-3
  }
  embedding_regularization: 1e-4
}
'''


def _configs(bn=True):
  text = CONFIG % {'bn': 'true' if bn else 'false'}
  return (t_config.get_configs_from_pipeline_str(text),
          j_config.get_configs_from_pipeline_str(text))


def _torch(batch):
  return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          batch.items()}


# ------------------------------------------------------- host id path


def test_split_hash_matches_10k_strings():
  """Both JAX paths (the python split of numpy input and the native kernel
  of arrow input) give the port's ids and counts: empty strings, empty
  pieces, pieces past max_k and non-ascii text included."""
  rng = np.random.default_rng(0)
  alphabet = list('abXY09_é中 ')
  strs = []
  for _ in range(10000):
    pieces = [''.join(rng.choice(alphabet, rng.integers(0, 6)))
              for _ in range(rng.integers(0, 14))]
    strs.append('|'.join(pieces))
  strs[:4] = ['', '|', 'a||b|', '|'.join('p%d' % i for i in range(40))]
  values = np.array(strs, dtype=object)
  for buckets, max_k in ((1000, 8), (7, 1), (100000, 50)):
    got_ids, got_counts = t_hashing.split_hash(values, '|', buckets, max_k)
    for j_values in (values, pa.array(strs, type=pa.string())):
      ids, counts = j_hashing.split_hash(j_values, '|', buckets, max_k)
      np.testing.assert_array_equal(got_ids, ids)
      np.testing.assert_array_equal(got_counts, counts)
  assert got_counts[3] == 40 and got_counts[0] == 0


def _assert_batches_equal(t_pipe, j_pipe, n_batches):
  t_it, j_it = iter(t_pipe), iter(j_pipe)
  for _ in range(n_batches):
    t_b, j_b = next(t_it), next(j_it)
    assert sorted(t_b) == sorted(j_b)
    for k in j_b:
      assert t_b[k].dtype == j_b[k].dtype, k
      np.testing.assert_array_equal(t_b[k], j_b[k], err_msg=k)


def test_taobao_dummy_pipeline_batches_match():
  """The Taobao DIN's DummyInput: one-token sequences (the padding of
  every other position is id 0, mask 0) and INT32 price ids clipped to
  num_buckets."""
  t_cfg = t_flagship.taobao_din_config(batch_size=64)
  j_cfg = j_flagship.taobao_din_config(batch_size=64, model_dir='')
  _assert_same(t_cfg, j_cfg, 'config')
  t_pipe = t_input.InputPipeline(
      t_cfg.data_config, t_config.get_feature_configs(t_cfg), 'synthetic')
  j_pipe = j_input.InputPipeline(
      j_cfg.data_config, j_config.get_feature_configs(j_cfg), 'synthetic')
  _assert_batches_equal(t_pipe, j_pipe, 2)
  b = next(iter(t_pipe))
  np.testing.assert_array_equal(b['feat.tag_brand_list.mask'].sum(1), 1.0)


def test_csv_sequences_and_int32_ids_match(tmp_path):
  """A CSV with real sequences: lengths 0 to past max_seq_len, doubled
  separators, and an INT32 num_buckets column with out-of-range and empty
  cells (empty reads default_val)."""
  rng = np.random.default_rng(1)
  lines = []
  for i in range(300):
    seq = '|'.join('b%d' % v for v in rng.integers(0, 50,
                                                   rng.integers(0, 12)))
    if i % 7 == 0:
      seq = seq.replace('|', '||', 1)
    price = '' if i % 11 == 0 else str(rng.integers(-3, 60))
    lines.append('%d,u%d,%s,%s' % (i % 2, i % 13, price, seq))
  path = tmp_path / 'din.csv'
  path.write_text('\n'.join(lines) + '\n')
  text = '''
train_input_path: "%s"
data_config {
  batch_size: 64 label_fields: "clk" num_epochs: 1
  input_fields { input_name: "clk" input_type: FLOAT }
  input_fields { input_name: "user_id" input_type: STRING }
  input_fields { input_name: "price" input_type: INT32 default_val: "7" }
  input_fields { input_name: "hist" input_type: STRING }
}
feature_config {
  features { input_names: "user_id" feature_type: IdFeature
             embedding_dim: 16 hash_bucket_size: 100 }
  features { input_names: "price" feature_type: IdFeature
             embedding_dim: 16 num_buckets: 50 }
  features { input_names: "hist" feature_type: SequenceFeature
             separator: "|" embedding_dim: 16 hash_bucket_size: 300
             max_seq_len: 8 }
}
''' % path
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  t_pipe = t_input.InputPipeline(
      t_cfg.data_config, t_config.get_feature_configs(t_cfg), str(path))
  j_pipe = j_input.InputPipeline(
      j_cfg.data_config, j_config.get_feature_configs(j_cfg), str(path))
  _assert_batches_equal(t_pipe, j_pipe, 5)
  b = next(iter(t_pipe))
  assert set(b['feat.hist.mask'].sum(1).tolist()) >= {0.0, 8.0}
  assert b['feat.price.ids'].min() >= 0 and b['feat.price.ids'].max() <= 49


def test_specs_layout_and_synthetic_batches_match():
  """Sequence specs (k = max_seq_len, a mask), the fused table's feature
  order and row offsets, synthetic sequences (lengths 1..L, ids x mask)
  and the id pack over sequence slots."""
  t_cfg = t_flagship.taobao_din_config(batch_size=32)
  j_cfg = j_flagship.taobao_din_config(batch_size=32, model_dir='')
  t_specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  j_specs = j_fs.build_feature_specs(j_config.get_feature_configs(j_cfg))
  for name, j in j_specs.items():
    t = t_specs[name]
    assert (t.kind, t.num_ids, t.rows, t.table_name, t.embedding_dim) == \
        (j.kind, j.num_ids, j.rows, j.table_name, j.embedding_dim), name
  t_ctx = t_base.build_context(t_cfg, t_specs)
  j_ctx = j_base.build_context(j_cfg, j_specs)
  for key, j in j_ctx.layout.tables.items():
    t = t_ctx.layout.tables[key]
    assert (t.rows, t.dim, t.offsets) == (j.rows, j.dim, j.offsets)
    assert [(u.feature, u.k, u.offset, u.start) for u in t.uses] == \
        [(u.feature, u.k, u.offset, u.start) for u in j.uses]
  assert t_ctx.layout.tables['emb16'].tot_k == 115
  t_b = t_synth.synthetic_batch(t_specs, ['clk'], 32, seed=4)
  j_b = synthetic_batch(j_specs, ['clk'], 32, seed=4)
  assert sorted(t_b) == sorted(j_b)
  for k in j_b:
    np.testing.assert_array_equal(t_b[k], j_b[k], err_msg=k)
  t_packs = t_emb.pack_ids(t_ctx.layout, _torch(t_b))
  j_packs = j_emb.pack_ids(j_ctx.layout, j_b)
  for k in j_packs:
    np.testing.assert_array_equal(t_packs[k].numpy(), np.asarray(j_packs[k]))


@pytest.mark.parametrize('text,what', [
    ('multi_tower { bst_towers { input: "din" } }', 'bst_towers'),
    ('seq_att_groups { seq_att_map { aux_hist_seq: "s" } }', 'aux_hist_seq'),
    ('feature_groups { sequence_features { group_name: "s" } }',
     'sequence_features'),
    ('seq_att_groups { seq_dnn { hidden_units: [4, 1] } }', 'seq_dnn'),
])
def test_unported_sequence_parts_raise_naming_them(text, what):
  cfg = t_config.get_configs_from_pipeline_str(
      'model_config { model_class: "MultiTowerDIN" %s }' % text)
  with pytest.raises(NotImplementedError, match=what):
    t_config.check_ported(cfg)


@pytest.mark.parametrize('feature,what', [
    ('feature_type: SequenceFeature sub_feature_type: RawFeature',
     'numeric sequence'),
    ('feature_type: SequenceFeature num_buckets: 10', 'hashed ids'),
])
def test_unported_sequence_features_raise(feature, what):
  cfg = t_config.get_configs_from_pipeline_str(
      'feature_configs { input_names: "s" embedding_dim: 4 %s }' % feature)
  with pytest.raises(NotImplementedError, match=what):
    t_fs.build_feature_specs(t_config.get_feature_configs(cfg))


def test_multi_tower_bst_is_not_ported():
  cfg = t_config.get_configs_from_pipeline_str(
      'model_config { model_class: "MultiTowerBST" }')
  with pytest.raises(NotImplementedError, match='MultiTowerBST'):
    t_config.check_ported(cfg)


# ------------------------------------------------------------ forward


def test_din_attention_matches_flax():
  """Masked softmax over valid steps, zero weights for a row whose mask
  is empty (rows 0 and 5 here), the linear last score layer and the
  weighted sum."""
  rng = np.random.default_rng(2)
  b, l, d = 6, 7, 8
  query = rng.standard_normal((b, d)).astype(np.float32)
  keys = rng.standard_normal((b, l, d)).astype(np.float32)
  mask = (rng.random((b, l)) < 0.6).astype(np.float32)
  mask[0] = 0.0
  mask[5] = 0.0
  mask[1] = 1.0
  keys = keys * mask[:, :, None]
  j_mod = j_att.DinAttention(attention_dims=(12, 6), activation='relu')
  variables = j_mod.init(jax.random.PRNGKey(0), query, keys, mask)
  variables = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
          np.shape(a)).astype(np.float32), variables)
  want = np.asarray(j_mod.apply(variables, query, keys, mask))
  t_mod = t_att.DinAttention(d, (12, 6))
  t_mod.load_state_dict(convert.flax_to_state_dict(variables['params'],
                                                   root=None))
  got = t_mod(torch.from_numpy(query), torch.from_numpy(keys),
              torch.from_numpy(mask)).detach().numpy()
  np.testing.assert_allclose(got, want, **TOL)
  np.testing.assert_array_equal(got[[0, 5]], 0.0)
  assert np.abs(got[1]).max() > 0


SEQ_ATT = '''
  seq_att_groups {
    group_name: "din"
    seq_att_map { key: "brand" hist_seq: "tag_brand_list" }
    seq_att_map { key: "cate_id" hist_seq: "tag_category_list" }
  }'''
SEQ_ATT_VARIANTS = {
    'key': SEQ_ATT,
    # no target key: the masked mean of the history is the query
    'no_key': SEQ_ATT.replace('group_name: "din"',
                              'group_name: "din" need_key_feature: false'),
    # a 16-wide key against a 32-wide history: key_transform projects it
    'key16': SEQ_ATT.replace('key: "cate_id" ', '').replace(
        'group_name: "din"', 'group_name: "din" allow_key_transform: true'),
}


@pytest.mark.parametrize('variant', sorted(SEQ_ATT_VARIANTS))
def test_multi_tower_din_forward_matches_flax(variant):
  """The whole MultiTowerDIN forward with its input layer: user and item
  towers with BatchNorm, the DIN tower ([attended history, query]) over
  two hist sequences whose mask is their max, final_dnn and the logit;
  train mode (batch statistics) and eval mode (running statistics), with
  an all-padding history row. Variants: the target keys as query, no key
  (need_key_feature false), and a key narrower than the history
  (allow_key_transform)."""
  text = CONFIG % {'bn': 'true'}
  assert SEQ_ATT in text
  text = text.replace(SEQ_ATT, SEQ_ATT_VARIANTS[variant])
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  j_specs = j_fs.build_feature_specs(j_config.get_feature_configs(j_cfg))
  t_specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  j_ctx = j_base.build_context(j_cfg, j_specs)
  t_ctx = t_base.build_context(t_cfg, t_specs)
  module = j_base.create_model(j_ctx).make_module()
  t_model = t_base.create_model(t_ctx)
  rng = np.random.default_rng(3)
  batch = synthetic_batch(j_specs, ['clk'], 32, seed=5)
  for f in ('tag_brand_list', 'tag_category_list'):
    batch['feat.%s.mask' % f][2] = 0.0           # all padding
    batch['feat.%s.ids' % f][2] = 0
  batch['feat.tag_category_list.mask'][4, :] = 0.0   # mask = max of both
  j_packs = j_emb.pack_ids(j_ctx.layout, batch)
  pulled = {k: rng.standard_normal(
      tuple(p.shape) + (t_ctx.layout.tables[k].dim,)).astype(np.float32)
            for k, p in j_packs.items()}
  variables = module.init({'params': jax.random.PRNGKey(0),
                           'dropout': jax.random.PRNGKey(0)},
                          batch, pulled, False)
  variables = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * rng.random(np.shape(a)).astype(
          np.float32), variables)
  sd = convert.flax_to_state_dict(variables['params'],
                                  variables['batch_stats'])
  assert any(k.startswith('din_din.att_dnn.dense_') for k in sd)
  assert ('key_transform_din.weight' in sd) == (variant == 'key16')
  t_model.load_state_dict(sd)

  want, mutated = module.apply(variables, batch, pulled, True,
                               mutable=['batch_stats', 'losses'])
  t_model.train()
  got = t_model(_torch(batch), _torch(pulled))
  for k in ('logits', 'probs'):
    np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                               err_msg=k, **TOL)
  _, stats = convert.state_dict_to_flax(t_model.state_dict())
  jax.tree_util.tree_map(
      lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                              atol=1e-6),
      stats, mutated['batch_stats'])
  variables = {'params': variables['params'],
               'batch_stats': mutated['batch_stats']}
  want = module.apply(variables, batch, pulled, False)
  t_model.eval()
  got = t_model(_torch(batch), _torch(pulled))
  np.testing.assert_allclose(got['logits'].detach().numpy(),
                             np.asarray(want['logits']), **TOL)


# --------------------------------------------------- three train steps


LR_SUM = 0.01 + 0.01 + 0.005      # the schedule's rates of the 3 steps


def _bn_cancelled(path):
  """A Dense bias feeding a BatchNorm: its gradient is zero up to f32
  rounding, and Adam turns that noise into a step of +-lr either way."""
  keys = [getattr(k, 'key', None) for k in path]
  return (keys[-1] == 'bias' and str(keys[-2]).startswith('dense_') and
          not str(keys[-3]).startswith('din_'))


def _batches(specs):
  batches = [synthetic_batch(specs, ['clk'], 64, seed=s) for s in range(5)]
  # DummyInput's shape of sequence: one token, the rest padding, so each
  # sequence feature's padding id collects 64 * 7 = 448 slots, more than
  # one chunk of K3
  for f in ('tag_brand_list', 'tag_category_list'):
    batches[1]['feat.%s.mask' % f][:, 1:] = 0.0
    batches[1]['feat.%s.ids' % f][:, 1:] = 0
  return batches


@pytest.mark.parametrize('fused,use_bn', [('1', False), ('0', False),
                                          ('1', True)])
def test_three_steps_match_jax_trainer(fused, use_bn, monkeypatch):
  """The port's Trainer, fused (K3's plain version) or not (K1 + K2), and
  the JAX Trainer with packed combined tables and f32 gradient sums, from
  the same state and batches.

  Tolerances, with their reasons. Losses: f32 in another order, relative
  2e-5. The JAX reference on the CPU updates through its XLA path and sums
  gradients in XLA's order; the port sums in its kernels' order (K3: 256
  slot chunks, then chunk sums), so the 448-slot padding rows differ by
  f32 rounding. Without BatchNorm: dense parameters within 5e-6, table
  rows within 1e-5 (w) and one bf16 ulp or 1e-9 (m, v). w is looser than
  the DeepFM slice's 1e-6 because attention gradients of history rows
  cancel to ~1e-11, below Adam's eps of 1e-8, where the step is lr * g /
  eps and keeps the relative f32 error of the cancelled sum (the same
  rows differ as much with K1 + K2). With BatchNorm,
  the Dense biases before it get a zero gradient up to rounding, so Adam
  moves them by +-lr on either side: they are held only to that bound,
  the running means that see them (1 - momentum 0.99 of each of 3 steps'
  batch means) to 6% of it, and the rest of the dense
  parameters, which see those biases before BatchNorm removes them, to
  1e-4; the tables to 1e-4 (w) and 3% or 2e-7 (m, v). Eval runs on running
  statistics that do not remove the biases, so its loss and AUC are
  compared without BatchNorm only."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', fused)
  t_cfg, j_cfg = _configs(bn=use_bn)
  jt = JTrainer(j_cfg, devices=jax.devices('cpu')[:1])
  assert jt.packed_mode and jt._packed_compact
  tt = TTrainer(t_cfg, device='cpu')
  batches = _batches(jt.specs)
  state = jt.init_state(batches[0])
  tt.init_state()
  tt.model.load_state_dict(convert.flax_to_state_dict(state.params,
                                                      state.batch_stats))
  for key, meta in jt.pack_metas.items():
    assert (meta.dim, meta.pack, meta.width) == (16, 4, 128)
    tt.tables[key].copy_(torch.from_numpy(convert.jax_packed_to_table(
        np.asarray(state.tables[key]), meta.dim, tt.metas[key].rows,
        meta.n_parts)))
  cpu = torch.device('cpu')
  calls = []
  real = tpt.rmw_fused
  monkeypatch.setattr(tpt, 'rmw_fused',
                      lambda *a: calls.append(1) or real(*a))
  kernels.reset_launches()
  for s in range(3):
    state, j_loss = jt.train_step(state, jt.rules.shard_batch(batches[s]))
    t_loss = tt.train_step(to_device(batches[s], cpu))
    np.testing.assert_allclose(float(t_loss['total_loss']),
                               float(j_loss['total_loss']), rtol=2e-5)
  assert int(tt.step) == int(state.step) == 3
  assert len(calls) == (3 if fused == '1' else 0)
  assert set(kernels.launch_counts().values()) == {0}     # CPU: plain

  params, stats = convert.state_dict_to_flax(tt.model.state_dict())
  j_params = jax.device_get(state.params)
  for path, got in jax.tree_util.tree_leaves_with_path(params):
    want = np.asarray(functools.reduce(lambda t, k: t[k.key], path,
                                       j_params))
    if use_bn and _bn_cancelled(path):
      assert np.abs(got - want).max() <= 2 * LR_SUM
    else:
      np.testing.assert_allclose(got, want, rtol=0,
                                 atol=1e-4 if use_bn else 5e-6,
                                 err_msg=jax.tree_util.keystr(path))
  j_stats = jax.device_get(state.batch_stats)
  for path, got in jax.tree_util.tree_leaves_with_path(stats):
    want = np.asarray(functools.reduce(lambda t, k: t[k.key], path,
                                       j_stats))
    atol = 0.06 * LR_SUM if path[-1].key == 'mean' else 1e-5
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=atol)

  for key, meta in jt.pack_metas.items():
    rows = tt.metas[key].rows
    seen = np.zeros(rows, bool)
    for b in batches[:3]:
      seen[t_emb.pack_ids(tt.layout, _torch(b))[key].numpy().ravel()] = True
    jw, (jm, jv) = jpt.unpack_host(np.asarray(state.tables[key]), meta,
                                   rows)
    tw, (tm, tv) = tpt.unpack_host(tt.tables[key].numpy(), tt.metas[key])
    np.testing.assert_allclose(tw, jw, rtol=0,
                               atol=1e-4 if use_bn else 1e-5)
    for got, want in ((tm, jm), (tv, jv)):
      np.testing.assert_allclose(got, want,
                                 rtol=0.03 if use_bn else 2.0 ** -7,
                                 atol=2e-7 if use_bn else 1e-9)
    # rows no batch pulled are bit-equal on both sides
    assert 0 < (~seen).sum() < rows
    for got, want in ((tw, jw), (tm, jm), (tv, jv)):
      np.testing.assert_array_equal(got[~seen].view(np.uint32),
                                    want[~seen].view(np.uint32))

  if not use_bn:
    j_eval = jt.evaluate(state, eval_iter=batches[3:])
    t_eval = tt.evaluate(eval_iter=batches[3:])
    # AUC from 8192-bin histograms: a probability a hair from a bin edge
    # may land one bin over
    np.testing.assert_allclose(t_eval['auc'], j_eval['auc'], atol=1e-3)
    np.testing.assert_allclose(t_eval['loss'], j_eval['loss'], rtol=2e-5)


def test_train_eval_cli_trains_the_small_din_fused_on_cpu(tmp_path):
  path = tmp_path / 'din.config'
  path.write_text(CONFIG % {'bn': 'true'})
  env = dict(os.environ, PYTHONPATH=REPO, EASYREC_PACKED_FUSED='1')
  r = subprocess.run([sys.executable, '-m', 'easyrec_torch.train_eval',
                      '--pipeline_config_path', str(path), '--device', 'cpu'],
                     cwd=REPO, env=env, capture_output=True, text=True,
                     timeout=300)
  assert r.returncode == 0, r.stderr[-3000:]
  losses = [float(x) for x in re.findall(r'step \d+: loss=([0-9.]+)',
                                         r.stderr)]
  assert len(losses) == 3 and all(np.isfinite(losses))
  m = re.search(r"done: step=3 metrics=\{'auc': ([0-9.]+)", r.stderr)
  assert m is not None, r.stderr[-3000:]
  assert 0.0 <= float(m.group(1)) <= 1.0
