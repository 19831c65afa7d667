"""The rest of the sequence family in the port against the JAX package:
TagFeature batches (hashed, kv, a weight column, vocab, num_buckets),
numeric, boundary, vocab and num_buckets sequences, through the
transforms and a CSV pipeline; sequence_features sub-groups (aux_hist_seq,
seq_dnn, a padded or projected key, no key) in DeepFM and in
MultiTowerDIN, each flat-group sequence combiner and TextCNN, held against
flax with its parameters carried by convert.py; and three train steps of
a DeepFM with a sub-group and an attention combiner against the JAX
Trainer."""

import functools

import jax
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.data import input_pipeline as t_input
from easyrec_torch.features import feature_spec as t_fs
from easyrec_torch.features import transforms as t_tr
from easyrec_torch.layers import blocks as t_blocks
from easyrec_torch.models import base as t_base
from easyrec_torch.models import rank as t_rank  # noqa: F401 (registers)
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_torch.utils import synthetic as t_synth
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.data import input_pipeline as j_input
from easyrec_tpu.features import feature_spec as j_fs
from easyrec_tpu.features import transforms as j_tr
from easyrec_tpu.layers import blocks as j_blocks
from easyrec_tpu.models import base as j_base
from easyrec_tpu.models import zoo  # noqa: F401 (registers)
from easyrec_tpu.ops import embedding as j_emb
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.train.trainer import Trainer as JTrainer
from easyrec_tpu.utils.synthetic import synthetic_batch

# f32 on both sides; matmul, softmax and reduction orders differ (XLA vs
# ATen): a few ulp of relative error per layer
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def _specs(feature_text, max_tag_len=16):
  text = 'feature_config { %s }' % feature_text
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  return (t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg),
                                   max_tag_len=max_tag_len),
          j_fs.build_feature_specs(j_config.get_feature_configs(j_cfg),
                                   max_tag_len=max_tag_len))


def _same_transform(feature_text, columns, max_tag_len=16):
  t_specs, j_specs = _specs(feature_text, max_tag_len)
  for name, j in j_specs.items():
    t = t_specs[name]
    assert (t.kind, t.num_ids, t.rows, t.table_name, t.embedding_dim,
            t.is_weighted, t.seq_is_dense, t.value_dim, t.combiner) == \
        (j.kind, j.num_ids, j.rows, j.table_name, j.embedding_dim,
         j.is_weighted, j.seq_is_dense, j.value_dim, j.combiner), name
    got = t_tr.build_transform(t)(columns)
    want = j_tr.build_transform(j)(columns)
    assert sorted(got) == sorted(want)
    for k in want:
      assert got[k].dtype == want[k].dtype, k
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  return got


# -------------------------------------------------------------- features

TAGS = np.array(['', 'a', 'a|b|c', 'x||y|', '|'.join('t%d' % i for i in
                                                     range(12)),
                 'é|中|a b', '3|7|0|12'], dtype=object)


@pytest.mark.parametrize('scheme', [
    'hash_bucket_size: 97',
    'hash_bucket_size: 97 max_multi_len: 3',
    'vocab_list: ["a", "b", "t3", "中"]',
    'num_buckets: 10',
])
def test_tag_batches_match(scheme):
  """Tag ids by each vocab scheme, padded to max_multi_len (or
  max_tag_len 5), weight 1 on each piece and 0 on padding: empty rows and
  pieces, more pieces than slots, non-ascii text."""
  got = _same_transform(
      'features { input_names: "tags" feature_type: TagFeature '
      'embedding_dim: 4 %s }' % scheme, {'tags': TAGS}, max_tag_len=5)
  weights = got['feat.tags.weights']
  assert weights.shape[1] == (3 if 'max_multi_len' in scheme else 5)
  assert weights[0].sum() == 0 and weights[2].sum() == 3


def test_kv_tag_batches_match():
  """kv_separator: 'key:weight' pieces, a piece without the separator and
  one whose weight is not a number weigh 1.0, negative and float
  weights."""
  col = np.array(['', 'a:0.5', 'a:2|b:-1.5|c', 'x:y|z:0|:3',
                  '|'.join('k%d:%d' % (i, i) for i in range(10))], object)
  got = _same_transform(
      'features { input_names: "kv" feature_type: TagFeature '
      'kv_separator: ":" embedding_dim: 4 hash_bucket_size: 50 '
      'max_multi_len: 6 }', {'kv': col})
  np.testing.assert_array_equal(got['feat.kv.weights'][2, :3],
                                [2.0, -1.5, 1.0])


def test_tag_weight_column_matches():
  """A second input column of weights 'w1|w2', cut to the tags' slots;
  a weight that is not a number reads 1, an empty weight row zeroes its
  tags."""
  w = np.array(['', '0.5', '1|2|3', '4|x|5|6', '|'.join(['2'] * 12),
                '', '1|1|1|1'], dtype=object)
  got = _same_transform(
      'features { input_names: ["tags", "tag_w"] feature_type: TagFeature '
      'embedding_dim: 4 hash_bucket_size: 97 max_multi_len: 4 }',
      {'tags': TAGS, 'tag_w': w})
  assert got['feat.tags.weights'][5].sum() == 0.0


SEQ = np.array(['', '3', '1.5|7|-2', '0.3;1.2|4;5;6|x;2', '||',
                '|'.join(str(i) for i in range(20))], dtype=object)


@pytest.mark.parametrize('feature', [
    'sub_feature_type: RawFeature raw_input_dim: 2 seq_multi_sep: ";"',
    'sub_feature_type: RawFeature',
    'sub_feature_type: RawFeature boundaries: [0.0, 1.0, 5.0]',
    'num_buckets: 6',
    'vocab_list: ["3", "7", "x"]',
    'hash_bucket_size: 13',
])
def test_sequence_batches_match(feature):
  """Numeric sequences ([B, L, N] values split by seq_multi_sep, a mask
  over every position), boundary-bucketed values, and id sequences by
  num_buckets, vocab or hash, at max_seq_len 5."""
  got = _same_transform(
      'features { input_names: "s" feature_type: SequenceFeature '
      'embedding_dim: 4 max_seq_len: 5 %s }' % feature, {'s': SEQ})
  if 'boundaries' not in feature and 'RawFeature' in feature:
    assert got['feat.s.dense'].shape[1:] == (5, 2 if 'raw_input' in feature
                                             else 1)


def test_csv_pipeline_with_tags_and_numeric_sequences_matches(tmp_path):
  """A CSV through both input pipelines: hashed and kv tags, a weight
  column, a numeric sequence and a boundary sequence, max_tag_len from the
  data config."""
  rng = np.random.default_rng(1)
  lines = []
  for i in range(150):
    tags = '|'.join('t%d' % v for v in rng.integers(0, 30,
                                                    rng.integers(0, 9)))
    kv = '|'.join('k%d:%.2f' % (v, rng.random()) for v in
                  rng.integers(0, 30, rng.integers(0, 5)))
    w = '|'.join('%.1f' % rng.random() for _ in range(rng.integers(0, 9)))
    nums = '|'.join('%.2f;%.2f' % tuple(rng.random(2)) for _ in
                    range(rng.integers(0, 8)))
    lines.append('%d,%s,%s,%s,%s' % (i % 2, tags, kv, w, nums))
  path = tmp_path / 'tags.csv'
  path.write_text('\n'.join(lines) + '\n')
  text = '''
train_input_path: "%s"
data_config {
  batch_size: 32 label_fields: "clk" num_epochs: 1 max_tag_len: 6
  input_fields { input_name: "clk" input_type: FLOAT }
  input_fields { input_name: "tags" input_type: STRING }
  input_fields { input_name: "kv" input_type: STRING }
  input_fields { input_name: "w" input_type: STRING }
  input_fields { input_name: "nums" input_type: STRING }
}
feature_config {
  features { input_names: "tags" feature_type: TagFeature
             embedding_dim: 4 hash_bucket_size: 50 }
  features { input_names: "kv" feature_type: TagFeature kv_separator: ":"
             embedding_dim: 4 hash_bucket_size: 50 max_multi_len: 3 }
  features { feature_name: "tw" input_names: ["tags", "w"]
             feature_type: TagFeature embedding_dim: 4
             hash_bucket_size: 50 }
  features { input_names: "nums" feature_type: SequenceFeature
             sub_feature_type: RawFeature raw_input_dim: 2
             seq_multi_sep: ";" max_seq_len: 4 }
  features { feature_name: "nb" input_names: "nums"
             feature_type: SequenceFeature sub_feature_type: RawFeature
             boundaries: [0.25, 0.5, 0.75] embedding_dim: 4
             max_seq_len: 4 }
}
''' % path
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  t_pipe = t_input.InputPipeline(
      t_cfg.data_config, t_config.get_feature_configs(t_cfg), str(path))
  j_pipe = j_input.InputPipeline(
      j_cfg.data_config, j_config.get_feature_configs(j_cfg), str(path))
  n = 0
  for t_b, j_b in zip(t_pipe, j_pipe):
    assert sorted(t_b) == sorted(j_b)
    for k in j_b:
      assert t_b[k].dtype == j_b[k].dtype, k
      np.testing.assert_array_equal(t_b[k], j_b[k], err_msg=k)
    n += 1
  assert n == 5
  assert t_b['feat.tags.ids'].shape[1] == 6
  assert t_b['feat.nums.dense'].shape[1:] == (4, 2)


# -------------------------------------------------------- sequence groups

FEATURES = '''
feature_config {
  features { input_names: "uid" feature_type: IdFeature
             embedding_dim: 8 hash_bucket_size: 100 }
  features { input_names: "cate" feature_type: IdFeature
             embedding_dim: 8 hash_bucket_size: 50 }
  features { input_names: "tags" feature_type: TagFeature
             embedding_dim: 8 hash_bucket_size: 60 max_multi_len: 4 }
  features { input_names: "age" feature_type: RawFeature embedding_dim: 8 }
  features { input_names: "seq_cate" feature_type: SequenceFeature
             embedding_dim: 8 hash_bucket_size: 50 max_seq_len: 6
             %(combiner)s }
  features { input_names: "seq_iid" feature_type: SequenceFeature
             embedding_dim: 8 hash_bucket_size: 80 max_seq_len: 6 }
  features { input_names: "seq_num" feature_type: SequenceFeature
             sub_feature_type: RawFeature raw_input_dim: 2
             seq_multi_sep: ";" max_seq_len: 6 }
}'''

DEEPFM = '''
train_input_path: "synthetic"
eval_input_path: "synthetic"
train_config {
  optimizer_config { adam_optimizer { learning_rate {
    constant_learning_rate { learning_rate: 0.01 } } } }
  num_steps: 3
}
eval_config { metrics_set { auc {} } }
data_config { batch_size: 32 label_fields: "clk" input_type: DummyInput }
%(features)s
model_config {
  model_class: "DeepFM"
  feature_groups {
    group_name: "deep"
    feature_names: ["uid", "cate", "tags", "age"%(flat)s]
    wide_deep: DEEP
    %(sub)s
  }
  feature_groups { group_name: "wide" feature_names: ["uid", "cate"]
                   wide_deep: WIDE }
  deepfm {
    dnn { hidden_units: [16, 8] use_bn: false }
    final_dnn { hidden_units: [8] use_bn: false }
    l2_regularization: 1e-3
  }
  embedding_regularization: 1e-4
}
'''

SUB_GROUPS = {
    'basic': 'sequence_features { group_name: "sf" seq_att_map { '
             'key: "cate" hist_seq: "seq_cate" } }',
    'aux': 'sequence_features { group_name: "sf" seq_att_map { key: "cate" '
           'hist_seq: "seq_cate" aux_hist_seq: ["seq_iid", "seq_num"] } }',
    'seq_dnn': 'sequence_features { group_name: "sf" seq_dnn { '
               'hidden_units: [6, 1] activation: "tf.nn.tanh" } '
               'seq_att_map { key: "cate" hist_seq: "seq_cate" } }',
    # an 8-wide key against a 16-wide history: zero-padded
    'pad_key': 'sequence_features { group_name: "sf" allow_key_transform: '
               'true seq_att_map { key: "cate" hist_seq: ["seq_cate", '
               '"seq_iid"] } }',
    # the same with transform_dnn, and a key wider than its history: both
    # projected by Dense layers
    'dense_key': 'sequence_features { group_name: "sf" allow_key_transform: '
                 'true transform_dnn: true seq_att_map { key: "cate" '
                 'hist_seq: ["seq_cate", "seq_iid"] } }',
    'wide_key': 'sequence_features { group_name: "sf" allow_key_transform: '
                'true seq_att_map { key: ["uid", "cate"] hist_seq: '
                '"seq_cate" } }',
    'no_key': 'sequence_features { group_name: "sf" need_key_feature: false '
              'seq_att_map { key: "cate" hist_seq: "seq_cate" } }',
    # two sub-groups, one unnamed: scopes deep_sf and deep_seq
    'two': 'sequence_features { group_name: "sf" seq_att_map { key: "cate" '
           'hist_seq: "seq_cate" } } sequence_features { seq_att_map { '
           'key: "uid" hist_seq: "seq_iid" } }',
}

COMBINERS = {
    'mean': ('', ''),
    'attention': ('sequence_combiner { attention {} }', 'seqcomb_seq_cate_att'),
    'multi_head_attention': ('sequence_combiner { multi_head_attention {} }',
                             'seqcomb_seq_cate_mha'),
    'text_cnn': ('sequence_combiner { text_cnn { filter_sizes: [2, 3] '
                 'num_filters: [4, 5] } }', 'seqcomb_seq_cate_cnn'),
}


def _deepfm_text(sub='', combiner='', flat=()):
  return DEEPFM % {
      'features': FEATURES % {'combiner': combiner},
      'flat': ''.join(', "%s"' % f for f in flat), 'sub': sub}


def _batch(specs, seed):
  batch = synthetic_batch(specs, ['clk'], 32, seed=seed)
  for f in ('seq_cate', 'seq_iid'):
    batch['feat.%s.mask' % f][2] = 0.0           # all padding
    batch['feat.%s.ids' % f][2] = 0
  batch['feat.seq_num.mask'][3, 2:] = 0.0
  batch['feat.seq_num.dense'][3, 2:] = 0.0
  return batch


def _forward_matches(text, seed, want_modules=()):
  """flax's module and the port's model of `text` from one set of
  parameters: logits equal in train and eval mode; returns the state_dict
  keys."""
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  t_config.check_ported(t_cfg)
  j_specs = j_fs.build_feature_specs(j_config.get_feature_configs(j_cfg))
  t_specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  j_ctx = j_base.build_context(j_cfg, j_specs)
  t_ctx = t_base.build_context(t_cfg, t_specs)
  for key, j in j_ctx.layout.tables.items():
    t = t_ctx.layout.tables[key]
    assert [(u.feature, u.k, u.offset, u.start) for u in t.uses] == \
        [(u.feature, u.k, u.offset, u.start) for u in j.uses]
  module = j_base.create_model(j_ctx).make_module()
  t_model = t_base.create_model(t_ctx)
  rng = np.random.default_rng(seed)
  batch = _batch(j_specs, seed)
  t_b = t_synth.synthetic_batch(t_specs, ['clk'], 32, seed=seed)
  assert sorted(t_b) == sorted(batch)
  packs = j_emb.pack_ids(j_ctx.layout, batch)
  pulled = {k: rng.standard_normal(
      tuple(p.shape) + (t_ctx.layout.tables[k].dim,)).astype(np.float32)
            for k, p in packs.items()}
  variables = module.init({'params': jax.random.PRNGKey(0),
                           'dropout': jax.random.PRNGKey(0)},
                          batch, pulled, False)
  variables = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
          np.shape(a)).astype(np.float32), variables)
  sd = convert.flax_to_state_dict(variables['params'],
                                  variables.get('batch_stats'))
  for m in want_modules:
    assert any(k.startswith(m + '.') for k in sd), (m, sorted(sd))
  t_model.load_state_dict(sd)
  tb = {k: _t(v) for k, v in batch.items()}
  tp = {k: _t(v) for k, v in pulled.items()}
  for training in (True, False):
    want = module.apply(variables, batch, pulled, training,
                        mutable=['batch_stats', 'losses'])[0]
    # a train-mode forward moves BatchNorm's running statistics in place
    t_model.load_state_dict(sd)
    t_model.train(training)
    got = t_model(tb, tp)
    np.testing.assert_allclose(got['logits'].detach().numpy(),
                               np.asarray(want['logits']), **TOL)
  return sd


@pytest.mark.parametrize('variant', sorted(SUB_GROUPS))
def test_deepfm_sequence_features_match_flax(variant):
  """DeepFM's deep group with sequence_features sub-groups: the score
  net seq_dnn_<scope> (a DinAttention over [q, h, q-h, q*h]), aux
  histories weighted alike (an id and a numeric one), a custom seq_dnn, a
  key padded to the history or projected with it, no key (the history's
  masked mean queries it), two sub-groups, one unnamed."""
  scope = {'two': ('seq_dnn_deep_sf', 'seq_dnn_deep_seq')}.get(
      variant, ('seq_dnn_deep_sf',))
  extra = ('sequence_key_transform_deep_sf',
           'sequence_fea_transform_deep_sf') \
      if variant in ('dense_key', 'wide_key') else ()
  sd = _forward_matches(_deepfm_text(SUB_GROUPS[variant]), 21,
                        scope + extra)
  assert any('transform' in k for k in sd) == bool(extra)


@pytest.mark.parametrize('which', sorted(COMBINERS))
def test_flat_group_sequence_combiners_match_flax(which):
  """A sequence among the deep group's features, reduced by its
  SequenceCombiner (the masked mean by default, an attention, a
  multi-head self-attention then the masked mean, a TextCNN), beside a
  numeric sequence's masked mean."""
  combiner, name = COMBINERS[which]
  sd = _forward_matches(_deepfm_text(combiner=combiner,
                                     flat=('seq_cate', 'seq_num')), 22,
                        (name,) if name else ())
  assert any(k.startswith('seqcomb_') for k in sd) == bool(name)


DIN = '''
train_input_path: "synthetic"
eval_input_path: "synthetic"
train_config {
  optimizer_config { adam_optimizer { learning_rate {
    constant_learning_rate { learning_rate: 0.01 } } } }
  num_steps: 3
}
eval_config { metrics_set { auc {} } }
data_config { batch_size: 32 label_fields: "clk" input_type: DummyInput }
%(features)s
model_config {
  model_class: "MultiTowerDIN"
  feature_groups { group_name: "user" feature_names: ["uid", "tags"]
                   wide_deep: DEEP
                   sequence_features { group_name: "hist" seq_att_map {
                     key: "uid" hist_seq: "seq_iid" } } }
  feature_groups { group_name: "item" feature_names: ["cate", "age"]
                   wide_deep: DEEP }
  seq_att_groups {
    group_name: "din"
    %(seq_dnn)s
    seq_att_map { key: "cate" hist_seq: "seq_cate"
                  aux_hist_seq: ["seq_iid", "seq_num"] }
  }
  multi_tower {
    towers { input: "user" dnn { hidden_units: [16, 8] use_bn: false } }
    towers { input: "item" dnn { hidden_units: [16, 8] use_bn: false } }
    din_towers { input: "din" dnn { hidden_units: [8, 1] } }
    final_dnn { hidden_units: [8] use_bn: false }
  }
}
'''


@pytest.mark.parametrize('seq_dnn', [False, True])
def test_multi_tower_din_with_aux_seq_dnn_and_sub_groups_matches_flax(
    seq_dnn):
  """MultiTowerDIN: a tower group with a sequence_features sub-group
  (seq_dnn_user_hist), the DIN tower's aux histories weighted alike and
  appended, and, where set, the group's seq_dnn over the attended vector
  (a DNN with BatchNorm)."""
  text = DIN % {'features': FEATURES % {'combiner': ''},
                'seq_dnn': 'seq_dnn { hidden_units: [12, 6] }' if seq_dnn
                else ''}
  _forward_matches(text, 23, ('seq_dnn_user_hist', 'din_din') +
                   (('seq_dnn_din',) if seq_dnn else ()))


@pytest.mark.parametrize('filters', [((2, 3), (4, 5)), ((1, 4, 6), (3, 2, 1))])
def test_text_cnn_matches_flax(filters):
  """TextCNN: VALID 1-D convolutions (flax Conv kernel [W, Cin, Cout] to
  nn.Conv1d's [Cout, Cin, W] by the kernel transpose), relu, max over
  time, concatenated; the masked input."""
  sizes, nums = filters
  rng = np.random.default_rng(8)
  seq = rng.standard_normal((5, 6, 8)).astype(np.float32)
  mask = (rng.random((5, 6)) < 0.7).astype(np.float32)
  j_mod = j_blocks.TextCNN(filter_sizes=sizes, num_filters=nums)
  variables = j_mod.init(jax.random.PRNGKey(0), [seq, mask])
  variables = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
          np.shape(a)).astype(np.float32), variables)
  want = np.asarray(j_mod.apply(variables, [seq, mask]))
  t_mod = t_blocks.TextCNN(8, sizes, nums)
  t_mod.load_state_dict(convert.flax_to_state_dict(variables['params'],
                                                   root=None))
  assert tuple(t_mod.conv_0.weight.shape) == (nums[0], 8, sizes[0])
  got = t_mod(_t(seq), _t(mask)).detach().numpy()
  assert got.shape == (5, sum(nums))
  np.testing.assert_allclose(got, want, **TOL)
  back, _ = convert.state_dict_to_flax(t_mod.state_dict(), root=None)
  for name, leaves in variables['params'].items():
    for leaf, value in leaves.items():
      np.testing.assert_array_equal(back[name][leaf], value)


# --------------------------------------------------- three train steps


def test_three_steps_with_sub_group_and_combiner_match_jax_trainer(
    monkeypatch):
  """A DeepFM whose deep group holds a tag feature, an attention-combined
  sequence, a numeric sequence and a sub-group with an aux history: three
  steps of the port's Trainer (K1 + K2's plain versions) and the JAX
  Trainer from one state and batches; every dense parameter, the
  combiner's and the score net's included, within 2e-5, table weights
  within 2e-5 (the BST slice's tolerances and reasons)."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', '0')
  text = _deepfm_text(SUB_GROUPS['aux'],
                      COMBINERS['attention'][0], ('seq_cate', 'seq_num'))
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  jt = JTrainer(j_cfg, devices=jax.devices('cpu')[:1])
  tt = TTrainer(t_cfg, device='cpu')
  batches = [_batch(jt.specs, s) for s in range(3)]
  state = jt.init_state(batches[0])
  tt.init_state()
  tt.model.load_state_dict(convert.flax_to_state_dict(state.params,
                                                      state.batch_stats))
  for key, meta in jt.pack_metas.items():
    tt.tables[key].copy_(torch.from_numpy(convert.jax_packed_to_table(
        np.asarray(state.tables[key]), meta.dim, tt.metas[key].rows,
        meta.n_parts)))
  for b in batches:
    state, j_loss = jt.train_step(state, jt.rules.shard_batch(b))
    t_loss = tt.train_step(to_device(b, torch.device('cpu')))
    np.testing.assert_allclose(float(t_loss['total_loss']),
                               float(j_loss['total_loss']), rtol=2e-5)
  params, _ = convert.state_dict_to_flax(tt.model.state_dict())
  j_params = jax.device_get(state.params)
  names = set()
  for path, got in jax.tree_util.tree_leaves_with_path(params):
    want = np.asarray(functools.reduce(lambda t, k: t[k.key], path,
                                       j_params))
    names.add(path[1].key)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5,
                               err_msg=jax.tree_util.keystr(path))
  assert {'seqcomb_seq_cate_att', 'seq_dnn_deep_sf'} <= names
  for key, meta in jt.pack_metas.items():
    rows = tt.metas[key].rows
    jw, _ = jpt.unpack_host(np.asarray(state.tables[key]), meta, rows)
    tw, _ = tpt.unpack_host(tt.tables[key].numpy(), tt.metas[key])
    np.testing.assert_allclose(tw, jw, rtol=0, atol=2e-5)
