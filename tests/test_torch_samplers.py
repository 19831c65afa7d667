"""The negative samplers of the port (easyrec_torch/data/samplers.py, a copy
of the JAX package's) and their splice into the input pipeline, against
the JAX package on the same files: each of the five samplers builds the
same alias tables and draws the same items and attrs, batch after batch;
a pipeline with a negative sampler, a V2 sampler and a hard-negative
sampler gives batches equal to the JAX pipeline's key for key, the
`neg.` and `hard_neg.` views and `hard_neg_mask` among them, in train and
eval (num_eval_sample), and none in predict. The item and edge writers
are tests/test_samples.py's."""

import os

import numpy as np
import pytest

from easyrec_torch.config import config_util as t_config
from easyrec_torch.data import input_pipeline as t_input
from easyrec_torch.data import samplers as t_samplers
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.data import input_pipeline as j_input
from easyrec_tpu.data import samplers as j_samplers
from tests.test_samples import (STANDARD_COLS, _write_csv, _write_edges,
                                _write_items)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SAMPLERS = {
    'negative_sampler': '''negative_sampler {
      input_path: "%(items)s" num_sample: 16 num_eval_sample: 8
      attr_fields: "iid" attr_fields: "cate" attr_fields: "price"
      item_id_field: "iid" }''',
    'negative_sampler_in_memory': '''negative_sampler_in_memory {
      input_path: "%(items)s" num_sample: 16
      attr_fields: "iid" attr_fields: "cate" attr_fields: "price"
      item_id_field: "iid" }''',
    'negative_sampler_v2': '''negative_sampler_v2 {
      user_input_path: "%(items)s" item_input_path: "%(items)s"
      pos_edge_input_path: "%(edges)s" num_sample: 16
      attr_fields: "iid" attr_fields: "cate"
      item_id_field: "iid" user_id_field: "uid" }''',
    'hard_negative_sampler': '''hard_negative_sampler {
      user_input_path: "%(items)s" item_input_path: "%(items)s"
      hard_neg_edge_input_path: "%(edges)s" num_sample: 16
      num_hard_sample: 4 attr_fields: "iid" attr_fields: "cate"
      item_id_field: "iid" user_id_field: "uid" }''',
    'hard_negative_sampler_v2': '''hard_negative_sampler_v2 {
      user_input_path: "%(items)s" item_input_path: "%(items)s"
      pos_edge_input_path: "%(edges)s"
      hard_neg_edge_input_path: "%(edges)s" num_sample: 16
      num_hard_sample: 2 attr_fields: "iid" attr_fields: "cate"
      item_id_field: "iid" user_id_field: "uid" }''',
}

CONFIG = '''
train_input_path: "%(train)s"
eval_input_path: "%(train)s"
train_config { optimizer_config { adam_optimizer { learning_rate {
  constant_learning_rate { learning_rate: 0.001 } } } } }
data_config {
  batch_size: 32
  num_epochs: 1
  label_fields: "label"
  input_fields { input_name: "label" input_type: FLOAT }
  input_fields { input_name: "uid" input_type: STRING }
  input_fields { input_name: "iid" input_type: STRING }
  input_fields { input_name: "cate" input_type: STRING }
  input_fields { input_name: "tags" input_type: STRING }
  input_fields { input_name: "age" input_type: FLOAT }
  input_fields { input_name: "price" input_type: FLOAT }
  input_fields { input_name: "seq_cate" input_type: STRING }
  %(sampler)s
}
feature_config {
  features { input_names: "uid" feature_type: IdFeature
             embedding_dim: 8 hash_bucket_size: 1000 }
  features { input_names: "iid" feature_type: IdFeature
             embedding_dim: 8 hash_bucket_size: 1000 }
  features { input_names: "cate" feature_type: IdFeature
             embedding_dim: 8 hash_bucket_size: 100 }
  features { input_names: "tags" feature_type: TagFeature
             embedding_dim: 8 hash_bucket_size: 100 max_multi_len: 3 }
  features { input_names: "price" feature_type: RawFeature
             embedding_dim: 8 }
  features { input_names: "seq_cate" feature_type: SequenceFeature
             embedding_dim: 8 hash_bucket_size: 100 max_seq_len: 5 }
}
model_config {
  model_class: "DSSM"
  feature_groups { group_name: "user" feature_names: ["uid", "tags"] }
  feature_groups { group_name: "item"
                   feature_names: ["iid", "cate", "price"] }
  dssm { user_tower { dnn { hidden_units: [8] } }
         item_tower { dnn { hidden_units: [8] } } }
  loss_type: SOFTMAX_CROSS_ENTROPY
}
'''


@pytest.fixture(scope='module')
def files(tmp_path_factory):
  d = tmp_path_factory.mktemp('sampler_data')
  paths = {'items': str(d / 'items.txt'), 'edges': str(d / 'edges.txt'),
           'train': str(d / 'train.csv')}
  _write_items(paths['items'])
  _write_edges(paths['edges'])
  # 100 rows: three full batches of 32 and a padded tail of 4
  _write_csv(paths['train'], STANDARD_COLS[:8], 100, seed=5)
  return paths


def _configs(which, files):
  text = CONFIG % dict(files, sampler=SAMPLERS[which] % files)
  return (t_config.get_configs_from_pipeline_str(text),
          j_config.get_configs_from_pipeline_str(text))


@pytest.mark.parametrize('which', sorted(SAMPLERS))
def test_sampler_draws_match_jax(which, files):
  """The same alias tables (prob, alias) and, over five batches of raw
  ids (with a repeated user and a padding id), the same negatives and
  attrs, and a hard sampler's same hard negatives and mask."""
  t_cfg, j_cfg = _configs(which, files)
  t_s = t_samplers.build(t_cfg.data_config, 'train')
  j_s = j_samplers.build(j_cfg.data_config, 'train')
  assert type(t_s).__name__ == type(j_s).__name__
  np.testing.assert_array_equal(t_s.alias.prob, j_s.alias.prob)
  np.testing.assert_array_equal(t_s.alias.alias, j_s.alias.alias)
  assert t_s.num_sample == j_s.num_sample == 16
  rng = np.random.default_rng(3)
  for _ in range(5):
    items = np.array(['i%d' % i for i in rng.integers(0, 40, 12)] + [0],
                     dtype=object)
    users = np.array(['u%d' % u for u in rng.integers(0, 30, 12)] + ['u3'],
                     dtype=object)
    got = t_s.sample(batch_item_ids=items, batch_user_ids=users)
    want = j_s.sample(batch_item_ids=items, batch_user_ids=users)
    assert sorted(got) == sorted(want)
    for k in want:
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if hasattr(j_s, 'sample_hard'):
      got, want = t_s.sample_hard(users), j_s.sample_hard(users)
      assert sorted(got) == sorted(want)
      for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
      assert want['hard_neg_mask'].sum() > 0


def test_eval_sample_count_and_predict(files):
  """num_eval_sample sizes the eval sampler; predict has none."""
  t_cfg, _ = _configs('negative_sampler', files)
  assert t_samplers.build(t_cfg.data_config, 'eval').num_sample == 8
  assert t_samplers.build(t_cfg.data_config, 'predict') is None


def test_item_table_guard(files, monkeypatch):
  """An item table above EASYREC_SAMPLER_MAX_GB is refused by name."""
  monkeypatch.setenv('EASYREC_SAMPLER_MAX_GB', '1e-9')
  t_cfg, _ = _configs('negative_sampler', files)
  with pytest.raises(MemoryError, match='items.txt'):
    t_samplers.build(t_cfg.data_config, 'train')


@pytest.mark.parametrize('which,mode', [
    ('negative_sampler', 'train'), ('negative_sampler', 'eval'),
    ('negative_sampler_v2', 'train'), ('hard_negative_sampler', 'train'),
    ('hard_negative_sampler_v2', 'eval'), ('negative_sampler', 'predict')])
def test_pipeline_batches_match_jax(which, mode, files):
  """Every batch of the port's pipeline equals the JAX pipeline's key for
  key, exactly, shuffled in train (the padded tail included)."""
  t_cfg, j_cfg = _configs(which, files)
  t_pipe = t_input.InputPipeline(
      t_cfg.data_config, t_config.get_feature_configs(t_cfg),
      files['train'], mode=mode, batch_size=32)
  j_pipe = j_input.InputPipeline(
      j_cfg.data_config, j_config.get_feature_configs(j_cfg),
      files['train'], mode=mode, batch_size=32)
  t_batches, j_batches = list(t_pipe), list(j_pipe)
  assert len(t_batches) == len(j_batches) == 4
  for got, want in zip(t_batches, j_batches):
    assert sorted(got) == sorted(want)
    for k in want:
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    views = {k.split('.', 1)[0] for k in got if k.startswith(
        ('neg.', 'hard_neg.'))}
    if mode == 'predict':
      assert not views
    else:
      n = 8 if mode == 'eval' and which == 'negative_sampler' else 16
      assert got['neg.feat.iid.ids'].shape == (n, 1)
      # the item-side features only: iid, cate, and price where the
      # sampler carries it
      assert {k.split('.')[2] for k in got if k.startswith('neg.')} == (
          {'iid', 'cate', 'price'} if 'price' in SAMPLERS[which]
          else {'iid', 'cate'})
      assert views == ({'neg', 'hard_neg'} if which.startswith('hard')
                       else {'neg'})
      if which.startswith('hard'):
        h = got['hard_neg_mask'].shape[1]
        assert got['hard_neg.feat.iid.ids'].shape == (32 * h, 1)


def test_process_neg_sampler_data_path(files):
  """The sampler's paths lose surrounding blanks, as the JAX package's
  process_neg_sampler_data_path strips them."""
  text = CONFIG % dict(files, sampler=SAMPLERS['hard_negative_sampler_v2']
                       .replace('"%(items)s"', '" %(items)s "') % files)
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  t_config.process_neg_sampler_data_path(t_cfg)
  j_config.process_neg_sampler_data_path(j_cfg)
  t_s = t_cfg.data_config.hard_negative_sampler_v2
  j_s = j_cfg.data_config.hard_negative_sampler_v2
  for field in ('user_input_path', 'item_input_path', 'pos_edge_input_path',
                'hard_neg_edge_input_path'):
    assert getattr(t_s, field) == getattr(j_s, field) == \
        getattr(j_s, field).strip()
  assert t_s.item_input_path == files['items']
