"""The benchmark models: a Criteo-shaped DeepFM and the Taobao DIN.

Counterpart of easyrec_tpu/utils/flagship.py:
  - criteo_deepfm_config: the reference's headline deepfm_on_criteo config,
    13 raw + 26 id features, 16-dim embeddings, 1M hash buckets per id
    feature, batch 4096. All features feed both the deep and the wide
    group, so the wide weights merge into the deep table: one fused table
    of 26,000,014 rows, physical dim 32.
  - criteo_deepfm_adagrad_config: the same model and tables trained with
    the two-optimizer pairing of samples/multi_optimizer_freeze.config
    (:7-17), without its freeze_gradient: an Adagrad (constant lr 0.05,
    embedding_learning_rate_multiplier 0.5) drives the table, which holds
    [w | accum], and the flagship's Adam the dense weights.
  - taobao_din_config (:202-221): the reference's din_on_taobao config,
    MultiTowerDIN over 15 id features plus price (num_buckets 50) and two
    behaviour sequences of max_seq_len 50, dim 16, batch 4096: one fused
    dim-16 table of about 620k rows.
"""

from __future__ import annotations

from easyrec_torch.config.config_util import get_configs_from_pipeline_str
from easyrec_torch.config.text_format import parse


def criteo_deepfm_config(batch_size: int = 4096,
                         hash_bucket_size: int = 1000000,
                         embedding_dim: int = 16,
                         num_dense: int = 13,
                         num_cat: int = 26,
                         model_dir: str = ''):
  fields = ['input_fields { input_name: "label" input_type: FLOAT }']
  features = []
  deep, wide = [], []
  for i in range(1, num_dense + 1):
    fields.append(
        'input_fields { input_name: "F%d" input_type: FLOAT }' % i)
    features.append(
        'features { input_names: "F%d" feature_type: RawFeature '
        'embedding_dim: %d min_val: 0.0 max_val: 1000.0 }' %
        (i, embedding_dim))
    deep.append('feature_names: "F%d"' % i)
    wide.append('feature_names: "F%d"' % i)
  for i in range(1, num_cat + 1):
    fields.append(
        'input_fields { input_name: "C%d" input_type: STRING }' % i)
    features.append(
        'features { input_names: "C%d" feature_type: IdFeature '
        'embedding_dim: %d hash_bucket_size: %d }' %
        (i, embedding_dim, hash_bucket_size))
    deep.append('feature_names: "C%d"' % i)
    wide.append('feature_names: "C%d"' % i)
  text = """
train_input_path: "synthetic"
eval_input_path: "synthetic"
model_dir: "%s"
train_config {
  log_step_count_steps: 100
  optimizer_config {
    adam_optimizer {
      learning_rate {
        exponential_decay_learning_rate {
          initial_learning_rate: 0.001
          decay_steps: 1000
          decay_factor: 0.5
          min_learning_rate: 0.00001
        }
      }
    }
  }
  num_steps: 1000
}
eval_config { metrics_set { auc {} } }
data_config {
  batch_size: %d
  label_fields: "label"
  %s
  input_type: DummyInput
  separator: "\\t"
}
feature_config {
  %s
}
model_config {
  model_class: "DeepFM"
  feature_groups {
    group_name: "deep"
    %s
    wide_deep: DEEP
  }
  feature_groups {
    group_name: "wide"
    %s
    wide_deep: WIDE
  }
  deepfm {
    dnn { hidden_units: [256, 128, 64] }
    final_dnn { hidden_units: [256, 128, 64] }
  }
  embedding_regularization: 1e-5
}
""" % (model_dir, batch_size, '\n  '.join(fields), '\n  '.join(features),
       '\n    '.join(deep), '\n    '.join(wide))
  return get_configs_from_pipeline_str(text)


_ADAGRAD_TABLES = """
optimizer_config {
  adagrad_optimizer {
    learning_rate { constant_learning_rate { learning_rate: 0.05 } }
  }
  embedding_learning_rate_multiplier: 0.5
}
"""


def criteo_deepfm_adagrad_config(**kwargs):
  """criteo_deepfm_config(**kwargs) with an Adagrad first in
  optimizer_config: with two optimizers the first drives the tables and
  the second, the flagship's Adam, the dense weights."""
  cfg = criteo_deepfm_config(**kwargs)
  tables = parse(_ADAGRAD_TABLES, 'TrainConfig').optimizer_config[0]
  tc = cfg.train_config
  tc.optimizer_config = [tables] + list(tc.optimizer_config)
  return cfg


# Taobao ad-display schema (din/bst/mmoe_on_taobao.config): 15 id features
# with the reference's bucket sizes, price num_buckets 50, and two behavior
# sequences (brand / category) of max_seq_len 50.
_TAOBAO_ID_FEATURES = [
    ('pid', 10), ('adgroup_id', 100000), ('cate_id', 10000),
    ('campaign_id', 100000), ('customer', 100000), ('brand', 100000),
    ('user_id', 100000), ('cms_segid', 100), ('cms_group_id', 100),
    ('final_gender_code', 10), ('age_level', 10), ('pvalue_level', 10),
    ('shopping_level', 10), ('occupation', 10),
    ('new_user_class_level', 10),
]
_TAOBAO_USER = ['user_id', 'cms_segid', 'cms_group_id', 'age_level',
                'pvalue_level', 'shopping_level', 'occupation',
                'new_user_class_level']
_TAOBAO_ITEM = ['adgroup_id', 'cate_id', 'campaign_id', 'customer',
                'brand', 'price', 'pid']


def _taobao_schema(seq_len: int, embedding_dim: int, labels):
  fields, features = [], []
  for name in labels:
    fields.append(
        'input_fields { input_name: "%s" input_type: FLOAT }' % name)
  for name, buckets in _TAOBAO_ID_FEATURES:
    fields.append(
        'input_fields { input_name: "%s" input_type: STRING }' % name)
    features.append(
        'features { input_names: "%s" feature_type: IdFeature '
        'embedding_dim: %d hash_bucket_size: %d }' %
        (name, embedding_dim, buckets))
  fields.append('input_fields { input_name: "price" input_type: INT32 }')
  features.append(
      'features { input_names: "price" feature_type: IdFeature '
      'embedding_dim: %d num_buckets: 50 }' % embedding_dim)
  for name, buckets in (('tag_category_list', 10000),
                        ('tag_brand_list', 100000)):
    fields.append(
        'input_fields { input_name: "%s" input_type: STRING }' % name)
    features.append(
        'features { input_names: "%s" feature_type: SequenceFeature '
        'separator: "|" embedding_dim: %d hash_bucket_size: %d '
        'max_seq_len: %d }' % (name, embedding_dim, buckets, seq_len))
  return fields, features


def _taobao_pipeline(model_block: str, labels, batch_size: int,
                     seq_len: int, embedding_dim: int, model_dir: str):
  fields, features = _taobao_schema(seq_len, embedding_dim, labels)
  return get_configs_from_pipeline_str("""
train_input_path: "synthetic"
eval_input_path: "synthetic"
model_dir: "%s"
train_config {
  log_step_count_steps: 100
  optimizer_config {
    adam_optimizer {
      learning_rate {
        exponential_decay_learning_rate {
          initial_learning_rate: 0.001
          decay_steps: 1000
          decay_factor: 0.5
          min_learning_rate: 0.00001
        }
      }
    }
  }
  num_steps: 1000
}
eval_config { metrics_set { auc {} } }
data_config {
  batch_size: %d
  %s
  %s
  input_type: DummyInput
  separator: ","
}
feature_config {
  %s
}
model_config {
%s
  embedding_regularization: 5e-5
}
""" % (model_dir, batch_size,
       '\n  '.join('label_fields: "%s"' % l for l in labels),
       '\n  '.join(fields), '\n  '.join(features), model_block))


def _tower_groups():
  return """
  feature_groups {
    group_name: "user"
    %s
    wide_deep: DEEP
  }
  feature_groups {
    group_name: "item"
    %s
    wide_deep: DEEP
  }""" % ('\n    '.join('feature_names: "%s"' % f for f in _TAOBAO_USER),
          '\n    '.join('feature_names: "%s"' % f for f in _TAOBAO_ITEM))


def taobao_din_config(batch_size: int = 4096, seq_len: int = 50,
                      embedding_dim: int = 16, model_dir: str = ''):
  """MultiTowerDIN on the Taobao schema (din_on_taobao.config)."""
  model = """  model_class: "MultiTowerDIN"
%s
  seq_att_groups {
    group_name: "din"
    seq_att_map { key: "brand" hist_seq: "tag_brand_list" }
    seq_att_map { key: "cate_id" hist_seq: "tag_category_list" }
  }
  multi_tower {
    towers { input: "user" dnn { hidden_units: [256, 128, 96, 64] } }
    towers { input: "item" dnn { hidden_units: [256, 128, 96, 64] } }
    din_towers { input: "din" dnn { hidden_units: [128, 64, 32, 1] } }
    final_dnn { hidden_units: [128, 96, 64, 32, 16] }
    l2_regularization: 5e-7
  }""" % _tower_groups()
  return _taobao_pipeline(model, ['clk'], batch_size, seq_len,
                          embedding_dim, model_dir)
