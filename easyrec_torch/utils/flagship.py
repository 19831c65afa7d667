"""The benchmark models: a Criteo-shaped DeepFM and DLRM, and the Taobao DIN,
BST and MMoE.

Counterpart of easyrec_tpu/utils/flagship.py:
  - criteo_deepfm_config: the reference's headline deepfm_on_criteo config,
    13 raw + 26 id features, 16-dim embeddings, 1M hash buckets per id
    feature, batch 4096. All features feed both the deep and the wide
    group, so the wide weights merge into the deep table: one fused table
    of 26,000,014 rows, physical dim 32.
  - criteo_dlrm_config: the DLRM of benchmarks/quality.py (:150-160) on
    the same schema: groups `dense` (the 13 raw features) and `sparse`
    (the 26 id features), no wide group, so one table of 26,000,014 rows
    at dim 16.
  - criteo_dlrm_backbone_config: the backbone of samples/
    dlrm_backbone.config (the reference's dlrm_backbone_on_criteo.config:
    bottom_mlp MLP [64, 32, 16] over `dense`, the `sparse` input layer's
    [2d, feature list], their DotInteraction, [sparse_2d, dot] into
    top_mlp [256, 128, 64] and the logit) as model_class RankModel, on
    criteo_dlrm_config's schema, groups and table.
  - criteo_deepfm_adagrad_config: the same model and tables trained with
    the two-optimizer pairing of samples/multi_optimizer_freeze.config
    (:7-17), without its freeze_gradient: an Adagrad (constant lr 0.05,
    embedding_learning_rate_multiplier 0.5) drives the table, which holds
    [w | accum], and the flagship's Adam the dense weights.
  - taobao_din_config (:202-221): the reference's din_on_taobao config,
    MultiTowerDIN over 15 id features plus price (num_buckets 50) and two
    behaviour sequences of max_seq_len 50, dim 16, batch 4096: one fused
    dim-16 table of about 620k rows.
  - taobao_bst_config (:224-243): bst_on_taobao, the same schema and
    tables, MultiTowerBST whose transformer runs over the two histories
    (hidden 32, 4 heads, FFN 128) with the target at their head.
  - taobao_mmoe_config (:246-282): mmoe_on_taobao, the same schema with
    two labels (clk, buy) and tables; all 18 features in one DEEP group
    `all` (the sequences through their default sum combiner: 288 wide), 4
    experts of [256, 192, 128, 64], towers ctr (clk) and cvr (buy) of
    [256, 192, 128, 64].
  - dssm_neg_sampler_config: samples/dssm_neg_sampler.config (two
    towers [256, 128, 64] at dim 16, uid and iid of 1,000,000 buckets,
    batch 1,024 with 1,024 negatives a step drawn from items.txt) at its
    published widths on a data directory's train.csv, eval.csv and
    items.txt (chip_smoke.py's write_dssm_data makes them).
"""

from __future__ import annotations

import os

from easyrec_torch.config.config_util import (
    get_configs_from_pipeline_file, get_configs_from_pipeline_str)
from easyrec_torch.config.text_format import parse


def _criteo_pipeline(model_block: str, batch_size: int,
                     hash_bucket_size: int, embedding_dim: int,
                     num_dense: int, num_cat: int, model_dir: str):
  """The flagship Criteo schema and training settings around a
  model_config body; its groups name the features by
  `%(dense)s` (F1..F13) and `%(cat)s` (C1..C26), each a run of
  feature_names lines."""
  fields = ['input_fields { input_name: "label" input_type: FLOAT }']
  features = []
  dense, cat = [], []
  for i in range(1, num_dense + 1):
    fields.append(
        'input_fields { input_name: "F%d" input_type: FLOAT }' % i)
    features.append(
        'features { input_names: "F%d" feature_type: RawFeature '
        'embedding_dim: %d min_val: 0.0 max_val: 1000.0 }' %
        (i, embedding_dim))
    dense.append('feature_names: "F%d"' % i)
  for i in range(1, num_cat + 1):
    fields.append(
        'input_fields { input_name: "C%d" input_type: STRING }' % i)
    features.append(
        'features { input_names: "C%d" feature_type: IdFeature '
        'embedding_dim: %d hash_bucket_size: %d }' %
        (i, embedding_dim, hash_bucket_size))
    cat.append('feature_names: "C%d"' % i)
  body = model_block % {'dense': '\n    '.join(dense),
                        'cat': '\n    '.join(cat)}
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
%s
  embedding_regularization: 1e-5
}
""" % (model_dir, batch_size, '\n  '.join(fields), '\n  '.join(features),
       body)
  return get_configs_from_pipeline_str(text)


_DEEPFM = """  model_class: "DeepFM"
  feature_groups {
    group_name: "deep"
    %(dense)s
    %(cat)s
    wide_deep: DEEP
  }
  feature_groups {
    group_name: "wide"
    %(dense)s
    %(cat)s
    wide_deep: WIDE
  }
  deepfm {
    dnn { hidden_units: [256, 128, 64] }
    final_dnn { hidden_units: [256, 128, 64] }
  }"""

# benchmarks/quality.py:150-160 (the DLRM of its Criteo runs)
_DLRM = """  model_class: "DLRM"
  feature_groups {
    group_name: "dense"
    %(dense)s
    wide_deep: DEEP
  }
  feature_groups {
    group_name: "sparse"
    %(cat)s
    wide_deep: DEEP
  }
  dlrm {
    bot_dnn { hidden_units: [64, 32, 16] }
    top_dnn { hidden_units: [256, 128, 64] }
  }"""


def criteo_deepfm_config(batch_size: int = 4096,
                         hash_bucket_size: int = 1000000,
                         embedding_dim: int = 16,
                         num_dense: int = 13,
                         num_cat: int = 26,
                         model_dir: str = ''):
  return _criteo_pipeline(_DEEPFM, batch_size, hash_bucket_size,
                          embedding_dim, num_dense, num_cat, model_dir)


def criteo_dlrm_config(batch_size: int = 4096,
                       hash_bucket_size: int = 1000000,
                       embedding_dim: int = 16,
                       num_dense: int = 13,
                       num_cat: int = 26,
                       model_dir: str = ''):
  """The DLRM that benchmarks/quality.py trains on Criteo (its model block,
  :150-160: groups `dense` and `sparse`, bot_dnn [64, 32, 16], top_dnn
  [256, 128, 64], embedding_regularization 1e-5) on the flagship's
  schema and settings (criteo_deepfm_config's: 13 raw features embedded
  at dim 16 after min/max normalisation, 26 id features of 1M buckets,
  batch 4096, Adam with exponential decay). No wide group: one fused
  table of 26,000,014 rows at dim 16."""
  return _criteo_pipeline(_DLRM, batch_size, hash_bucket_size,
                          embedding_dim, num_dense, num_cat, model_dir)


# samples/dlrm_backbone.config's backbone (its header: the reference's
# dlrm_backbone_on_criteo.config) on the flagship's dense / sparse groups
_DLRM_BACKBONE = """  model_class: "RankModel"
  feature_groups {
    group_name: "dense"
    %(dense)s
    wide_deep: DEEP
  }
  feature_groups {
    group_name: "sparse"
    %(cat)s
    wide_deep: DEEP
  }
  backbone {
    blocks {
      name: "bottom_mlp"
      inputs { feature_group_name: "dense" }
      keras_layer { class_name: "MLP"
                    mlp { hidden_units: [64, 32, 16] } }
    }
    blocks {
      name: "sparse"
      inputs { feature_group_name: "sparse" }
      input_layer { output_2d_tensor_and_feature_list: true }
    }
    blocks {
      name: "dot"
      inputs { block_name: "bottom_mlp" input_fn: "lambda x: [x]" }
      inputs { block_name: "sparse" input_fn: "lambda x: x[1]" }
      keras_layer { class_name: "DotInteraction" }
    }
    blocks {
      name: "sparse_2d"
      inputs { block_name: "sparse" input_fn: "lambda x: x[0]" }
    }
    concat_blocks: ["sparse_2d", "dot"]
    top_mlp { hidden_units: [256, 128, 64] }
  }"""


def criteo_dlrm_backbone_config(batch_size: int = 4096,
                                hash_bucket_size: int = 1000000,
                                embedding_dim: int = 16,
                                num_dense: int = 13,
                                num_cat: int = 26,
                                model_dir: str = ''):
  """The DLRM of samples/dlrm_backbone.config built by the backbone DSL
  (model_class RankModel) on criteo_dlrm_config's schema and settings:
  the same groups, so the same one fused table of 26,000,014 rows at dim
  16; the bottom MLP reads the 13 embedded raw features (208 wide), the
  dot interaction 27 fields (351 pairs), top_mlp 767 columns."""
  return _criteo_pipeline(_DLRM_BACKBONE, batch_size, hash_bucket_size,
                          embedding_dim, num_dense, num_cat, model_dir)


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


def taobao_bst_config(batch_size: int = 4096, seq_len: int = 50,
                      embedding_dim: int = 16, model_dir: str = ''):
  """MultiTowerBST on the Taobao schema (bst_on_taobao.config): the two
  histories concatenate into hidden 32, 4 heads, the target at the head of
  seq_len + 1 tokens."""
  model = """  model_class: "MultiTowerBST"
%s
  seq_att_groups {
    group_name: "bst"
    seq_att_map { key: "brand" hist_seq: "tag_brand_list" }
    seq_att_map { key: "cate_id" hist_seq: "tag_category_list" }
  }
  multi_tower {
    towers { input: "user" dnn { hidden_units: [256, 128, 96, 64] } }
    towers { input: "item" dnn { hidden_units: [256, 128, 96, 64] } }
    bst_towers { input: "bst" seq_len: %d multi_head_size: 4 }
    final_dnn { hidden_units: [128, 96, 64, 32, 16] }
    l2_regularization: 5e-7
  }""" % (_tower_groups(), seq_len)
  return _taobao_pipeline(model, ['clk'], batch_size, seq_len,
                          embedding_dim, model_dir)


def taobao_mmoe_config(batch_size: int = 4096, seq_len: int = 50,
                       embedding_dim: int = 16, model_dir: str = ''):
  """MMoE (ctr+cvr towers) on the Taobao schema (mmoe_on_taobao.config)."""
  all_feats = ([n for n, _ in _TAOBAO_ID_FEATURES] + ['price'] +
               ['tag_category_list', 'tag_brand_list'])
  model = """  model_class: "MMoE"
  feature_groups {
    group_name: "all"
    %s
    wide_deep: DEEP
  }
  mmoe {
    expert_dnn { hidden_units: [256, 192, 128, 64] }
    num_expert: 4
    task_towers {
      tower_name: "ctr"
      label_name: "clk"
      dnn { hidden_units: [256, 192, 128, 64] }
      num_class: 1
      weight: 1.0
      loss_type: CLASSIFICATION
      metrics_set { auc {} }
    }
    task_towers {
      tower_name: "cvr"
      label_name: "buy"
      dnn { hidden_units: [256, 192, 128, 64] }
      num_class: 1
      weight: 1.0
      loss_type: CLASSIFICATION
      metrics_set { auc {} }
    }
    l2_regularization: 1e-6
  }""" % '\n    '.join('feature_names: "%s"' % f for f in all_feats)
  return _taobao_pipeline(model, ['clk', 'buy'], batch_size, seq_len,
                          embedding_dim, model_dir)


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def dssm_neg_sampler_config(data_dir: str, model_dir: str = ''):
  """samples/dssm_neg_sampler.config as published, reading train.csv,
  eval.csv and items.txt of `data_dir`."""
  cfg = get_configs_from_pipeline_file(
      os.path.join(_REPO, 'samples', 'dssm_neg_sampler.config'))
  cfg.train_input_path = os.path.join(data_dir, 'train.csv')
  cfg.eval_input_path = os.path.join(data_dir, 'eval.csv')
  cfg.data_config.negative_sampler.input_path = os.path.join(data_dir,
                                                             'items.txt')
  cfg.model_dir = model_dir
  return cfg
