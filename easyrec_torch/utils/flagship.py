"""The flagship benchmark model: a Criteo-shaped DeepFM.

Counterpart of easyrec_tpu/utils/flagship.py (criteo_deepfm_config): the
reference's headline deepfm_on_criteo config, 13 raw + 26 id features,
16-dim embeddings, 1M hash buckets per id feature, batch 4096. All features
feed both the deep and the wide group, so the wide weights merge into the
deep table: one fused table of 26,000,014 rows, physical dim 32.
"""

from __future__ import annotations

from easyrec_torch.config.config_util import get_configs_from_pipeline_str


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
