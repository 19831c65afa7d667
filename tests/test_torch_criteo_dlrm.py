"""The Criteo DLRM of the port (easyrec_torch/utils/flagship.py
criteo_dlrm_config): benchmarks/quality.py's DLRM on the flagship DeepFM's
schema and settings, its full-width layout and widths, and three train
steps of it at a narrow width against the JAX Trainer on the CPU."""

import os
import sys

import torch

from easyrec_torch.config import config_util as t_config
from easyrec_torch.config import text_format as t_text
from easyrec_torch.features import feature_spec as t_fs
from easyrec_torch.models import base as t_base
from easyrec_torch.utils import flagship as t_flagship
from easyrec_tpu.config import config_util as j_config
from tests.test_torch_rank_zoo_train import (_check_params, _check_tables,
                                             _run_both)


def _quality_dlrm_model_config():
  sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..',
                                  'benchmarks'))
  import quality  # noqa: E402
  mm = {'min': [0.0] * 13, 'max': [1000.0] * 13}
  text = quality.criteo_config('dlrm', 'tr', 'te', mm, '')
  return j_config.get_configs_from_pipeline_str(text).model_config


def test_criteo_dlrm_config_is_the_quality_harness_dlrm():
  """flagship.criteo_dlrm_config holds benchmarks/quality.py's DLRM block
  (groups dense and sparse of 13 raw and 26 id features, bot_dnn
  [64, 32, 16], top_dnn [256, 128, 64], embedding_regularization 1e-5) on
  the flagship DeepFM's schema and settings; at full width one table of
  26,000,014 rows at dim 16 and 39 id slots an example (the 13 raw
  features' rows among them), and bot_dnn's 16 is the embedding dim, so
  no bot_proj."""
  t_cfg = t_flagship.criteo_dlrm_config()
  q = _quality_dlrm_model_config()
  mc = t_cfg.model_config
  assert mc.model_class == q.model_class == 'DLRM'
  assert [(g.group_name, len(g.feature_names), g.wide_deep)
          for g in mc.feature_groups] == \
      [('dense', 13, 'DEEP'), ('sparse', 26, 'DEEP')]
  assert [(g.group_name, len(g.feature_names)) for g in q.feature_groups] \
      == [('dense', 13), ('sparse', 26)]
  for part in ('bot_dnn', 'top_dnn'):
    assert list(getattr(mc.dlrm, part).hidden_units) == \
        list(getattr(q.dlrm, part).hidden_units)
  assert (mc.dlrm.arch_interaction_op, mc.dlrm.arch_interaction_itself,
          mc.dlrm.arch_with_dense_feature) == \
      (q.dlrm.arch_interaction_op, q.dlrm.arch_interaction_itself,
       q.dlrm.arch_with_dense_feature)
  assert mc.embedding_regularization == q.embedding_regularization
  deepfm = t_flagship.criteo_deepfm_config()
  assert t_text.to_text(t_cfg.data_config) == \
      t_text.to_text(deepfm.data_config)
  assert t_text.to_text(t_cfg.train_config) == \
      t_text.to_text(deepfm.train_config)
  assert t_text.to_text(t_cfg.feature_config) == \
      t_text.to_text(deepfm.feature_config)
  specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  ctx = t_base.build_context(t_cfg, specs)
  assert {k: (t.rows, t.dim, t.tot_k) for k, t in
          ctx.layout.tables.items()} == {'emb16': (26000014, 16, 39)}
  model = t_base.create_model(ctx)
  assert model.bot_dnn.dense_0.in_features == 13 * 16
  assert not hasattr(model, 'bot_proj')
  # 27 fields: 351 pairs, then the 26 x 16 sparse embeddings
  assert model.top_dnn.dense_0.in_features == 27 * 26 // 2 + 26 * 16


def test_small_criteo_dlrm_three_steps_match_jax_trainer(monkeypatch):
  """criteo_dlrm_config at a narrow width (3 raw and 6 id features of 1,000
  buckets, dim 8, batch 64) through both Trainers, written out by the
  port's text writer and read by the JAX package: three steps with its
  BatchNorm and the flagship's schedule, held as tests/test_torch_slice.py
  holds the DeepFM with BatchNorm (the Dense biases before a BatchNorm
  within 2 lr a step, the rest of the dense parameters 1e-4, table
  weights 1e-4 and moments 3% or 2e-7)."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', '0')
  t_cfg = t_flagship.criteo_dlrm_config(batch_size=64, hash_bucket_size=1000,
                                        embedding_dim=8, num_dense=3,
                                        num_cat=6)
  j_cfg = j_config.get_configs_from_pipeline_str(t_text.to_text(t_cfg))
  jt, tt, state = _run_both(j_cfg, t_cfg, ['label'])
  assert tuple(tt.model.bot_proj.weight.shape) == (8, 16)
  lr_sum = sum(float(tt.dense_pair.schedule(torch.tensor(s)))
               for s in range(3))
  _check_params(tt, state, True, lr_sum)
  _check_tables(jt, tt, state, 1e-4)


