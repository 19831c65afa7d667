"""The port's forward pass (easyrec_torch/layers, models) against the JAX
package's flax modules with the same weights carried across by
easyrec_torch/convert.py: DNN with BatchNorm in train and eval mode, FM,
and the whole DeepFM forward with its input layer."""

import jax
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.features import feature_spec as t_fs
from easyrec_torch.layers import dnn as t_dnn
from easyrec_torch.layers import interaction as t_inter
from easyrec_torch.models import base as t_base
from easyrec_torch.models import rank as t_rank  # noqa: F401 (registers)
from easyrec_torch.ops import embedding as t_emb
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.features import feature_spec as j_fs
from easyrec_tpu.layers import dnn as j_dnn
from easyrec_tpu.layers import interaction as j_inter
from easyrec_tpu.models import base as j_base
from easyrec_tpu.models import zoo  # noqa: F401 (registers)
from easyrec_tpu.ops import embedding as j_emb
from easyrec_tpu.utils.synthetic import synthetic_batch

# f32 on both sides; matmul and reduction orders differ (XLA vs ATen), a
# few ulp of relative error per layer
TOL = dict(rtol=1e-5, atol=1e-5)


def _torch(batch):
  return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          batch.items()}


def test_dnn_batchnorm_train_and_eval_match_flax():
  rng = np.random.default_rng(0)
  x = (rng.standard_normal((32, 12)) * 3 + 1).astype(np.float32)
  j_mod = j_dnn.DNN(hidden_units=(16, 8), use_bn=True)
  variables = j_mod.init(jax.random.PRNGKey(0), x, False)
  # non-trivial BatchNorm parameters and running statistics
  variables = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + rng.random(np.shape(a)).astype(np.float32),
      variables)
  t_mod = t_dnn.DNN(12, (16, 8), use_bn=True)
  t_mod.load_state_dict(convert.flax_to_state_dict(
      variables['params'], variables['batch_stats'], root=None))
  # train mode: batch statistics, running averages updated with the
  # BIASED batch variance and momentum 0.99
  want, mutated = j_mod.apply(variables, x, True, mutable=['batch_stats'])
  t_mod.train()
  got = t_mod(torch.from_numpy(x))
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             **TOL)
  _, stats = convert.state_dict_to_flax(t_mod.state_dict(), root=None)
  for layer, st in mutated['batch_stats'].items():
    for k in ('mean', 'var'):
      np.testing.assert_allclose(stats[layer][k], np.asarray(st[k]),
                                 rtol=1e-6, atol=1e-6)
  # eval mode: the updated running statistics
  variables = {'params': variables['params'],
               'batch_stats': mutated['batch_stats']}
  want = j_mod.apply(variables, x, False)
  t_mod.eval()
  np.testing.assert_allclose(t_mod(torch.from_numpy(x)).detach().numpy(),
                             np.asarray(want), **TOL)


def test_dense_init_follows_flax_defaults():
  """lecun_normal kernels (truncated normal, std 1/sqrt(fan_in)), zero
  biases, BatchNorm scale 1 / bias 0 / mean 0 / var 1."""
  gen = torch.Generator().manual_seed(0)
  mod = t_dnn.DNN(400, (300,), use_bn=True, generator=gen)
  w = mod.dense_0.weight.detach().numpy()
  assert w.shape == (300, 400)
  assert abs(w.std() * np.sqrt(400) - 1.0) < 0.02
  assert np.abs(w).max() <= 2.0 / np.sqrt(400) / 0.8796 + 1e-6
  assert not mod.dense_0.bias.detach().numpy().any()
  sd = mod.state_dict()
  np.testing.assert_array_equal(sd['bn_0.weight'].numpy(), 1.0)
  np.testing.assert_array_equal(sd['bn_0.running_var'].numpy(), 1.0)


@pytest.mark.parametrize('variant', [True, False])
def test_fm_matches_flax(variant):
  x = np.random.default_rng(1).standard_normal((8, 5, 4)).astype(np.float32)
  want = j_inter.FM(use_variant=variant).apply({}, x)
  got = t_inter.FM(use_variant=variant)(torch.from_numpy(x))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=1e-5)


CONFIG = '''
data_config {
  batch_size: 32 label_fields: "label" input_type: DummyInput
  input_fields { input_name: "label" input_type: FLOAT }
  input_fields { input_name: "F1" input_type: FLOAT }
  input_fields { input_name: "F2" input_type: FLOAT }
  input_fields { input_name: "C1" input_type: STRING }
  input_fields { input_name: "C2" input_type: STRING }
  input_fields { input_name: "C3" input_type: STRING }
}
feature_config {
  features { input_names: "F1" feature_type: RawFeature embedding_dim: 8
             min_val: 0.0 max_val: 1.0 }
  features { input_names: "F2" feature_type: RawFeature }
  features { input_names: "C1" feature_type: IdFeature embedding_dim: 8
             hash_bucket_size: 100 }
  features { input_names: "C2" feature_type: IdFeature embedding_dim: 8
             hash_bucket_size: 50 combiner: "mean" }
  features { input_names: "C3" feature_type: IdFeature embedding_dim: 8
             hash_bucket_size: 70 }
}
model_config {
  model_class: "DeepFM"
  feature_groups { group_name: "deep" feature_names: ["F1", "F2", "C1",
                   "C2", "C3"] wide_deep: DEEP }
  feature_groups { group_name: "wide" feature_names: ["C1", "C2", "C3"]
                   wide_deep: WIDE }
  deepfm { dnn { hidden_units: [16, 8] } %s }
}
'''


@pytest.mark.parametrize('final', ['final_dnn { hidden_units: [8] }', ''])
def test_deepfm_forward_matches_flax(final):
  """Input layer (merged wide-into-deep table, raw-projection and dense
  features, sum and mean combiners), FM, DNN and the logit, with the flax
  params carried across; train mode (BatchNorm batch statistics) and eval
  mode."""
  text = CONFIG % final
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  j_specs = j_fs.build_feature_specs(j_config.get_feature_configs(j_cfg))
  t_specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  j_ctx = j_base.build_context(j_cfg, j_specs)
  t_ctx = t_base.build_context(t_cfg, t_specs)
  assert {k: (t.rows, t.dim, t.used_dim) for k, t in
          t_ctx.layout.tables.items()} == \
      {k: (t.rows, t.dim, t.used_dim) for k, t in
       j_ctx.layout.tables.items()}
  module = j_base.create_model(j_ctx).make_module()
  t_model = t_base.create_model(t_ctx)

  rng = np.random.default_rng(2)
  batch = synthetic_batch(j_specs, ['label'], 32, seed=3)
  batch['feat.C2.weights'][::3] = 0.0        # padding slots
  j_packs = j_emb.pack_ids(j_ctx.layout, batch)
  t_packs = t_emb.pack_ids(t_ctx.layout, _torch(batch))
  for k in j_packs:
    np.testing.assert_array_equal(t_packs[k].numpy(), np.asarray(j_packs[k]))
  pulled = {k: rng.standard_normal(
      tuple(p.shape) + (t_ctx.layout.tables[k].dim,)).astype(np.float32)
            for k, p in j_packs.items()}
  variables = module.init({'params': jax.random.PRNGKey(0),
                           'dropout': jax.random.PRNGKey(0)},
                          batch, pulled, False)
  variables = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * rng.random(np.shape(a)).astype(
          np.float32), variables)
  t_model.load_state_dict(convert.flax_to_state_dict(
      variables['params'], variables['batch_stats']))

  want, mutated = module.apply(variables, batch, pulled, True,
                               mutable=['batch_stats', 'losses'])
  t_model.train()
  got = t_model(_torch(batch), _torch(pulled))
  for k in ('logits', 'probs'):
    np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                               err_msg=k, **TOL)
  params, stats = convert.state_dict_to_flax(t_model.state_dict())
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


def test_dropout_is_not_ported():
  """DNN's dropout_ratio, refused before the backbone slice, now builds:
  in eval the tower is the one without dropout, and in training it draws
  its mask from the generator set_generator gives it, never from torch's
  global one (no generator: it raises)."""
  torch.manual_seed(0)
  with_drop = t_dnn.DNN(4, (8, 2), use_bn=False, dropout_ratio=(0.5,))
  plain = t_dnn.DNN(4, (8, 2), use_bn=False)
  plain.load_state_dict(with_drop.state_dict())
  x = torch.randn(16, 4)
  with_drop.eval()
  assert torch.equal(with_drop(x), plain(x))
  with_drop.train()
  with pytest.raises(RuntimeError, match='generator'):
    with_drop(x)
  t_dnn.set_generator(with_drop, torch.Generator().manual_seed(1))
  first = with_drop(x)
  t_dnn.set_generator(with_drop, torch.Generator().manual_seed(1))
  assert torch.equal(with_drop(x), first)
