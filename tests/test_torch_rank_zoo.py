"""The classic rank zoo of the port (WideAndDeep, DCN, AutoInt, DLRM, FM,
RocketLaunching; easyrec_torch/models/rank.py, layers/interaction.py)
against the JAX package on the CPU: CrossNet and DotInteraction, and each
model's forward from one set of flax weights carried across by
convert.py (tests/test_torch_rank_zoo_train.py trains them)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.features import feature_spec as t_fs
from easyrec_torch.layers import interaction as t_inter
from easyrec_torch.models import base as t_base
from easyrec_torch.models import rank as t_rank  # noqa: F401 (registers)
from easyrec_torch.ops import embedding as t_emb
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.features import feature_spec as j_fs
from easyrec_tpu.layers import interaction as j_inter
from easyrec_tpu.models import base as j_base
from easyrec_tpu.models import zoo  # noqa: F401 (registers)
from easyrec_tpu.utils.synthetic import synthetic_batch

# f32 on both sides; matmul and reduction orders differ (XLA vs ATen), a
# few ulp of relative error per layer
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULP = 2.0 ** -7


def _torch(batch):
  return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          batch.items()}


# ------------------------------------------------------------- layers


def test_cross_net_matches_flax():
  """x_{l+1} = x0 (x_l w_l) + b_l + x_l with flax's w_<i> [d, 1] and
  b_<i> [d] carried as they are."""
  rng = np.random.default_rng(0)
  x = rng.standard_normal((16, 12)).astype(np.float32)
  j_mod = j_inter.CrossNet(num_layers=3)
  params = j_mod.init(jax.random.PRNGKey(0), x)['params']
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))
      .astype(np.float32), params)
  t_mod = t_inter.CrossNet(12, num_layers=3)
  t_mod.load_state_dict(convert.flax_to_state_dict(params, root=None))
  got = t_mod(torch.from_numpy(x)).detach().numpy()
  np.testing.assert_allclose(got, np.asarray(j_mod.apply(
      {'params': params}, x)), **TOL)
  back, _ = convert.state_dict_to_flax(t_mod.state_dict(), root=None)
  assert sorted(back) == sorted(params)


def test_cross_net_init_follows_flax():
  """glorot-uniform over [d, 1] (limit sqrt(6 / (d + 1))), zero biases."""
  d = 400
  mod = t_inter.CrossNet(d, num_layers=2,
                         generator=torch.Generator().manual_seed(0))
  limit = np.sqrt(6.0 / (d + 1))
  for i in range(2):
    w = getattr(mod, 'w_%d' % i).detach().numpy()
    assert w.shape == (d, 1)
    assert np.abs(w).max() <= limit
    assert abs(w.std() * np.sqrt(3.0) / limit - 1.0) < 0.1
    assert not getattr(mod, 'b_%d' % i).detach().numpy().any()


@pytest.mark.parametrize('self_interaction', [False, True])
def test_dot_interaction_matches_flax(self_interaction):
  """The upper triangle of X X^T in jnp.triu_indices' order (row-major,
  k=1; k=0 with the diagonal)."""
  f = 5
  rows, cols = torch.triu_indices(f, f, offset=0 if self_interaction else 1)
  j_rows, j_cols = jnp.triu_indices(f, k=0 if self_interaction else 1)
  np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
  np.testing.assert_array_equal(cols.numpy(), np.asarray(j_cols))
  x = np.random.default_rng(1).standard_normal((8, f, 4)).astype(np.float32)
  want = j_inter.DotInteraction(self_interaction=self_interaction).apply(
      {}, x)
  got = t_inter.DotInteraction(self_interaction)(torch.from_numpy(x))
  assert got.shape == (8, f * (f + 1) // 2 if self_interaction
                       else f * (f - 1) // 2)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------- models

SCHEMA = '''
train_input_path: "unused"
eval_input_path: "unused"
train_config {
  optimizer_config { adam_optimizer { learning_rate {
    exponential_decay_learning_rate { initial_learning_rate: 0.01
      decay_steps: 2 decay_factor: 0.5 min_learning_rate: 0.004 } } } }
  num_steps: 3
}
eval_config { metrics_set { auc {} } metrics_set { max_f1 {} } }
data_config {
  batch_size: 64 label_fields: "label" input_type: DummyInput
  input_fields { input_name: "label" input_type: FLOAT }
  input_fields { input_name: "F1" input_type: FLOAT }
  input_fields { input_name: "F2" input_type: FLOAT }
  input_fields { input_name: "C1" input_type: STRING }
  input_fields { input_name: "C2" input_type: STRING }
  input_fields { input_name: "C3" input_type: STRING }
  input_fields { input_name: "C4" input_type: STRING }
  input_fields { input_name: "T1" input_type: STRING }
  input_fields { input_name: "S1" input_type: STRING }
}
feature_config {
  features { input_names: "F1" feature_type: RawFeature embedding_dim: 8
             min_val: 0.0 max_val: 1.0 }
  features { input_names: "F2" feature_type: RawFeature }
  features { input_names: "C1" feature_type: IdFeature embedding_dim: 8
             hash_bucket_size: 500 }
  features { input_names: "C2" feature_type: IdFeature embedding_dim: 8
             hash_bucket_size: 300 combiner: "mean" }
  features { input_names: "C3" feature_type: IdFeature embedding_dim: 8
             hash_bucket_size: 200 }
  features { input_names: "C4" feature_type: IdFeature embedding_dim: 8
             hash_bucket_size: 100 }
  features { input_names: "T1" feature_type: TagFeature embedding_dim: 8
             hash_bucket_size: 100 max_multi_len: 3 }
  features { input_names: "S1" feature_type: SequenceFeature
             embedding_dim: 8 hash_bucket_size: 200 max_seq_len: 6 }
}
model_config {
%(model)s
  embedding_regularization: 1e-4
}
'''

SEQ_GROUP = '''sequence_features { group_name: "seq_fea"
                       seq_att_map { key: "C1" hist_seq: "S1" } }'''

# each model's small form; %(bn)s switches BatchNorm in every DNN
MODELS = {
    'wide_and_deep': '''  model_class: "WideAndDeep"
  feature_groups { group_name: "deep"
                   feature_names: ["F1", "F2", "C1", "C2", "C3", "T1"]
                   wide_deep: DEEP }
  feature_groups { group_name: "wide" feature_names: ["C1", "C2", "C4"]
                   wide_deep: WIDE }
  wide_and_deep { dnn { hidden_units: [16, 8] use_bn: %(bn)s }
                  l2_regularization: 1e-3 }''',
    'wide_and_deep_final': '''  model_class: "WideAndDeep"
  feature_groups { group_name: "deep"
                   feature_names: ["F1", "F2", "C1", "C2", "C3"]
                   wide_deep: DEEP }
  feature_groups { group_name: "wide" feature_names: ["C1", "C4"]
                   wide_deep: WIDE }
  wide_and_deep { dnn { hidden_units: [16, 8] use_bn: %(bn)s }
                  final_dnn { hidden_units: [8] use_bn: %(bn)s }
                  wide_output_dim: 4 }''',
    'dcn': '''  model_class: "DCN"
  feature_groups { group_name: "all"
                   feature_names: ["F1", "F2", "C1", "C2", "C3", "T1"]
                   wide_deep: DEEP
                   %(seq)s }
  dcn { deep_tower { input: "all" dnn { hidden_units: [16, 8]
                                         use_bn: %(bn)s } }
        cross_tower { input: "all" cross_num: 2 }
        final_dnn { hidden_units: [8] use_bn: %(bn)s }
        l2_regularization: 1e-3 }''',
    'dcn_two_groups': '''  model_class: "DCN"
  feature_groups { group_name: "deep"
                   feature_names: ["F1", "C1", "C2", "S1"]
                   wide_deep: DEEP }
  feature_groups { group_name: "cross"
                   feature_names: ["F2", "C3", "C4"] wide_deep: DEEP }
  dcn { deep_tower { input: "deep" dnn { hidden_units: [16, 8]
                                          use_bn: %(bn)s } }
        cross_tower { input: "cross" }
        final_dnn { hidden_units: [8] use_bn: %(bn)s } }''',
    'autoint': '''  model_class: "AutoInt"
  feature_groups { group_name: "all"
                   feature_names: ["F1", "F2", "C1", "C2", "C3", "C4", "T1"]
                   wide_deep: DEEP
                   %(seq)s }
  autoint { multi_head_num: 2 multi_head_size: 8
            interacting_layer_num: 2 }''',
    'dlrm': '''  model_class: "DLRM"
  feature_groups { group_name: "dense" feature_names: ["F1", "F2"]
                   wide_deep: DEEP }
  feature_groups { group_name: "sparse"
                   feature_names: ["C1", "C2", "C3", "C4", "T1"]
                   wide_deep: DEEP }
  dlrm { bot_dnn { hidden_units: [16, 4] use_bn: %(bn)s }
         top_dnn { hidden_units: [16, 8] use_bn: %(bn)s } }''',
    'dlrm_self_dense': '''  model_class: "DLRM"
  feature_groups { group_name: "dense" feature_names: ["F1", "F2"]
                   wide_deep: DEEP }
  feature_groups { group_name: "sparse" feature_names: ["C1", "C2", "C3"]
                   wide_deep: DEEP }
  dlrm { bot_dnn { hidden_units: [16, 8] use_bn: %(bn)s }
         top_dnn { hidden_units: [8] use_bn: %(bn)s }
         arch_interaction_itself: true arch_with_dense_feature: true }''',
    'dlrm_cat': '''  model_class: "DLRM"
  feature_groups { group_name: "dense" feature_names: ["F1", "F2"]
                   wide_deep: DEEP }
  feature_groups { group_name: "sparse" feature_names: ["C1", "C2", "C3"]
                   wide_deep: DEEP }
  dlrm { bot_dnn { hidden_units: [8] use_bn: %(bn)s }
         top_dnn { hidden_units: [8] use_bn: %(bn)s }
         arch_interaction_op: "cat" }''',
    'fm': '''  model_class: "FM"
  feature_groups { group_name: "deep"
                   feature_names: ["F1", "C1", "C2", "C3", "T1"]
                   wide_deep: DEEP }
  feature_groups { group_name: "wide" feature_names: ["C1", "C4"]
                   wide_deep: WIDE }
  fm {}''',
    'rocket_launching': '''  model_class: "RocketLaunching"
  feature_groups { group_name: "all"
                   feature_names: ["F1", "F2", "C1", "C2", "C3", "T1"]
                   wide_deep: DEEP }
  rocket_launching {
    share_dnn { hidden_units: [16] use_bn: %(bn)s }
    booster_dnn { hidden_units: [16, 8, 8] }
    light_dnn { hidden_units: [16, 8] }
    feature_based_distillation: true }''',
    'rocket_euclid': '''  model_class: "RocketLaunching"
  feature_groups { group_name: "all" feature_names: ["F1", "C1", "C2", "C4"]
                   wide_deep: DEEP }
  rocket_launching {
    booster_dnn { hidden_units: [8, 8] }
    light_dnn { hidden_units: [8] }
    feature_based_distillation: true
    feature_distillation_function: EUCLID }''',
    'deepfm_uncertainty': '''  model_class: "DeepFM"
  feature_groups { group_name: "deep"
                   feature_names: ["F1", "F2", "C1", "C2", "C3"]
                   wide_deep: DEEP }
  feature_groups { group_name: "wide" feature_names: ["C1", "C2"]
                   wide_deep: WIDE }
  deepfm { dnn { hidden_units: [16, 8] use_bn: %(bn)s } }
  losses { loss_type: CLASSIFICATION weight: 1.0 }
  losses { loss_type: BINARY_FOCAL_LOSS weight: 0.5
           binary_focal_loss { gamma: 2.0 alpha: 0.85 } }
  loss_weight_strategy: Uncertainty''',
}


def _text(model, bn=True, seq=True):
  block = MODELS[model] % {'bn': 'true' if bn else 'false',
                           'seq': SEQ_GROUP if seq else ''}
  return SCHEMA % {'model': block}


def _configs(model, bn=True, seq=True):
  text = _text(model, bn, seq)
  return (t_config.get_configs_from_pipeline_str(text),
          j_config.get_configs_from_pipeline_str(text))


def _contexts(t_cfg, j_cfg):
  t_specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  j_specs = j_fs.build_feature_specs(j_config.get_feature_configs(j_cfg))
  t_ctx = t_base.build_context(t_cfg, t_specs)
  j_ctx = j_base.build_context(j_cfg, j_specs)
  assert {k: (t.rows, t.dim, t.used_dim, t.offsets) for k, t in
          t_ctx.layout.tables.items()} == \
      {k: (t.rows, t.dim, t.used_dim, t.offsets) for k, t in
       j_ctx.layout.tables.items()}
  return t_ctx, j_ctx, j_specs


def _check_forward(model, monkeypatch=None, impl=None):
  """One seeded batch and pulled rows through the JAX module and the port
  from the same perturbed flax variables: every output (and Rocket's
  booster logits and hidden layers) in train mode, BatchNorm's updated
  statistics, then the logits in eval mode."""
  t_cfg, j_cfg = _configs(model)
  t_ctx, j_ctx, j_specs = _contexts(t_cfg, j_cfg)
  module = j_base.create_model(j_ctx).make_module()
  t_model = t_base.create_model(t_ctx)
  rng = np.random.default_rng(2)
  batch = synthetic_batch(j_specs, ['label'], 32, seed=3)
  batch['feat.C2.weights'][::3] = 0.0        # padding slots
  pulled = {k: rng.standard_normal(
      tuple(p.shape) + (t_ctx.layout.tables[k].dim,)).astype(np.float32)
            for k, p in t_emb.pack_ids(t_ctx.layout, _torch(batch)).items()}
  variables = module.init({'params': jax.random.PRNGKey(0),
                           'dropout': jax.random.PRNGKey(0)},
                          batch, pulled, False)
  variables = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * rng.random(np.shape(a)).astype(
          np.float32), variables)
  sd = convert.flax_to_state_dict(variables['params'],
                                  variables.get('batch_stats'))
  assert sorted(sd) == sorted(t_model.state_dict()), (
      sorted(set(sd) ^ set(t_model.state_dict())))
  t_model.load_state_dict(sd)
  want, mutated = module.apply(variables, batch, pulled, True,
                               mutable=['batch_stats', 'losses'])
  t_model.train()
  got = t_model(_torch(batch), _torch(pulled))
  keys = sorted(k for k in want if k not in ('light_hidden',
                                             'booster_hidden'))
  assert sorted(got) == sorted(want)
  for k in keys:
    np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                               err_msg=k, **TOL)
  for k in ('light_hidden', 'booster_hidden'):
    for a, b in zip(got.get(k, []), want.get(k, [])):
      np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                 err_msg=k, **TOL)
  params, stats = convert.state_dict_to_flax(t_model.state_dict())
  jax.tree_util.tree_map(
      lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                              atol=1e-6),
      stats, dict(mutated.get('batch_stats', {})))
  assert jax.tree_util.tree_structure(params) == \
      jax.tree_util.tree_structure(jax.tree_util.tree_map(
          np.asarray, dict(variables['params'])))
  variables = dict(variables)
  if 'batch_stats' in mutated:
    variables['batch_stats'] = mutated['batch_stats']
  want = module.apply(variables, batch, pulled, False)
  t_model.eval()
  got = t_model(_torch(batch), _torch(pulled))
  np.testing.assert_allclose(got['logits'].detach().numpy(),
                             np.asarray(want['logits']), **TOL)
  # the serving outputs
  j_model = j_base.create_model(j_ctx)
  assert sorted(t_model.export_outputs(got)) == \
      sorted(j_model.export_outputs(want))
  return t_model


@pytest.mark.parametrize('model', sorted(MODELS))
def test_forward_matches_flax(model):
  t_model = _check_forward(model)
  names = dict(t_model.named_parameters())
  if model.startswith('dlrm'):
    assert ('bot_proj.weight' in names) == (model == 'dlrm')
  if model == 'autoint':
    # the sequence sub-group's score net and projection under their
    # unscoped flax names
    assert 'seq_dnn_seq_fea.att_dnn.dense_0.weight' in names
    assert 'seq_proj_seq_fea.weight' in names
    # 2 heads of 8 on 8-wide fields: the first layer's residual projects
    assert 'interact_0.res.weight' in names
    assert 'interact_1.res.weight' not in names
  if model == 'deepfm_uncertainty':
    assert tuple(names['loss_uncertainty'].shape) == (2,)


@pytest.mark.parametrize('impl', ['stock', 'vpu_bf16'])
def test_autoint_forward_under_each_attention_impl(impl, monkeypatch):
  """AutoInt's interacting layers are plain einsums in the JAX package
  whatever EASYREC_ATTN_IMPL says (it picks PackedMHA's payloads, which
  AutoInt does not use), so the forward holds within 1e-5 under both."""
  monkeypatch.setenv('EASYREC_ATTN_IMPL', impl)
  _check_forward('autoint')


def test_dcn_renders_a_shared_group_once():
  """Both towers read group `all`, whose sequence sub-group's parameters
  exist once (flax: one seq_dnn_all_seq_fea); the cross net's width is
  the group's whole width."""
  t_cfg, j_cfg = _configs('dcn')
  t_ctx, _, _ = _contexts(t_cfg, j_cfg)
  model = t_base.create_model(t_ctx)
  names = [n for n, _ in model.named_parameters()]
  assert sum(n.startswith('seq_dnn_all_seq_fea.') for n in names) > 0
  assert not any(n.startswith('seq_dnn_seq_fea') for n in names)
  # 8 (F1) + 1 (F2) + 4 x 8 + [attended 8, key 8]
  assert tuple(model.cross.w_0.shape) == (57, 1)
  assert model.deep.dense_0.in_features == 57
