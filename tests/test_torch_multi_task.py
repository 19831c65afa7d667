"""The multi-task family of the port against the JAX package on the CPU:
the layers (BatchedExperts, MMoE, CGCLayer) and their per-expert init
scale, every tower loss, the forward and loss of SimpleMultiTask, MMoE (both
expert forms), ESMM, DBMTL and PLE with flax parameters carried across by
convert.py, an MMoE export against the JAX export, and the multi-output
paths of main.py, the Predictor and the server. Training against the JAX
Trainer is in tests/test_torch_multi_task_train.py."""

import csv
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch import main as t_main
from easyrec_torch.config import config_util as t_config
from easyrec_torch.export import predictor as t_predictor
from easyrec_torch.export import saved_model as t_sm
from easyrec_torch.features import feature_spec as t_fs
from easyrec_torch.layers import multi_task as t_mt
from easyrec_torch.losses import losses as t_losses
from easyrec_torch.models import base as t_base
from easyrec_torch.models import multi_task as t_models  # noqa: F401
from easyrec_torch.ops import embedding as t_emb
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.serving.client import PredictClient
from easyrec_torch.serving.server import PredictorService
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_torch.utils import flagship as t_flagship
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.export import predictor as j_predictor
from easyrec_tpu.export import saved_model as j_sm
from easyrec_tpu.features import feature_spec as j_fs
from easyrec_tpu.layers import multi_task as j_mt
from easyrec_tpu.losses import losses as j_losses
from easyrec_tpu.models import base as j_base
from easyrec_tpu.models import zoo  # noqa: F401 (registers)
from easyrec_tpu.ops import embedding as j_emb
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.train import restore as j_restore
from easyrec_tpu.train.trainer import Trainer as JTrainer
from easyrec_tpu.utils import flagship as j_flagship
from easyrec_tpu.utils.synthetic import synthetic_batch
from tests.test_torch_config import _assert_same

# f32 on both sides; matmul, softmax and reduction orders differ (XLA vs
# ATen), and the port's experts add a layer's products in another order
TOL = 1e-5
LABELS = ['clk', 'buy']
COLUMNS = ['clk', 'buy', 'user_id', 'brand', 'cate_id', 'price',
           'tag_brand_list', 'tag_category_list']

SCHEMA = '''
train_input_path: "%(data)s"
eval_input_path: "%(data)s"
model_dir: "%(model_dir)s"
train_config {
  optimizer_config { adam_optimizer { learning_rate {
    exponential_decay_learning_rate { initial_learning_rate: 0.01
      decay_steps: 2 decay_factor: 0.5 min_learning_rate: 0.004 } } } }
  num_steps: 3
  log_step_count_steps: 1
}
eval_config { metrics_set { auc {} } }
data_config {
  batch_size: 64 label_fields: "clk" label_fields: "buy"
  input_type: %(input_type)s
  input_fields { input_name: "clk" input_type: FLOAT }
  input_fields { input_name: "buy" input_type: FLOAT }
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
%(model)s
  embedding_regularization: 1e-4
}
'''

ALL_GROUP = '''
  feature_groups {
    group_name: "all"
    feature_names: ["user_id", "brand", "cate_id", "price",
                    "tag_brand_list", "tag_category_list"]
    wide_deep: DEEP
  }'''
SEQ_GROUP = '''
  feature_groups {
    group_name: "all"
    feature_names: ["user_id", "brand", "cate_id", "price"]
    wide_deep: DEEP
    sequence_features {
      group_name: "seq"
      seq_att_map { key: "brand" hist_seq: "tag_brand_list" }
      seq_att_map { key: "cate_id" hist_seq: "tag_category_list" }
    }
  }'''
TWO_GROUPS = '''
  feature_groups { group_name: "user" feature_names: "user_id"
                   wide_deep: DEEP }
  feature_groups {
    group_name: "item"
    feature_names: ["brand", "cate_id", "price", "tag_brand_list"]
    wide_deep: DEEP
  }'''


def _tower(name, label, extra=''):
  return ('task_towers { tower_name: "%s" label_name: "%s" '
          'dnn { hidden_units: [8] use_bn: %%(bn)s } %s }' % (name, label,
                                                            extra))


# Each model's block, with %(bn)s for its DNNs' use_bn. Between them they
# run every tower loss and option: task-space reweighting, towers without
# sample weights, a loss list with focal and F1 losses, DBMTL's relation
# DAG with an order-calibrate loss, PLE's named and unnamed layers, the
# deprecated experts form, ESMM's groups, and a group with sequence
# sub-groups as well as one with sequences in its feature list.
MODELS = {
    'simple_multi_task': ALL_GROUP + '''
  model_class: "SimpleMultiTask"
  simple_multi_task {
    %s
    %s
    %s
    l2_regularization: 1e-3
  }''' % (_tower('ctr', 'clk'),
          _tower('cvr', 'buy', 'task_space_indicator_label: "clk" '
                 'in_task_space_weight: 2.0 out_task_space_weight: 0.5 '
                 'use_sample_weight: false loss_type: SIGMOID_L2_LOSS'),
          _tower('aux', 'buy', 'weight: 0.5 '
                 'losses { loss_type: BINARY_FOCAL_LOSS weight: 0.7 '
                 'binary_focal_loss { gamma: 1.5 alpha: 0.25 '
                 'label_smoothing: 0.1 ohem_ratio: 0.5 } } '
                 'losses { loss_type: F1_REWEIGHTED_LOSS '
                 'f1_reweighted_loss { f1_beta_square: 2.0 } } '
                 'losses { loss_type: L2_LOSS weight: 0.1 }')),
    'mmoe': ALL_GROUP + '''
  model_class: "MMoE"
  mmoe {
    expert_dnn { hidden_units: [16, 8] }
    num_expert: 3
    %s
    %s
    l2_regularization: 1e-3
  }''' % (_tower('ctr', 'clk'), _tower('cvr', 'buy')),
    'mmoe_experts': SEQ_GROUP + '''
  model_class: "MMoE"
  mmoe {
    experts { expert_name: "e0" dnn { hidden_units: [16, 8]
                                     activation: "tanh" } }
    experts { expert_name: "e1" dnn { hidden_units: [16, 8] } }
    %s
    %s
  }''' % (_tower('ctr', 'clk'), _tower('cvr', 'buy')),
    'esmm': TWO_GROUPS + '''
  model_class: "ESMM"
  esmm {
    groups { input: "user" dnn { hidden_units: [8] use_bn: %(bn)s } }
    groups { input: "item" dnn { hidden_units: [16, 8] use_bn: %(bn)s } }
    ctr_tower { tower_name: "click" label_name: "clk"
                dnn { hidden_units: [8] use_bn: %(bn)s } }
    cvr_tower { tower_name: "conv" label_name: "buy" weight: 0.5
                dnn { hidden_units: [8] use_bn: %(bn)s } }
    l2_regularization: 1e-3
  }''',
    'dbmtl': SEQ_GROUP + '''
  model_class: "DBMTL"
  dbmtl {
    bottom_dnn { hidden_units: [16] use_bn: %(bn)s }
    expert_dnn { hidden_units: [8] }
    num_expert: 2
    task_towers { tower_name: "ctr" label_name: "clk"
                  dnn { hidden_units: [8] use_bn: %(bn)s } }
    task_towers { tower_name: "cvr" label_name: "buy"
                  dnn { hidden_units: [8] use_bn: %(bn)s }
                  relation_tower_names: ["ctr", "later"]
                  relation_dnn { hidden_units: [4] use_bn: %(bn)s }
                  losses { loss_type: CLASSIFICATION }
                  losses { loss_type: ORDER_CALIBRATE_LOSS weight: 0.5 } }
    task_towers { tower_name: "later" label_name: "buy"
                  relation_tower_names: "cvr" }
    l2_regularization: 1e-3
  }''',
    'ple': ALL_GROUP + '''
  model_class: "PLE"
  ple {
    extraction_networks {
      network_name: "layer1" expert_num_per_task: 2 share_num: 1
      task_expert_net { hidden_units: [16, 8] }
      share_expert_net { hidden_units: [12, 8] }
    }
    extraction_networks {
      expert_num_per_task: 1 share_num: 2
      task_expert_net { hidden_units: [8] }
    }
    %s
    %s
    l2_regularization: 1e-3
  }''' % (_tower('ctr', 'clk'), _tower('cvr', 'buy')),
}


def _text(model, bn=True, data='synthetic', input_type='DummyInput',
          model_dir=''):
  block = MODELS[model] % {'bn': 'true' if bn else 'false'}
  return SCHEMA % {'data': data, 'input_type': input_type,
                   'model_dir': model_dir, 'model': block}


def _configs(model, bn=True, **kw):
  text = _text(model, bn, **kw)
  return (t_config.get_configs_from_pipeline_str(text),
          j_config.get_configs_from_pipeline_str(text))


def _torch(batch):
  return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          batch.items()}


def _close(got, want, err_msg=''):
  """Within TOL of the larger of 1 and the values' scale."""
  want = np.asarray(want)
  scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
  np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                             atol=TOL * scale, err_msg=err_msg)


# ------------------------------------------------------------- layers


def _layer_vars(module, rng, *args):
  variables = module.init(jax.random.PRNGKey(0), *args)
  return jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * rng.random(np.shape(a)).astype(
          np.float32), variables)


def test_batched_experts_match_flax():
  rng = np.random.default_rng(0)
  x = rng.standard_normal((16, 12)).astype(np.float32)
  j = j_mt.BatchedExperts(num_expert=3, hidden_units=(10, 6),
                          activation='tanh')
  variables = _layer_vars(j, rng, x)
  t = t_mt.BatchedExperts(12, 3, (10, 6), activation='tanh')
  t.load_state_dict(convert.flax_to_state_dict(variables['params'],
                                               root=''))
  assert tuple(t.w_0.shape) == (3, 12, 10) and tuple(t.b_1.shape) == (3, 6)
  got = t(torch.from_numpy(x)).detach().numpy()          # [E, B, U]
  _close(got.transpose(1, 0, 2), j.apply(variables, x))


def test_mmoe_layer_matches_flax():
  rng = np.random.default_rng(1)
  x = rng.standard_normal((16, 12)).astype(np.float32)
  j = j_mt.MMoE(num_task=2, num_expert=4, expert_hidden_units=(10, 6))
  variables = _layer_vars(j, rng, x)
  t = t_mt.MMoE(12, 2, 4, (10, 6))
  t.load_state_dict(convert.flax_to_state_dict(variables['params'],
                                               root=''))
  for got, want in zip(t(torch.from_numpy(x)), j.apply(variables, x)):
    _close(got.detach().numpy(), want)


@pytest.mark.parametrize('final', [False, True])
def test_cgc_layer_matches_flax(final):
  rng = np.random.default_rng(2)
  tasks = [rng.standard_normal((16, 12)).astype(np.float32)
           for _ in range(3)]
  shared = rng.standard_normal((16, 12)).astype(np.float32)
  j = j_mt.CGCLayer(num_task=3, expert_num_per_task=2, share_num=3,
                    task_hidden_units=(10, 6), share_hidden_units=(8, 6),
                    final_layer=final)
  variables = _layer_vars(j, rng, tasks, shared)
  t = t_mt.CGCLayer([12] * 3, 12, 2, 3, (10, 6), (8, 6), final_layer=final)
  t.load_state_dict(convert.flax_to_state_dict(variables['params'],
                                               root=''))
  got_tasks, got_shared = t([torch.from_numpy(a) for a in tasks],
                            torch.from_numpy(shared))
  want_tasks, want_shared = j.apply(variables, tasks, shared)
  for got, want in zip(got_tasks, want_tasks):
    _close(got.detach().numpy(), want)
  assert (got_shared is None) == (want_shared is None) == final
  if not final:
    _close(got_shared.detach().numpy(), want_shared)


@pytest.mark.parametrize('fan_in,units', [(32, 64), (288, 256)])
def test_expert_init_is_per_expert_he_uniform(fan_in, units):
  """Each expert's kernel is he_uniform over its own fan_in (limit
  sqrt(6 / D)), as the JAX package's variance_scaling(batch_axis=0): not
  under-scaled by sqrt(E) as an init over the whole [E, D, U] would be."""
  t = t_mt.BatchedExperts(fan_in, 4, (units,),
                          generator=torch.Generator().manual_seed(0))
  w = t.w_0.detach().numpy()
  limit = (6.0 / fan_in) ** 0.5
  assert np.abs(w).max() <= limit
  j = j_mt.BatchedExperts(num_expert=4, hidden_units=(units,))
  jw = np.asarray(j.init(jax.random.PRNGKey(0), np.zeros(
      (2, fan_in), np.float32))['params']['w_0'])
  for e in range(4):
    assert abs(w[e].std() / (limit / 3 ** 0.5) - 1.0) < 0.1
    assert abs(w[e].std() / jw[e].std() - 1.0) < 0.1
  assert not t.b_0.detach().any()


# ------------------------------------------------------------- losses


def _loss_inputs(seed, classes=None):
  rng = np.random.default_rng(seed)
  n = 64
  logits = rng.standard_normal((n,) if classes is None else (n, classes)
                               ).astype(np.float32) * 3
  labels = (rng.integers(0, classes, n) if classes else
            rng.random(n)).astype(np.float32)
  weights = (rng.random(n) > 0.2).astype(np.float32) * rng.random(n)
  return labels, logits, weights.astype(np.float32)


LOSS_CASES = {
    'sigmoid_cross_entropy': {},
    'l2_loss': {},
    'sigmoid_l2_loss': {},
    'binary_focal_loss': {},
    'binary_focal_loss-alpha': dict(gamma=1.5, alpha=0.25,
                                    label_smoothing=0.1),
    'binary_focal_loss-ohem': dict(gamma=2.0, alpha=0.75, ohem_ratio=0.4),
    'f1_reweighted_loss': dict(f1_beta_square=2.0, label_smoothing=0.05),
}


@pytest.mark.parametrize('case', sorted(LOSS_CASES))
def test_tower_losses_match_jax(case):
  name = case.split('-')[0]
  labels, logits, weights = _loss_inputs(len(case))
  want = getattr(j_losses, name)(labels, logits, weights, **LOSS_CASES[case])
  got = getattr(t_losses, name)(*map(torch.from_numpy,
                                     (labels, logits, weights)),
                                **LOSS_CASES[case])
  np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_softmax_cross_entropy_matches_jax():
  labels, logits, weights = _loss_inputs(3, classes=5)
  want = j_losses.softmax_cross_entropy(labels, logits, weights)
  got = t_losses.softmax_cross_entropy(*map(torch.from_numpy,
                                            (labels, logits, weights)))
  np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


# --------------------------------------------------- the whole models


@pytest.mark.parametrize('model', sorted(MODELS))
def test_forward_and_loss_match_flax(model):
  """Each model's forward with its input layer, in train mode (batch
  statistics, which must move alike) and eval mode, flax parameters
  carried over by convert.py (strict load: every torch name is a flax
  name); then build_loss, metric_inputs and metric_inputs_per_task on the
  same outputs, with some rows padded (sample weight 0)."""
  t_cfg, j_cfg = _configs(model)
  j_specs = j_fs.build_feature_specs(j_config.get_feature_configs(j_cfg))
  t_specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  j_ctx = j_base.build_context(j_cfg, j_specs)
  t_ctx = t_base.build_context(t_cfg, t_specs)
  j_model = j_base.create_model(j_ctx)
  module = j_model.make_module()
  t_model = t_base.create_model(t_ctx)
  assert t_model.flax_root == ''
  rng = np.random.default_rng(3)
  batch = synthetic_batch(j_specs, LABELS, 32, seed=5)
  batch['sample_weight'][-5:] = 0.0
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
  t_model.load_state_dict(convert.flax_to_state_dict(
      variables['params'], variables.get('batch_stats'), root=''))
  # fine-tune restore's names are the JAX package's, under no root
  names = convert.flax_names(t_model.state_dict(), t_model.flax_root)
  for section in ('params', 'batch_stats'):
    assert sorted(n for sec, n in names.values() if sec == section) == \
        sorted(j_restore._flatten(variables.get(section, {})))

  want, mutated = module.apply(variables, batch, pulled, True,
                               mutable=['batch_stats', 'losses'])
  t_model.train()
  got = t_model(_torch(batch), _torch(pulled))
  assert sorted(got) == sorted(want)
  for k in want:
    _close(got[k].detach().numpy(), want[k], err_msg=k)
  _, stats = convert.state_dict_to_flax(t_model.state_dict(), root='')
  jax.tree_util.tree_map(
      lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                              atol=1e-6),
      stats, mutated['batch_stats'])
  variables = {'params': variables['params'],
               'batch_stats': mutated['batch_stats']}
  want = module.apply(variables, batch, pulled, False)
  t_model.eval()
  got = t_model(_torch(batch), _torch(pulled))
  for k in want:
    _close(got[k].detach().numpy(), want[k], err_msg=k)

  outputs = {k: np.array(v) for k, v in want.items()}
  j_total, j_losses_ = j_model.build_loss(outputs, batch)
  t_total, t_losses_ = t_model.build_loss(_torch(outputs), _torch(batch))
  assert sorted(t_losses_) == sorted(j_losses_)
  for k in j_losses_:
    np.testing.assert_allclose(float(t_losses_[k]), float(j_losses_[k]),
                               rtol=1e-6, atol=1e-6, err_msg=k)
  np.testing.assert_allclose(float(t_total), float(j_total), rtol=1e-6)
  pairs = [(t_model.metric_inputs(_torch(outputs), _torch(batch)),
            j_model.metric_inputs(outputs, batch))]
  t_tasks = t_model.metric_inputs_per_task(_torch(outputs), _torch(batch))
  j_tasks = j_model.metric_inputs_per_task(outputs, batch)
  assert list(t_tasks) == list(j_tasks) == (
      j_model.metric_task_names() if hasattr(j_model, 'metric_task_names')
      else [t.tower_name for t in j_model.task_towers()])
  assert t_model.metric_task_names() == list(j_tasks)
  pairs += [(t_tasks[k], j_tasks[k]) for k in j_tasks]
  for t_mi, j_mi in pairs:
    for k in ('labels', 'probs', 'weights'):
      np.testing.assert_array_equal(t_mi[k].numpy(), np.asarray(j_mi[k]))
  assert sorted(t_model.export_outputs(got)) == sorted(
      j_model.export_outputs(want))


# --------------------------------------------- export, predict, serve


def _write_csv(path, n, seed):
  rng = np.random.default_rng(seed)
  with open(path, 'w') as f:
    for i in range(n):
      brands = '|'.join('b%d' % v for v in rng.integers(0, 60,
                                                        rng.integers(0, 11)))
      cates = '|'.join('c%d' % v for v in rng.integers(0, 30,
                                                       rng.integers(1, 9)))
      f.write('%d,%d,u%d,b%d,c%d,%s,%s,%s\n' % (
          rng.integers(0, 2), rng.integers(0, 2), rng.integers(0, 90),
          rng.integers(0, 60), rng.integers(0, 30),
          '' if i % 9 == 0 else rng.integers(0, 70), brands, cates))


def _rows(path, n):
  with open(path) as f:
    return [dict(zip(COLUMNS, line)) for line in csv.reader(f)][:n]


def _eval_forward(trainer, predictor, rows):
  """The Trainer's eval forward on `rows` transformed as the Predictor
  transforms a request: {output: numpy}."""
  from easyrec_torch.features import transforms as tr
  columns = {c: np.array([r.get(c, '') for r in rows], dtype=object)
             for c in predictor.input_names}
  packed = tr.apply_transforms(predictor.transforms, columns)
  packed['sample_weight'] = np.ones(len(rows), np.float32)
  batch = to_device({k: np.array(v) for k, v in packed.items()},
                    trainer.device)
  with torch.no_grad():
    pulled = t_emb.pull_embeddings(
        trainer.tables, t_emb.pack_ids(trainer.layout, batch), trainer.metas)
    out = trainer.model.export_outputs(trainer.eval_forward(batch, pulled))
  return {k: v.numpy() for k, v in out.items()}


def test_mmoe_export_matches_jax_and_the_eval_forward(tmp_path):
  """An MMoE (with BatchNorm) trained 3 steps on a CSV and exported by
  both packages: the port's export lists the JAX export's outputs
  (logits_<tower>, probs_<tower>); its Predictor's answers equal the
  Trainer's eval forward bit for bit; the JAX export carried over by
  convert.py answers as the JAX Predictor does, within 1e-5."""
  data = str(tmp_path / 'mt.csv')
  _write_csv(data, 300, seed=4)
  path = tmp_path / 'mmoe.config'
  path.write_text(_text('mmoe', data=data, input_type='CSVInput'))
  jt = JTrainer(j_config.get_configs_from_pipeline_file(str(path)),
                devices=jax.devices('cpu')[:1])
  it = iter(jt.train_input())
  batches = [next(it) for _ in range(3)]
  state = jt.init_state(batches[0])
  for b in batches:
    state, _ = jt.train_step(state, jt.rules.shard_batch(b))
  jexp = j_sm.export_saved_model(jt, state, str(tmp_path / 'jax'))
  tt = TTrainer(t_config.get_configs_from_pipeline_file(str(path)),
                device='cpu')
  tt.init_state()
  it = iter(tt.train_input())
  for _ in range(3):
    tt.train_step(to_device(next(it), torch.device('cpu')))
  texp = t_sm.export_saved_model(tt, str(tmp_path / 'port'))
  metas = []
  for d in (jexp, texp):
    with open(os.path.join(d, 'export_meta.json')) as f:
      metas.append(json.load(f))
  assert metas[0]['outputs'] == metas[1]['outputs'] == [
      'logits_ctr', 'logits_cvr', 'probs_ctr', 'probs_cvr']
  # one chunk, as the Trainer's batch: a matmul's blocking, and so its
  # bits, may change with the row count
  p = t_predictor.Predictor(texp, batch_size=128, device='cpu')
  rows = _rows(data, 70)
  got = p.predict(rows)
  want = _eval_forward(tt, p, rows)
  for key, ref in want.items():
    served = np.float32([r[key] for r in got])
    assert served.tobytes() == ref.tobytes(), key

  _, vs = j_sm.load_serving_state(jexp)
  vs = jax.tree_util.tree_map(np.asarray, vs)
  bundle = convert.jax_export_to_bundle(
      jexp, str(tmp_path / 'bundle'), vs['params'], vs.get('batch_stats'),
      vs['tables'], vs['step'])
  got = t_predictor.Predictor(bundle, batch_size=64,
                              device='cpu').predict(rows)
  want = j_predictor.Predictor(jexp, batch_size=64).predict(rows)
  for key in metas[0]['outputs']:
    _close([float(r[key]) for r in got], [float(r[key]) for r in want],
           err_msg=key)


def test_esmm_multi_output_paths(tmp_path):
  """ESMM through main.py on a CSV with a model_dir: eval_result.txt and
  the result hold auc, auc_<tower> and auc_ctcvr; main.predict writes one
  column per output; the export, predict_csv and the server answer every
  probs_* / logits_* key, probs_ctcvr among them, and no rank_predict
  (there is no `probs`)."""
  data = str(tmp_path / 'mt.csv')
  _write_csv(data, 200, seed=6)
  path = tmp_path / 'esmm.config'
  path.write_text(_text('esmm', data=data, input_type='CSVInput',
                        model_dir=str(tmp_path / 'md')))
  result = t_main.train_and_evaluate(
      str(path), {'export_config.export_rtp_outputs': True}, device='cpu')
  tasks = {'auc', 'auc_click', 'auc_conv', 'auc_ctcvr', 'loss'}
  assert set(result['eval_metrics']) == tasks
  with open(tmp_path / 'md' / 'eval_result.txt') as f:
    assert set(json.load(f)) == tasks
  outputs = ['logits_click', 'logits_conv', 'probs_click', 'probs_conv',
             'probs_ctcvr']
  with open(os.path.join(result['export_dir'], 'export_meta.json')) as f:
    assert json.load(f)['outputs'] == outputs
  out_csv = str(tmp_path / 'pred.csv')
  rows = t_main.predict(str(path), output_path=out_csv, device='cpu')
  with open(out_csv) as f:
    lines = list(csv.reader(f))
  assert lines[0] == outputs and len(lines) == len(rows) + 1 == 201
  for r in rows:
    np.testing.assert_allclose(r['probs_ctcvr'],
                               r['probs_click'] * r['probs_conv'],
                               rtol=1e-6)
  p = t_predictor.Predictor(result['export_dir'], batch_size=64,
                            device='cpu')
  assert p.predict_csv(data, str(tmp_path / 'p2.csv'),
                       reserved_cols=['user_id']) == 200
  with open(tmp_path / 'p2.csv') as f:
    assert next(csv.reader(f)) == ['user_id'] + outputs
  service = PredictorService(result['export_dir'], batch_size=64,
                             device='cpu')
  service.warmup()
  service.start()
  try:
    client = PredictClient('127.0.0.1:%d' % service.port, timeout=60)
    served = client.predict(_rows(data, 5))
    client.close()
  finally:
    service.stop()
  want = _eval_forward(result['trainer'], p, _rows(data, 5))
  assert all(sorted(r) == outputs for r in served)
  for key, ref in want.items():
    assert np.float32([r[key] for r in served]).tobytes() == ref.tobytes()
