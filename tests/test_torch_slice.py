"""The whole training slice of the port (easyrec_torch.train.trainer) against
the JAX package's Trainer: a small DeepFM on one CPU device with the JAX
package's packed combined tables (EASYREC_PACKED_TABLES=1, the compact
bf16-pair Adam layout that the port's kernels implement). From the same
initial state and batches, three steps must give the same losses, dense
parameters and BatchNorm statistics, the same logical (w, m, v) table rows,
and the same eval AUC."""

import functools

import jax
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.train.trainer import Trainer as JTrainer
from easyrec_tpu.utils.synthetic import synthetic_batch

CONFIG = '''
train_input_path: "unused"
eval_input_path: "unused"
train_config {
  optimizer_config { adam_optimizer { learning_rate {
    exponential_decay_learning_rate { initial_learning_rate: 0.01
      decay_steps: 2 decay_factor: 0.5 min_learning_rate: 0.004 } } } }
  num_steps: 3
}
eval_config { metrics_set { auc {} } }
data_config {
  batch_size: 64 label_fields: "label" input_type: DummyInput
  input_fields { input_name: "label" input_type: FLOAT }
  input_fields { input_name: "F1" input_type: FLOAT }
  input_fields { input_name: "C1" input_type: STRING }
  input_fields { input_name: "C2" input_type: STRING }
  input_fields { input_name: "C3" input_type: STRING }
  input_fields { input_name: "C4" input_type: STRING }
}
feature_config {
  features { input_names: "F1" feature_type: RawFeature embedding_dim: 8
             min_val: 0.0 max_val: 1.0 }
  features { input_names: "C1" feature_type: IdFeature embedding_dim: 8
             hash_bucket_size: 1000 }
  features { input_names: "C2" feature_type: IdFeature embedding_dim: 8
             hash_bucket_size: 1000 }
  features { input_names: "C3" feature_type: IdFeature embedding_dim: 8
             hash_bucket_size: 1000 }
  features { input_names: "C4" feature_type: IdFeature embedding_dim: 8
             hash_bucket_size: 1000 }
}
model_config {
  model_class: "DeepFM"
  feature_groups { group_name: "deep"
                   feature_names: ["F1", "C1", "C2", "C3", "C4"]
                   wide_deep: DEEP }
  feature_groups { group_name: "wide"
                   feature_names: ["C1", "C2", "C3", "C4"] wide_deep: WIDE }
  deepfm { dnn { hidden_units: [16, 8] use_bn: %(bn)s }
           final_dnn { hidden_units: [8] use_bn: %(bn)s }
           l2_regularization: 1e-3 }
  embedding_regularization: 1e-4
}
'''

BF16_ULP = 2.0 ** -7


def _carry_initial_state(jt, state, tt):
  tt.init_state()
  tt.model.load_state_dict(convert.flax_to_state_dict(state.params,
                                                      state.batch_stats))
  for key, meta in jt.pack_metas.items():
    tt.tables[key].copy_(torch.from_numpy(convert.jax_packed_to_table(
        np.asarray(state.tables[key]), meta.dim, tt.metas[key].rows,
        meta.n_parts)))


LR_SUM = 0.01 + 0.01 + 0.005      # the schedule's rates of the 3 steps
BN_MOMENTUM = 0.99


def _bn_cancelled(path):
  """A Dense bias feeding a BatchNorm: its gradient is zero up to f32
  rounding, and Adam turns that noise into a step of +-lr either way."""
  keys = [getattr(k, 'key', None) for k in path]
  return (keys[-1] == 'bias' and str(keys[-2]).startswith('dense_'))


def _biases_before_bn(params):
  """{path of BatchNorm bn_i: the bias of dense_i, which feeds it}, f64."""
  out = {}
  for path, x in jax.tree_util.tree_leaves_with_path(params):
    if _bn_cancelled(path):
      keys = tuple(k.key for k in path)
      bn = 'bn_' + keys[-2][len('dense_'):]
      out[keys[:-2] + (bn,)] = np.asarray(x, np.float64)
  return out


def _bias_share(history, bn):
  """What the biases of `history` (one dict of _biases_before_bn a step,
  taken before it) put into BatchNorm bn's running mean: each step's
  batch mean holds its bias, and momentum decays it as the rest."""
  steps = len(history)
  return sum((1 - BN_MOMENTUM) * BN_MOMENTUM ** (steps - 1 - s) * h[bn]
             for s, h in enumerate(history))


@pytest.mark.parametrize('mode,use_bn', [('0', False), ('1', False),
                                         ('0', True)])
def test_three_steps_match_jax_trainer(mode, use_bn, monkeypatch):
  """Tolerances, with their reasons. Losses: f32 in another order,
  relative 2e-5. Without BatchNorm in mode 0 (f32 gradient sums), dense
  parameters within 5e-6 and table rows within 1e-6 (w) and one bf16 ulp
  (m, v; or 1e-9 where they round near zero).

  In mode 1 (bf16 gradient sums, the default) JAX rounds its running sum
  to bf16 after every add and the port once at the end; the raw feature's
  single row repeats 64 times a step, so its sum differs by up to a few
  percent, and the forward and the other rows' gradients of later steps
  follow it. With BatchNorm, the Dense biases before it get a zero
  gradient up to rounding, so Adam moves them by +-lr on either side: they
  are held only to that bound, and the rest of the dense parameters, which
  see those biases before BatchNorm removes them, to 1e-4. The running
  means take in each step's biases; each side's own biases, recorded
  before every step, are taken out of its means (_bias_share), and the
  rest is held as the variances are, to 1e-5 (it measures 8e-9). In both
  cases the tables are held to
  1e-4 (w) and 3% or 2e-7 (m, v). Eval runs on running statistics that do
  not remove the biases, so its loss and AUC are compared without
  BatchNorm only."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', mode)
  text = CONFIG % {'bn': 'true' if use_bn else 'false'}
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  jt = JTrainer(j_cfg, devices=jax.devices('cpu')[:1])
  assert jt.packed_mode and jt._packed_compact
  tt = TTrainer(t_cfg, device='cpu')
  batches = [synthetic_batch(jt.specs, ['label'], 64, seed=s)
             for s in range(5)]
  state = jt.init_state(batches[0])
  _carry_initial_state(jt, state, tt)
  cpu = torch.device('cpu')

  j_hist, t_hist = [], []
  for s in range(3):
    j_hist.append(_biases_before_bn(jax.device_get(state.params)))
    t_hist.append(_biases_before_bn(
        convert.state_dict_to_flax(tt.model.state_dict())[0]))
    state, j_loss = jt.train_step(state, jt.rules.shard_batch(batches[s]))
    t_loss = tt.train_step(to_device(batches[s], cpu))
    np.testing.assert_allclose(float(t_loss['total_loss']),
                               float(j_loss['total_loss']), rtol=2e-5)
  assert int(tt.step) == int(state.step) == 3

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
    if path[-1].key == 'mean':
      bn = tuple(k.key for k in path[:-1])
      got = got - _bias_share(t_hist, bn)
      want = want - _bias_share(j_hist, bn)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)

  tight = mode == '0' and not use_bn
  for key, meta in jt.pack_metas.items():
    rows = tt.metas[key].rows
    jw, (jm, jv) = jpt.unpack_host(np.asarray(state.tables[key]), meta,
                                   rows)
    tw, (tm, tv) = tpt.unpack_host(tt.tables[key].numpy(), tt.metas[key])
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6 if tight else 1e-4)
    for got, want in ((tm, jm), (tv, jv)):
      np.testing.assert_allclose(got, want, rtol=BF16_ULP if tight else 0.03,
                                 atol=1e-9 if tight else 2e-7)
    assert np.mean(tw == jw) > 0.9        # untouched rows are bit-equal

  if not use_bn:
    j_eval = jt.evaluate(state, eval_iter=batches[3:])
    t_eval = tt.evaluate(eval_iter=batches[3:])
    # AUC from 8192-bin histograms: a probability a hair from a bin edge
    # may land one bin over
    np.testing.assert_allclose(t_eval['auc'], j_eval['auc'], atol=1e-3)
    np.testing.assert_allclose(t_eval['loss'], j_eval['loss'], rtol=2e-5)


TABLE_OPTIMIZERS = {
    # the first optimizer drives the tables, the second (the Adam above)
    # the dense weights
    'adagrad': '''optimizer_config {
    adagrad_optimizer {
      learning_rate { constant_learning_rate { learning_rate: 0.05 } } }
    embedding_learning_rate_multiplier: 0.5 }
  ''',
    'ftrl': '''optimizer_config {
    ftrl_optimizer {
      learning_rate { constant_learning_rate { learning_rate: 0.05 } }
      l1_reg: 0.001 l2_reg: 0.01 l2_shrinkage_reg: 0.01 } }
  ''',
}


@pytest.mark.parametrize('which,fused', [('adagrad', '0'), ('adagrad', '1'),
                                         ('ftrl', '0')])
def test_three_steps_match_jax_trainer_with_table_optimizer(which, fused,
                                                            monkeypatch):
  """The small DeepFM (no BatchNorm, f32 gradient sums) with Adagrad or
  FTRL tables and Adam dense weights, three steps through both trainers:
  the tables hold [w | accum] or [w | accum | z] on both sides, the JAX
  package's on its XLA path, the port's through K1 + K2's plain versions
  (or K3's under EASYREC_PACKED_FUSED=1). Tolerances, with their reasons:
  losses relative 2e-5 and dense parameters 5e-6, as the Adam slice
  above; every table part within 1e-6, FTRL's z within 3e-6 (XLA's
  pow(acc, 0.5) against the port's correctly rounded root: z takes
  sigma * w, sigma a difference of two close roots, tests/test_torch_
  optim.py Z_ATOL). Rows no batch pulled are bit-equal."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', fused)
  text = (CONFIG % {'bn': 'false'}).replace(
      'optimizer_config { adam_optimizer',
      TABLE_OPTIMIZERS[which] + 'optimizer_config { adam_optimizer', 1)
  jt = JTrainer(j_config.get_configs_from_pipeline_str(text),
                devices=jax.devices('cpu')[:1])
  assert jt.packed_mode and not jt._packed_compact
  tt = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  assert tt.embed_pair.sparse.name == which
  batches = [synthetic_batch(jt.specs, ['label'], 64, seed=s)
             for s in range(3)]
  state = jt.init_state(batches[0])
  _carry_initial_state(jt, state, tt)
  for s in range(3):
    state, j_loss = jt.train_step(state, jt.rules.shard_batch(batches[s]))
    t_loss = tt.train_step(to_device(batches[s], torch.device('cpu')))
    np.testing.assert_allclose(float(t_loss['total_loss']),
                               float(j_loss['total_loss']), rtol=2e-5)
  params, _ = convert.state_dict_to_flax(tt.model.state_dict())
  j_params = jax.device_get(state.params)
  for path, got in jax.tree_util.tree_leaves_with_path(params):
    want = np.asarray(functools.reduce(lambda t, k: t[k.key], path,
                                       j_params))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6,
                               err_msg=jax.tree_util.keystr(path))
  for key, meta in jt.pack_metas.items():
    tmeta = tt.metas[key]
    assert tmeta.n_parts == meta.n_parts == tt.embed_pair.sparse.n_parts
    jw, js = jpt.unpack_host(np.asarray(state.tables[key]), meta,
                             tmeta.rows)
    tw, ts = tpt.unpack_host(tt.tables[key].numpy(), tmeta)
    names = ('w',) + tt.embed_pair.sparse.slot_names
    for name, got, want in zip(names, [tw] + ts, [jw] + list(js)):
      np.testing.assert_allclose(got, want, rtol=0,
                                 atol=3e-6 if name == 'z' else 1e-6,
                                 err_msg=name)
      assert np.mean(got == want) > 0.9     # untouched rows are bit-equal
