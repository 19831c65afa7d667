"""Training of the classic rank zoo against the JAX package on the CPU:
three steps of each model (and of a DeepFM with Uncertainty-weighted loss
terms) through both Trainers, then their evaluate with `auc` and
`max_f1`; a fine-tune restore by the zoo's names
(tests/test_torch_criteo_dlrm.py holds the Criteo DLRM).
The models' small configs are tests/test_torch_rank_zoo.py's."""

import functools

import jax
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.train import restore as t_restore
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.train.trainer import Trainer as JTrainer
from easyrec_tpu.utils.synthetic import synthetic_batch
from tests.test_torch_rank_zoo import BF16_ULP, _configs, _text


# ------------------------------------------------ three train steps


LR_SUM = 0.01 + 0.01 + 0.005      # the schedule's rates of the 3 steps


def _carry_state(jt, state, tt):
  tt.init_state()
  tt.model.load_state_dict(convert.flax_to_state_dict(state.params,
                                                      state.batch_stats))
  for key, meta in jt.pack_metas.items():
    tt.tables[key].copy_(torch.from_numpy(convert.jax_packed_to_table(
        np.asarray(state.tables[key]), meta.dim, tt.metas[key].rows,
        meta.n_parts)))


def _bn_cancelled(path):
  """A Dense bias feeding a BatchNorm (ROADMAP's known divergences)."""
  keys = [getattr(k, 'key', None) for k in path]
  return keys[-1] == 'bias' and str(keys[-2]).startswith('dense_')


def _run_both(j_cfg, t_cfg, labels, n_steps=3, batch_size=64):
  jt = JTrainer(j_cfg, devices=jax.devices('cpu')[:1])
  assert jt.packed_mode and jt._packed_compact
  tt = TTrainer(t_cfg, device='cpu')
  batches = [synthetic_batch(jt.specs, labels, batch_size, seed=s)
             for s in range(n_steps)]
  batches[1]['sample_weight'][-5:] = 0.0
  state = jt.init_state(batches[0])
  _carry_state(jt, state, tt)
  for s in range(n_steps):
    state, j_loss = jt.train_step(state, jt.rules.shard_batch(batches[s]))
    t_loss = tt.train_step(to_device(batches[s], torch.device('cpu')))
    assert sorted(t_loss) == sorted(k for k in j_loss
                                    if not k.startswith('exchange_'))
    for k, v in t_loss.items():
      np.testing.assert_allclose(float(v), float(j_loss[k]), rtol=2e-5,
                                 atol=1e-7, err_msg=k)
  assert int(tt.step) == int(state.step) == n_steps
  return jt, tt, state


def _score_bias(path, params):
  """The last Dense bias of a softmax attention's score net (a
  sequence_features sub-group's att_dnn): it adds one value to every score
  of a row, which the softmax removes, so its gradient is zero up to
  rounding (ROADMAP's known divergences, as the attention's key bias)."""
  keys = [k.key for k in path]
  if len(keys) < 3 or keys[-1] != 'bias' or keys[-3] != 'att_dnn':
    return False
  att = functools.reduce(lambda t, k: t[k], keys[:-2], params)
  return keys[-2] == 'dense_%d' % (len(att) - 1)


def _check_params(tt, state, use_bn, lr_sum, cancelled=None):
  """`cancelled(path)` names further parameters whose gradient a
  BatchNorm cancels, held as the Dense biases before one are."""
  params, _ = convert.state_dict_to_flax(tt.model.state_dict(),
                                         tt.model.flax_root)
  j_params = jax.device_get(state.params)
  leaves = jax.tree_util.tree_leaves_with_path(params)
  assert len(leaves) == len(jax.tree_util.tree_leaves(j_params))
  for path, got in leaves:
    want = np.asarray(functools.reduce(lambda t, k: t[k.key], path,
                                       j_params))
    if _score_bias(path, params) or use_bn and (
        _bn_cancelled(path) or cancelled is not None and cancelled(path)):
      assert np.abs(got - want).max() <= 2 * lr_sum
    else:
      np.testing.assert_allclose(got, want, rtol=0,
                                 atol=1e-4 if use_bn else 5e-6,
                                 err_msg=jax.tree_util.keystr(path))


def _check_tables(jt, tt, state, atol):
  for key, meta in jt.pack_metas.items():
    rows = tt.metas[key].rows
    jw, (jm, jv) = jpt.unpack_host(np.asarray(state.tables[key]), meta,
                                   rows)
    tw, (tm, tv) = tpt.unpack_host(tt.tables[key].numpy(), tt.metas[key])
    np.testing.assert_allclose(tw, jw, rtol=0, atol=atol)
    for got, want in ((tm, jm), (tv, jv)):
      np.testing.assert_allclose(got, want, rtol=BF16_ULP if atol <= 1e-5
                                 else 0.03, atol=1e-9 if atol <= 1e-5
                                 else 2e-7)
    assert np.mean(tw == jw) > 0.5        # untouched rows are bit-equal


@pytest.mark.parametrize('model', ['wide_and_deep', 'dcn', 'autoint',
                                   'dlrm', 'fm', 'rocket_launching',
                                   'deepfm_uncertainty'])
def test_three_steps_match_jax_trainer(model, monkeypatch):
  """The port's Trainer, K1 + K2 by their plain versions, against the JAX
  Trainer with packed compact tables and f32 gradient sums, from one state
  and the same batches, without BatchNorm: each loss term relative 2e-5,
  dense parameters (loss_uncertainty among them) 5e-6, the bf16 moments a
  bf16 ulp or 1e-9 (tests/test_torch_slice.py's tolerances and reasons);
  table weights 1e-5, as tests/test_torch_din.py holds them, for its
  reason: a gradient that cancels below Adam's eps keeps its relative f32
  error in the step (1e-6 parts a few weights by up to 1.5e-6 here). A
  sequence sub-group's softmax score bias gets a gradient of rounding
  noise and is held to 2 lr a step (_score_bias). Then evaluate: `auc`
  and `max_f1` within
  1e-3 (a probability a hair from an 8192-bin histogram's edge may land
  one bin over), the loss relative 2e-5."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', '0')
  t_cfg, j_cfg = _configs(model, bn=False)
  jt, tt, state = _run_both(j_cfg, t_cfg, ['label'])
  _check_params(tt, state, False, LR_SUM)
  _check_tables(jt, tt, state, 1e-5)
  if model == 'deepfm_uncertainty':
    # Adam's moments of loss_uncertainty, which optax keeps beside `inner`
    # too, carried by convert.py
    j_dense = convert.optax_to_dense_state(
        jax.tree_util.tree_map(np.asarray, state.opt_state),
        tt.dense_opt.slot_names)
    t_dense = tt.dense_opt.state_dict()
    for slot in tt.dense_opt.slot_names:
      np.testing.assert_allclose(
          t_dense[slot]['loss_uncertainty'].numpy(),
          j_dense[slot]['loss_uncertainty'].numpy(), rtol=1e-5, atol=1e-12,
          err_msg=slot)
  evals = [synthetic_batch(jt.specs, ['label'], 128, seed=10 + s)
           for s in range(2)]
  j_eval = jt.evaluate(state, eval_iter=evals)
  j_eval.pop('exchange_overflow_rate', None)
  t_eval = tt.evaluate(eval_iter=evals)
  assert sorted(t_eval) == sorted(j_eval) == ['auc', 'loss', 'max_f1']
  for k in ('auc', 'max_f1'):
    np.testing.assert_allclose(t_eval[k], j_eval[k], atol=1e-3, err_msg=k)
  np.testing.assert_allclose(t_eval['loss'], j_eval['loss'], rtol=2e-5)


def test_fine_tune_restore_by_zoo_names(tmp_path):
  """A DCN with Uncertainty-weighted terms warm-starts another seed's DCN
  by the JAX package's names: CrossNet's `inner/cross/w_<i>` and
  `loss_uncertainty`, which flax keeps beside `inner`, are named so, and
  restore_filters on them keep those fresh while every other variable and
  the table's weights come from the checkpoint."""
  text = _text('dcn').replace(
      '  embedding_regularization: 1e-4',
      '  losses { loss_type: CLASSIFICATION }\n'
      '  losses { loss_type: L2_LOSS weight: 0.5 }\n'
      '  loss_weight_strategy: Uncertainty\n'
      '  embedding_regularization: 1e-4')
  text = 'model_dir: "%s"\n' % (tmp_path / 'src') + text
  src = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  src.fit(num_steps=1, eval_at_end=False)
  dst = TTrainer(t_config.get_configs_from_pipeline_str(
      text.replace('num_steps: 3', 'num_steps: 3 random_seed: 99')),
      device='cpu')
  dst.init_state()
  fresh = {k: v.clone() for k, v in dst.model.state_dict().items()}
  counts = t_restore.fine_tune_restore(
      dst, str(tmp_path / 'src'),
      restore_filters=['^inner/cross/', '^loss_uncertainty$'])
  names = convert.flax_names(fresh)
  assert names['cross.w_1'] == ('params', 'inner/cross/w_1')
  assert names['loss_uncertainty'] == ('params', 'loss_uncertainty')
  kept = sorted(k for k, (_, n) in names.items()
                if n.startswith('inner/cross/') or n == 'loss_uncertainty')
  assert kept == ['cross.b_0', 'cross.b_1', 'cross.w_0', 'cross.w_1',
                  'loss_uncertainty']
  got, want = dst.model.state_dict(), src.model.state_dict()
  for k in names:
    assert torch.equal(got[k], fresh[k] if k in kept else want[k]), k
    if k not in kept and k.endswith('weight'):
      assert not torch.equal(want[k], fresh[k]), k
  assert counts['params'] == len([n for n in names.values()
                                  if n[0] == 'params']) - len(kept)
  assert counts['tables'] == 1
