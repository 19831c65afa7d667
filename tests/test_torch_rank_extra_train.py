"""Training of the rest of the rank zoo against the JAX package on the
CPU: three steps of the port's Trainer and the JAX Trainer from one state
on the same batches, after an eval of one shared state, for CMBF, Uniter,
DBMTL's two multi-modal bottoms and the samples of the ranking losses,
the grouped and multi-class metrics, bf16 and freeze_gradient; and
freeze_gradient's frozen weights bit-unchanged on both sides. The
samples' cut and edits are tests/test_torch_rank_extra.py's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.train.trainer import Trainer as JTrainer
from tests.test_torch_match import jax_batches, sample_configs
from tests.test_torch_match_train import _carry_state
from tests.test_torch_rank_extra import (BF16_ULP, LR_SUM, RANK,
                                         forward_against_jax, no_dropout)
from tests.test_torch_rank_zoo_train import _check_params


# ---------------------------------------------------------------------------
# three train steps and the eval, both trainers from one state
# ---------------------------------------------------------------------------


def _perturbed(jt, state, seed=5):
  """The state with its dense parameters perturbed (so that an eval's
  probabilities spread over many AUC bins)."""
  rng = np.random.default_rng(seed)
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a))
      .astype(np.float32), jax.device_get(state.params))
  return state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))


def _rounding_noise(params):
  """A predicate of the parameters whose gradient is zero up to rounding
  (ROADMAP's known divergences), held as the Dense biases before a
  BatchNorm: an attention's key bias, whose q.b the softmax removes, and
  the bias of a fusion encoder's last LayerNorm (CMBF's last t_ln_<i> and
  i_ln_<i>, Uniter's last block's ln2), which adds one vector to every
  token and so to their mean, whose next Dense feeds a BatchNorm."""
  def last(node, prefix):
    return max(int(k[len(prefix):]) for k in node if k.startswith(prefix))

  def cancelled(path):
    keys = [getattr(k, 'key', None) for k in path]
    if keys[-1] != 'bias':
      return False
    if keys[-2] == 'key':
      return True
    if len(keys) < 3:
      return False
    node = functools.reduce(lambda t, k: t[k], keys[:-3], params)
    if keys[-2] == 'ln2' and keys[-3].startswith('block_'):
      return keys[-3] == 'block_%d' % last(node, 'block_')
    node = node[keys[-3]]
    for prefix in ('t_ln_', 'i_ln_'):
      if keys[-2].startswith(prefix):
        return keys[-2] == prefix + str(last(node, prefix))
    return False
  return cancelled


def _check_tables(jt, tt, state):
  """Table weights within 1e-5; the compact bf16 moments within a bf16
  ulp of their row's largest (tests/test_torch_match_train.py's rule)."""
  for key, meta in jt.pack_metas.items():
    jw, (jm, jv) = jpt.unpack_host(np.asarray(state.tables[key]), meta,
                                   tt.metas[key].rows)
    tw, (tm, tv) = tpt.unpack_host(tt.tables[key].numpy(), tt.metas[key])
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-5, err_msg=key)
    for got, want in ((tm, jm), (tv, jv)):
      scale = np.abs(want).max(axis=1, keepdims=True)
      assert (np.abs(got - want) <= BF16_ULP * scale + 1e-9).all(), key


@pytest.mark.parametrize('name', ['cmbf', 'uniter', 'dbmtl_cmbf',
                                  'dbmtl_uniter'] + RANK)
def test_three_steps_match_jax_trainer(name, tmp_path, monkeypatch):
  """The port's Trainer (K1 + K2 by their plain versions) against the JAX
  Trainer (packed compact tables, f32 gradient sums) on the same batches
  of the JAX pipeline. First the eval of one perturbed state (the initial
  one's probabilities crowd into a few AUC bins) on two batches: each
  metric of the sample (auc, gauc, session_auc, accuracy) within 1e-3,
  the loss 2e-5 relative. Then three steps from one initial state: each
  loss term 2e-5 relative, the dense parameters at
  tests/test_torch_rank_zoo_train.py's rule with BatchNorm (an attention's
  key bias and a fusion encoder's last LayerNorm bias within 2 lr a
  step, as a Dense bias before a BatchNorm), every table weight 1e-5 and
  the bf16 moments a bf16 ulp of their row's largest. deepfm_bf16 is
  held to its bf16 rule: the first step's losses (the forward of the
  shared state) within 2e-5, the later ones within a bf16 ulp (2^-7)
  relative, the eval loss within BF16_EVAL_RTOL and its weights within 2
  lr a step (its control, the port at f32, fails here:
  test_bf16_rule_refuses_an_f32_port). multi_optimizer_freeze's `dnn_0`
  names no flax path (the DNN's layers are dnn/dense_0), so nothing is
  frozen on either side."""
  three_steps_against_jax(name, tmp_path, monkeypatch)


# deepfm_bf16's eval loss from the perturbed state, port against JAX:
# where the two sides' f32 sums straddle a bf16 rounding boundary a hidden
# value rounds a bf16 ulp apart, which the perturbed weights carry to its
# row's probability; the bf16 port stays within it, its control at f32
# does not (ROADMAP's known divergences)
BF16_EVAL_RTOL = 2e-3


def three_steps_against_jax(name, tmp_path, monkeypatch, port_dtype=None):
  """test_three_steps_match_jax_trainer's checks, the port's trainer at
  the compute_dtype `port_dtype` where given."""
  monkeypatch.setenv('EASYREC_ATTN_IMPL', 'stock')
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', '0')
  t_cfg, j_cfg = sample_configs(name, str(tmp_path), no_dropout)
  bf16 = t_cfg.train_config.compute_dtype == 'bfloat16'
  if port_dtype is not None:
    t_cfg.train_config.compute_dtype = port_dtype
  batches = jax_batches(j_cfg, 3)
  batches[1]['sample_weight'][-5:] = 0.0
  jt = JTrainer(j_cfg, devices=jax.devices('cpu')[:1])
  tt = TTrainer(t_cfg, device='cpu')
  state = jt.init_state(batches[0])
  shaken = _perturbed(jt, state)
  _carry_state(jt, shaken, tt)
  assert tt.frozen == []
  evals = jax_batches(j_cfg, 2)
  t_eval = tt.evaluate(eval_iter=[dict(b) for b in evals])
  j_eval = jt.evaluate(shaken, eval_iter=[dict(b) for b in evals])
  j_eval.pop('exchange_overflow_rate', None)
  assert sorted(t_eval) == sorted(j_eval)
  for k, v in j_eval.items():
    np.testing.assert_allclose(
        t_eval[k], v, rtol=(BF16_EVAL_RTOL if bf16 else 2e-5) if k == 'loss'
        else 0, atol=0 if k == 'loss' else 1e-3, err_msg=k)
  _carry_state(jt, state, tt)
  for step, b in enumerate(batches):
    state, j_loss = jt.train_step(state, jt.rules.shard_batch(b))
    t_loss = tt.train_step(to_device(b, torch.device('cpu')))
    assert sorted(t_loss) == sorted(k for k in j_loss
                                    if not k.startswith('exchange_'))
    for k, v in t_loss.items():
      np.testing.assert_allclose(float(v), float(j_loss[k]),
                                 rtol=BF16_ULP if bf16 and step else 2e-5,
                                 atol=1e-7,
                                 err_msg=k)
  if bf16:
    params, _ = convert.state_dict_to_flax(tt.model.state_dict(),
                                           tt.model.flax_root)
    for path, got in jax.tree_util.tree_leaves_with_path(params):
      want = np.asarray(functools.reduce(lambda t, k: t[k.key], path,
                                         jax.device_get(state.params)))
      assert np.abs(got - want).max() <= 2 * LR_SUM
    return
  _check_params(tt, state, True, LR_SUM,
                cancelled=_rounding_noise(jax.device_get(state.params)))
  _check_tables(jt, tt, state)


@pytest.mark.parametrize('check', ['forward', 'three_steps'])
def test_bf16_rule_refuses_an_f32_port(check, tmp_path, monkeypatch):
  """The bf16 rule's control: deepfm_bf16 with the port at f32 against the
  JAX package at bf16 fails test_forward_matches_jax's and
  test_three_steps_match_jax_trainer's checks, through their own
  assertions: a port that ignored compute_dtype would not pass them."""
  run = forward_against_jax if check == 'forward' else \
      three_steps_against_jax
  dtype = torch.float32 if check == 'forward' else 'float32'
  with pytest.raises(AssertionError, match='Not equal to tolerance'):
    run('deepfm_bf16', tmp_path, monkeypatch, dtype)


@pytest.mark.parametrize('fused', ['0', '1'])
def test_freeze_gradient_keeps_weights_bit_unchanged(fused, tmp_path,
                                                     monkeypatch):
  """freeze_gradient regexes searched into each flax path ('dnn/dense_0'
  here, and '^inner/logits/bias$'): the matched parameters stay bit
  for bit as they started on both sides over three Adam steps, the rest
  move and agree; the dense optimizer's state of a frozen parameter stays
  as it started (a zero gradient adds nothing to its accumulators)."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', fused)

  def edit(text):
    return text.replace('freeze_gradient: "dnn_0"',
                        'freeze_gradient: "dnn/dense_0"\n'
                        '  freeze_gradient: "^inner/logits/bias$"')
  t_cfg, j_cfg = sample_configs('multi_optimizer_freeze', str(tmp_path),
                                edit)
  batches = jax_batches(j_cfg, 3)
  jt = JTrainer(j_cfg, devices=jax.devices('cpu')[:1])
  tt = TTrainer(t_cfg, device='cpu')
  state = jt.init_state(batches[0])
  _carry_state(jt, state, tt)
  names = {n for n, (_, path) in convert.flax_names(
      dict(tt.model.named_parameters()), 'inner').items()
           if 'dnn/dense_0' in path or path == 'inner/logits/bias'}
  assert names == {'dnn.dense_0.weight', 'dnn.dense_0.bias',
                   'final_dnn.dense_0.weight', 'final_dnn.dense_0.bias',
                   'logits.bias'}
  params = dict(tt.model.named_parameters())
  assert sorted(id(p) for p in tt.frozen) == \
      sorted(id(params[n]) for n in names)
  before = {n: p.detach().clone() for n, p in params.items()}
  opt_before = {slot: {n: v.clone() for n, v in d.items()} for slot, d in
                tt.dense_opt.state_dict().items() if isinstance(d, dict)}
  j_before = jax.device_get(state.params)
  for b in batches:
    state, _ = jt.train_step(state, jt.rules.shard_batch(b))
    tt.train_step(to_device(b, torch.device('cpu')))
  j_after = jax.device_get(state.params)
  flax = convert.flax_names(params, 'inner')
  for n, p in params.items():
    path = flax[n][1].split('/')
    j0 = functools.reduce(lambda t, k: t[k], path, j_before)
    j1 = functools.reduce(lambda t, k: t[k], path, j_after)
    if n in names:
      assert torch.equal(p.detach(), before[n]), n
      np.testing.assert_array_equal(np.asarray(j1), np.asarray(j0))
      for slot in tt.dense_opt.slot_names:
        assert torch.equal(tt.dense_opt.state_dict()[slot][n],
                           opt_before[slot][n]), (n, slot)
    else:
      assert not torch.equal(p.detach(), before[n]), n
  _check_params(tt, state, True, LR_SUM)
