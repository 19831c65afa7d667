"""The in-train hooks and the dense EMA of the port against the JAX package
on the CPU: the four hooks decide alike on one scripted metric sequence,
Trainer.fit drives them (best export, online eval files, early stop, the
deadline and the stop-signal file), and use_moving_average's EMA follows
the JAX trainer's, is what export writes, and resumes bit for bit."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.export import saved_model as t_sm
from easyrec_torch.optim import builder as t_builder
from easyrec_torch.train import hooks as t_hooks
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.export import saved_model as j_sm
from easyrec_tpu.optim import builder as j_builder
from easyrec_tpu.train import hooks as j_hooks
from easyrec_tpu.train.trainer import Trainer as JTrainer
from easyrec_tpu.utils.synthetic import synthetic_batch
from tests import fixtures
from tests.test_samples import _write_csv
from tests.test_torch_slice import CONFIG as SLICE_CONFIG
from tests.test_torch_slice import _carry_initial_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one scripted eval sequence: (step, metrics)
SEQUENCE = [(2, {'auc': 0.60, 'loss': 0.70}), (4, {'auc': 0.65, 'loss': 0.69}),
            (6, {'auc': 0.64, 'loss': 0.66}), (8, {'auc': 0.65, 'loss': 0.67}),
            (10, {'auc': 0.70, 'loss': 0.68}), (12, {'auc': 0.69,
                                                     'loss': 0.60}),
            (14, {'auc': 0.68, 'loss': 0.61}), (16, {'auc': 0.60,
                                                     'loss': 0.62}),
            (18, {'loss': 0.5})]


def stop_below(metrics, params):
  """An early_stop_func: stop once auc falls below float(params)."""
  return 'auc' in metrics and metrics['auc'] < float(params)


EXPORT_CONFIGS = [
    'enable_early_stop: true max_check_steps: 4',
    'enable_early_stop: true max_check_steps: 6',
    'enable_early_stop: true best_exporter_metric: "loss" '
    'metric_bigger: false max_check_steps: 4',
    'enable_early_stop: false max_check_steps: 2',
    'early_stop_func: "tests.test_torch_hooks.stop_below" '
    'early_stop_params: "0.645"',
]


def _decisions(hooks_mod, export_config, tmp):
  stopper = hooks_mod.EarlyStopper(export_config)
  best = hooks_mod.BestExporter(tmp, metric=export_config.best_exporter_metric
                                or 'auc', bigger=export_config.metric_bigger)
  exported = []

  def export_fn(d):
    os.makedirs(d)
    exported.append(os.path.basename(d))

  out = []
  for step, metrics in SEQUENCE:
    out.append((step, best.maybe_export(step, metrics, export_fn),
                stopper.should_stop(step, metrics)))
  return out, exported, best.best_step, sorted(os.listdir(tmp))


@pytest.mark.parametrize('body', EXPORT_CONFIGS)
def test_hooks_decide_as_the_jax_hooks(body, tmp_path):
  text = 'export_config { %s }' % body
  t_ec = t_config.get_configs_from_pipeline_str(text).export_config
  j_ec = j_config.get_configs_from_pipeline_str(text).export_config
  t_out = _decisions(t_hooks, t_ec, str(tmp_path / 't'))
  j_out = _decisions(j_hooks, j_ec, str(tmp_path / 'j'))
  assert t_out == j_out
  assert t_out[2] is not None and t_out[3] == ['best_export']
  assert any(stop for _, _, stop in t_out[0]) == \
      (body != EXPORT_CONFIGS[3])


def test_deadline_and_stop_signal_decide_as_the_jax_hooks(tmp_path):
  for line in ('20000101 00:00:00', '20991231 23:59:59', ''):
    assert t_hooks.DeadlineStopper(line).should_stop() == \
        j_hooks.DeadlineStopper(line).should_stop() == \
        (line.startswith('2000'))
  with pytest.raises(ValueError):
    t_hooks.DeadlineStopper('2000-01-01')
  for enabled in (False, True):
    t_sig = t_hooks.StopSignalFile(str(tmp_path), enabled=enabled)
    j_sig = j_hooks.StopSignalFile(str(tmp_path), enabled=enabled)
    assert not t_sig.should_stop() and not j_sig.should_stop()
    open(os.path.join(tmp_path, 'OSS_STOP_SIGNAL'), 'w').close()
    assert t_sig.should_stop() == j_sig.should_stop() == enabled
    os.remove(os.path.join(tmp_path, 'OSS_STOP_SIGNAL'))
  assert not t_hooks.StopSignalFile('', enabled=True).should_stop()


def _sample(name, tmp, edits):
  """samples/<name>.config on a CSV of its declared columns, in tmp."""
  cfg = t_config.get_configs_from_pipeline_file(
      os.path.join(REPO, 'samples', name + '.config'))
  cols = [f.input_name for f in cfg.data_config.input_fields]
  data = os.path.join(tmp, 'data.csv')
  _write_csv(data, cols, 256, seed=5)
  t_config.edit_config(cfg, dict({
      'train_input_path': data, 'eval_input_path': data,
      'model_dir': os.path.join(tmp, 'md'), 'data_config.batch_size': 32,
      'data_config.eval_batch_size': 32}, **edits))
  return cfg


def test_best_exporter_sample_writes_best_export_and_online_evals(tmp_path):
  """samples/best_exporter_early_stop.config (cut to 8 steps, a save every
  2, eval_online on): an online eval file at every save, and the best
  export a port bundle of the step with the best AUC."""
  cfg = _sample('best_exporter_early_stop', str(tmp_path), {
      'train_config.num_steps': 8, 'train_config.save_checkpoints_steps': 2,
      'eval_config.eval_online': True})
  trainer = TTrainer(cfg, device='cpu')
  result = trainer.fit()
  assert result['global_step'] == 8
  md = cfg.model_dir
  online = {int(n.rsplit('-', 1)[1]): n for n in os.listdir(md)
            if n.startswith('online_eval_result.txt-')}
  assert sorted(online) == [2, 4, 6, 8]
  best = os.listdir(os.path.join(md, 'best_export'))
  assert len(best) == 1
  _, state = t_sm.load_serving_state(os.path.join(md, 'best_export',
                                                  best[0]))
  aucs = {}
  for step, name in online.items():
    with open(os.path.join(md, name)) as f:
      aucs[step] = json.load(f)['auc']
  # the first of the steps that reached the highest AUC
  assert int(state['step']) == min(s for s in aucs
                                   if aucs[s] == max(aucs.values()))


def test_early_stop_func_stops_at_the_first_save(tmp_path):
  cfg = _sample('best_exporter_early_stop', str(tmp_path), {
      'train_config.num_steps': 20, 'train_config.save_checkpoints_steps': 3,
      'export_config.early_stop_func': 'tests.test_torch_hooks.stop_below',
      'export_config.early_stop_params': '2.0'})
  result = TTrainer(cfg, device='cpu').fit(eval_at_end=False)
  assert result['global_step'] == 3
  assert sorted(os.listdir(os.path.join(cfg.model_dir, 'checkpoints'))) == \
      ['3']


@pytest.mark.parametrize('how', ['dead_line', 'stop_signal'])
def test_deadline_and_signal_stop_at_the_first_log_boundary(how, tmp_path):
  """dead_line_stop.config with a deadline in the past, or the stop-signal
  file present: training stops after the first log boundary (step 3)."""
  edits = {'train_config.num_steps': 100,
           'train_config.log_step_count_steps': 3}
  if how == 'dead_line':
    edits['train_config.dead_line'] = '20200101 00:00:00'
  else:
    edits['train_config.enable_oss_stop_signal'] = True
  cfg = _sample('dead_line_stop', str(tmp_path), edits)
  if how == 'stop_signal':
    os.makedirs(cfg.model_dir)
    open(os.path.join(cfg.model_dir, 'OSS_STOP_SIGNAL'), 'w').close()
  result = TTrainer(cfg, device='cpu').fit(eval_at_end=False)
  assert result['global_step'] == 3
  assert len(result['losses']) == 3


# -------------------------------------------------------------------- EMA

def test_ema_arithmetic_matches_param_ema():
  """The port's EMA update against the JAX package's param_ema, run op by
  op (eagerly) on the same parameter sequence: bit-equal. Each step moves
  the parameters by a relative 1e-3, so p_next - p is exact in f32 and the
  JAX side's p + u is p_next exactly."""
  rng = np.random.default_rng(0)
  p0 = rng.standard_normal((5, 7)).astype(np.float32)
  seq = [p0]
  for _ in range(4):
    seq.append((seq[-1] * np.float32(1.001)).astype(np.float32))
  decay = float(np.float32(0.99))

  class Replay(t_builder.DenseOptimizer):
    def _update(self, grads, neg_lr):
      self.params[0].copy_(torch.from_numpy(seq[int(self.count) + 1]))

  p = torch.nn.Parameter(torch.from_numpy(seq[0].copy()))
  opt = Replay({'p': p}, schedule=lambda c: 0.0).with_ema(decay)
  tx = j_builder.param_ema(decay)
  state = tx.init({'p': jax.numpy.asarray(seq[0])})
  for k in range(4):
    opt.step()
    _, state = tx.update({'p': jax.numpy.asarray(seq[k + 1] - seq[k])},
                         state, {'p': jax.numpy.asarray(seq[k])})
    assert np.array_equal(np.asarray(state.ema['p']),
                          opt.named_ema()['p'].numpy())


EMA_OPT = 'use_moving_average: true moving_average_decay: 0.99 }'


def _ema_text():
  text = SLICE_CONFIG % {'bn': 'false'}
  return text.replace('min_learning_rate: 0.004 } } } }',
                      'min_learning_rate: 0.004 } } } ' + EMA_OPT, 1)


def test_three_ema_steps_match_the_jax_trainer(tmp_path, monkeypatch):
  """The small DeepFM with use_moving_average (decay 0.99), three steps
  from one initial state (the EMA carried over from the JAX optax state by
  convert.optax_to_dense_state): the EMA weights agree with the JAX
  trainer's within 5e-6, the dense parameters' own tolerance in
  tests/test_torch_slice.py (XLA may contract decay * e + (1 - decay) * p
  into one FMA, a few ulp; the parameters the EMA averages differ by up to
  5e-6). The port's export holds the EMA, not the live parameters, and so
  does the JAX export, within the same tolerance."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  text = _ema_text()
  jt = JTrainer(j_config.get_configs_from_pipeline_str(text),
                devices=jax.devices('cpu')[:1])
  tt = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  batches = [synthetic_batch(jt.specs, ['label'], 64, seed=s)
             for s in range(3)]
  state = jt.init_state(batches[0])
  _carry_initial_state(jt, state, tt)
  assert tt.dense_opt.state_slots == ('mu', 'nu', 'ema')
  tt.dense_opt.load_state_dict(convert.optax_to_dense_state(
      jax.device_get(state.opt_state), tt.dense_opt.state_slots))
  for s in range(3):
    state, _ = jt.train_step(state, jt.rules.shard_batch(batches[s]))
    tt.train_step(to_device(batches[s], torch.device('cpu')))
  j_ema = jax.device_get(j_builder.find_param_ema(state.opt_state))
  want = convert.flax_to_state_dict(j_ema)
  got = tt.dense_opt.named_ema()
  assert sorted(got) == sorted(want)
  live = dict(tt.model.named_parameters())
  for k in got:
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                               atol=5e-6, err_msg=k)
    assert not torch.equal(got[k], live[k]), k       # the EMA lags

  port_dir = t_sm.export_saved_model(tt, str(tmp_path / 'port'))
  _, port = t_sm.load_serving_state(port_dir)
  for k in got:
    assert torch.equal(port['model'][k], got[k]), k
  j_dir = j_sm.export_saved_model(jt, state, str(tmp_path / 'jax'))
  _, vs = j_sm.load_serving_state(j_dir)
  j_exported = convert.flax_to_state_dict(
      jax.tree_util.tree_map(np.asarray, vs['params']))
  for k in got:
    np.testing.assert_allclose(port['model'][k].numpy(),
                               j_exported[k].numpy(), rtol=0, atol=5e-6,
                               err_msg=k)


def test_resume_with_ema_and_online_eval_equals_one_run(tmp_path):
  """The CLI fixture's DeepFM with BatchNorm, use_moving_average and
  eval_online, unshuffled: 6 steps with a save (and an online eval) every
  2, against 4 steps then a resume to 6 on another model_dir. The online
  evals run in eval mode on the EMA, so neither the live parameters nor
  BatchNorm's statistics move: step, tables, model, and the dense
  optimizer's state with its EMA equal bit for bit."""
  body = fixtures.DEEPFM_BODY.replace('use_bn: false', 'use_bn: true')
  path = fixtures.write_pipeline(str(tmp_path), model_body=body,
                                 num_steps=6, n_train=1024, n_eval=256)
  runs = []
  for name, stops in (('one', [6]), ('two', [4, 6])):
    for n in stops:
      cfg = t_config.get_configs_from_pipeline_file(path)
      t_config.edit_config(cfg, {
          'model_dir': str(tmp_path / name), 'train_config.num_steps': n,
          'train_config.save_checkpoints_steps': 2,
          'data_config.shuffle': False, 'eval_config.eval_online': True})
      opt = cfg.train_config.optimizer_config[0]
      opt.use_moving_average = True
      opt.moving_average_decay = 0.99
      trainer = TTrainer(cfg, device='cpu')
      result = trainer.fit(eval_at_end=False)
    runs.append((trainer, result))
  (a, ra), (b, rb) = runs
  assert ra['global_step'] == rb['global_step'] == 6
  assert ra['losses'][4:] == rb['losses']
  assert sorted(os.listdir(tmp_path / 'two')) == sorted(
      os.listdir(tmp_path / 'one'))
  assert a.dense_opt.named_ema() is not None

  def flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
      if isinstance(v, dict):
        out.update(flat(v, prefix + k + '/'))
      else:
        out[prefix + k] = v
    return out

  sa, sb = flat(a.state_dict()), flat(b.state_dict())
  assert sorted(sa) == sorted(sb)
  assert any(k.startswith('dense_opt/ema/') for k in sa)
  assert any(k.endswith('running_mean') for k in sa)
  for k in sa:
    assert torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])), k
