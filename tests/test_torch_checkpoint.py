"""Checkpoints, resume and fine-tune in the port (easyrec_torch/train/
checkpoints.py, restore.py, the checkpoint parts of Trainer.fit, the input's
skip_rows, convert.py's optax mapping) on the CPU, against the JAX package
where it has a counterpart: its pipeline's skip_rows, its Trainer's
checkpoint restored on the JAX side and carried over, its optax states and
its fine_tune_restore on the same config."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch import train_eval as t_train_eval
from easyrec_torch.config import config_util as t_config
from easyrec_torch.data import input_pipeline as t_input
from easyrec_torch.optim import builder as t_builder
from easyrec_torch.train import checkpoints as t_ckpt
from easyrec_torch.train import restore as t_restore
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_torch.utils import flagship as t_flagship
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.data import input_pipeline as j_input
from easyrec_tpu.optim import builder as j_builder
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.train import checkpoints as j_ckpt
from easyrec_tpu.train import restore as j_restore
from easyrec_tpu.train.trainer import Trainer as JTrainer
from easyrec_tpu.utils import flagship as j_flagship
from easyrec_tpu.utils.synthetic import synthetic_batch
from tests import fixtures
from tests.test_torch_slice import CONFIG as SLICE_CONFIG
from tests.test_torch_slice import TABLE_OPTIMIZERS

BF16_ULP = 2.0 ** -7


def _ev_pipeline(tmp, num_steps=12, save_every=3, keep=10):
  """The CLI fixture (DeepFM on a 4096-row CSV, batch 256) with ev_params
  on the id features, shuffle off."""
  path = fixtures.write_pipeline(str(tmp), num_steps=num_steps)
  with open(path) as f:
    text = f.read()
  text = text.replace(
      'hash_bucket_size: 200 }',
      'hash_bucket_size: 200 ev_params { filter_freq: 2 steps_to_live: 5 } }')
  text = text.replace('save_checkpoints_steps: 500',
                      'save_checkpoints_steps: %d keep_checkpoint_max: %d'
                      % (save_every, keep))
  text = text.replace('num_epochs: 0', 'num_epochs: 0 shuffle: false')
  with open(path, 'w') as f:
    f.write(text)
  return path


def _flat(tree, prefix=''):
  """name -> tensor of a nested dict of tensors (a state_dict)."""
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out.update(_flat(v, prefix + k + '/'))
    else:
      out[prefix + k] = torch.as_tensor(v)
  return out


def _assert_states_equal(a, b):
  fa, fb = _flat(a), _flat(b)
  assert sorted(fa) == sorted(fb)
  for k in fa:
    assert fa[k].dtype == fb[k].dtype, k
    assert torch.equal(fa[k].cpu(), fb[k].cpu()), k


def test_round_trip_of_every_part_is_bit_exact(tmp_path):
  """Two steps, a save, and a trainer of another seed restored from it:
  step, model (BatchNorm statistics included), tables with their Adam
  slots, EV counters and dense Adam state come back bit for bit."""
  path = _ev_pipeline(tmp_path)
  cfg = t_config.get_configs_from_pipeline_file(path)
  cfg.model_config.deepfm.dnn.use_bn = True
  a = TTrainer(cfg, device='cpu')
  a.init_state()
  for batch, _ in zip(a.train_input(), range(2)):
    a.train_step(to_device(batch, a.device))
  assert float(a.ev_state['emb8']['ev_count'].sum()) > 0
  manager = t_ckpt.CheckpointManager(str(tmp_path / 'rt'),
                                     layout_stamp=a.layout_stamp())
  assert manager.save(a.state_dict(), 2)
  assert not manager.save(a.state_dict(), 2)       # a re-save is a no-op
  cfg.train_config.random_seed = 7
  b = TTrainer(cfg, device='cpu')
  b.init_state()
  assert not torch.equal(a.tables['emb8'], b.tables['emb8'])
  b.load_state_dict(manager.restore_latest())
  assert int(b.step) == 2
  _assert_states_equal(a.state_dict(), b.state_dict())
  with open(os.path.join(manager.step_dir(2), 'layout.json')) as f:
    stamp = json.load(f)
  meta = a.metas['emb8']
  assert stamp['tables']['emb8'] == {'rows': meta.rows, 'dim': meta.dim,
                                     'n_parts': 3, 'compact': True}
  assert stamp['ev'] == {'emb8': {'ev_count': a.metas['emb8'].rows,
                                  'ev_last': a.metas['emb8'].rows}}


def test_keep_max_deletes_the_oldest(tmp_path):
  manager = t_ckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
  for step in (1, 2, 3, 5):
    manager.save({'step': torch.tensor(step)}, step)
  assert manager.all_steps() == [3, 5]
  assert manager.latest_step() == 5
  assert sorted(os.listdir(tmp_path / 'checkpoints')) == ['3', '5']
  assert int(manager.restore_latest()['step']) == 5
  assert t_ckpt.resolve(str(tmp_path)).endswith(os.path.join(
      'checkpoints', '5'))


def test_an_interrupted_write_leaves_the_previous_latest(tmp_path,
                                                         monkeypatch):
  manager = t_ckpt.CheckpointManager(str(tmp_path))
  manager.save({'step': torch.tensor(1)}, 1)
  real_save = torch.save

  def killed(obj, f):
    with open(f, 'wb') as out:
      out.write(b'half a checkpoint')
    raise KeyboardInterrupt('killed while saving')

  monkeypatch.setattr(t_ckpt.torch, 'save', killed)
  with pytest.raises(KeyboardInterrupt):
    manager.save({'step': torch.tensor(2)}, 2)
  monkeypatch.setattr(t_ckpt.torch, 'save', real_save)
  assert manager.latest_step() == 1
  assert int(manager.restore_latest()['step']) == 1
  leftovers = [d for d in os.listdir(tmp_path / 'checkpoints')
               if d.startswith('.tmp-')]
  assert len(leftovers) == 1
  manager = t_ckpt.CheckpointManager(str(tmp_path))     # cleans it up
  assert os.listdir(tmp_path / 'checkpoints') == ['1']
  assert manager.save({'step': torch.tensor(2)}, 2)
  assert manager.latest_step() == 2


def test_a_changed_table_layout_raises_naming_the_table(tmp_path):
  """A run on a model_dir whose checkpoint has other table geometry (here
  a larger hash bucket) refuses to restore it, naming the table."""
  path = fixtures.write_pipeline(tmp_path, num_steps=2)
  cfg = t_config.get_configs_from_pipeline_file(path)
  TTrainer(cfg, device='cpu').fit(eval_at_end=False)
  for fc in cfg.feature_config.features:
    if fc.input_names[0] == 'c2':
      fc.hash_bucket_size = 300
  with pytest.raises(t_ckpt.LayoutMismatchError,
                     match=r"table 'emb8' geometry"):
    TTrainer(cfg, device='cpu').fit(eval_at_end=False)


def test_a_toggled_compact_layout_raises_naming_it(tmp_path, monkeypatch):
  path = fixtures.write_pipeline(tmp_path, num_steps=2)
  cfg = t_config.get_configs_from_pipeline_file(path)
  TTrainer(cfg, device='cpu').fit(eval_at_end=False)
  monkeypatch.setenv('EASYREC_PACKED_COMPACT', '0')
  with pytest.raises(t_ckpt.LayoutMismatchError,
                     match='EASYREC_PACKED_COMPACT toggles it'):
    TTrainer(cfg, device='cpu').fit(eval_at_end=False)


def _assert_batches_equal(t_pipe, j_pipe, n):
  t_it, j_it = iter(t_pipe), iter(j_pipe)
  for _ in range(n):
    t_b, j_b = next(t_it), next(j_it)
    assert sorted(t_b) == sorted(j_b)
    for k in j_b:
      np.testing.assert_array_equal(t_b[k], j_b[k], err_msg=k)


@pytest.mark.parametrize('skip', [0, 1000, 5000])
def test_skip_rows_matches_jax_pipeline_csv(skip, tmp_path):
  """The CLI fixture's 4096-row CSV at batch 256, shuffled (one reader
  chunk a file on both sides): raw rows dropped before the transforms and
  the shuffle, across chunks and into the second epoch (5000)."""
  path = fixtures.write_pipeline(tmp_path)
  t_cfg = t_config.get_configs_from_pipeline_file(path)
  j_cfg = j_config.get_configs_from_pipeline_file(path)
  src = t_config.get_train_input_path(t_cfg)
  t_pipe = t_input.InputPipeline(
      t_cfg.data_config, t_config.get_feature_configs(t_cfg), src,
      batch_size=256, skip_rows=skip)
  j_pipe = j_input.InputPipeline(
      j_cfg.data_config, j_config.get_feature_configs(j_cfg), src,
      batch_size=256, skip_rows=skip)
  _assert_batches_equal(t_pipe, j_pipe, 20)


@pytest.mark.parametrize('skip', [100, 70000])
def test_skip_rows_matches_jax_pipeline_dummy(skip):
  t_cfg = t_flagship.criteo_deepfm_config(batch_size=64)
  j_cfg = j_flagship.criteo_deepfm_config(batch_size=64, model_dir='')
  t_pipe = t_input.InputPipeline(
      t_cfg.data_config, t_config.get_feature_configs(t_cfg), 'synthetic',
      skip_rows=skip)
  j_pipe = j_input.InputPipeline(
      j_cfg.data_config, j_config.get_feature_configs(j_cfg), 'synthetic',
      skip_rows=skip)
  _assert_batches_equal(t_pipe, j_pipe, 3)


def test_resumed_cli_run_equals_the_uninterrupted_one(tmp_path):
  """python -m easyrec_torch.train_eval: twelve steps in one call, and six
  then twelve in two calls on another model_dir (--edit_config_json), a
  checkpoint every 3 steps and at most 2 kept. Shuffle is off: the resume
  drops raw rows before the shuffle, which then permutes the chunks after
  it with other seeds than an uninterrupted run does. The two final
  checkpoints are equal bit for bit."""
  path = _ev_pipeline(tmp_path, num_steps=12, save_every=3, keep=2)
  base = ['--pipeline_config_path', path, '--device', 'cpu']
  one, two = str(tmp_path / 'one'), str(tmp_path / 'two')
  assert t_train_eval.main(base + ['--edit_config_json',
                                   json.dumps({'model_dir': one})]) == 0
  assert t_train_eval.main(base + ['--edit_config_json', json.dumps(
      {'model_dir': two, 'train_config.num_steps': 6})]) == 0
  assert sorted(os.listdir(os.path.join(two, 'checkpoints'))) == ['3', '6']
  assert t_train_eval.main(base + ['--edit_config_json',
                                   json.dumps({'model_dir': two})]) == 0
  for d in (one, two):
    assert sorted(os.listdir(os.path.join(d, 'checkpoints'))) == ['12', '9']
  a, _ = t_ckpt.load(one)
  b, _ = t_ckpt.load(two)
  assert int(a['step']) == int(b['step']) == 12
  _assert_states_equal(a, b)


def _jax_fit(text, model_dir, steps):
  cfg = j_config.get_configs_from_pipeline_str(text)
  cfg.model_dir = model_dir
  jt = JTrainer(cfg, devices=jax.devices('cpu')[:1])
  jt.fit(num_steps=steps, eval_at_end=False)
  return jt


def _jax_restored(jt, model_dir, batch):
  """The JAX checkpoint, restored on the JAX side, as numpy arrays."""
  template = jt.init_state(batch)
  manager = j_ckpt.CheckpointManager(model_dir,
                                     layout_stamp=jt.layout_stamp())
  state = manager.restore_latest(template)
  manager.close()
  return jax.tree_util.tree_map(np.asarray, state)


def _port_state_from_jax(jt, state, tt):
  """convert.py's mapping of a restored JAX TrainState onto the port's
  Trainer.state_dict."""
  tables = {}
  for key, meta in jt.pack_metas.items():
    tables[key] = torch.from_numpy(convert.jax_packed_to_table(
        state.tables[key], meta.dim, tt.metas[key].rows, meta.n_parts))
  return {'step': torch.tensor(int(state.step)),
          'model': convert.flax_to_state_dict(state.params,
                                              state.batch_stats),
          'tables': tables, 'ev': {},
          'dense_opt': convert.optax_to_dense_state(
              state.opt_state, tt.dense_opt.slot_names)}


@pytest.mark.parametrize('tables', ['adam', 'adagrad'])
def test_a_jax_checkpoint_continues_in_the_port(tables, tmp_path,
                                                monkeypatch):
  """The JAX Trainer trains the small DeepFM of test_torch_slice.py 3 steps
  (EASYREC_PACKED_TABLES=1, f32 sums, no BatchNorm) and checkpoints; the
  checkpoint is restored on the JAX side, mapped by convert.py (params,
  tables, the optax dense state: Adam's count, mu and nu, with Adam or
  with Adagrad tables beside it) and loaded into the port, and 3 more
  steps run on both sides. Tolerances are test_torch_slice.py's for this
  case: losses relative 2e-5, dense parameters 5e-6, table weights 1e-6,
  moments one bf16 ulp or 1e-9 (Adagrad's accumulator 1e-6)."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  text = SLICE_CONFIG % {'bn': 'false'}
  if tables == 'adagrad':
    text = text.replace(
        'optimizer_config { adam_optimizer',
        TABLE_OPTIMIZERS['adagrad'] + 'optimizer_config { adam_optimizer', 1)
  model_dir = str(tmp_path / 'jax')
  jt = _jax_fit(text, model_dir, 3)
  tt = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  batches = [synthetic_batch(jt.specs, ['label'], 64, seed=10 + s)
             for s in range(3)]
  state = _jax_restored(jt, model_dir, batches[0])
  assert int(state.step) == 3
  tt.init_state()
  tt.load_state_dict(_port_state_from_jax(jt, state, tt))
  assert int(tt.dense_opt.count) == 3
  state = jax.tree_util.tree_map(jnp.asarray, state)
  for b in batches:
    state, j_loss = jt.train_step(state, jt.rules.shard_batch(b))
    t_loss = tt.train_step(to_device(b, torch.device('cpu')))
    np.testing.assert_allclose(float(t_loss['total_loss']),
                               float(j_loss['total_loss']), rtol=2e-5)
  assert int(tt.step) == int(state.step) == 6
  params, _ = convert.state_dict_to_flax(tt.model.state_dict())
  j_params = jax.device_get(state.params)
  for path, got in jax.tree_util.tree_leaves_with_path(params):
    want = np.asarray(functools.reduce(lambda t, k: t[k.key], path,
                                       j_params))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6,
                               err_msg=jax.tree_util.keystr(path))
  for key, meta in jt.pack_metas.items():
    tmeta = tt.metas[key]
    jw, js = jpt.unpack_host(np.asarray(state.tables[key]), meta,
                             tmeta.rows)
    from easyrec_torch.ops import packed_table as tpt
    tw, ts = tpt.unpack_host(tt.tables[key].numpy(), tmeta)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6)
    for got, want in zip(ts, js):
      np.testing.assert_allclose(got, want,
                                 rtol=BF16_ULP if tmeta.compact else 0,
                                 atol=1e-9 if tmeta.compact else 1e-6)


DENSE_KINDS = {
    'adam_optimizer': 'beta1: 0.8',
    'adamw_optimizer': 'weight_decay: 0.01',
    'adagrad_optimizer': 'initial_accumulator_value: 0.2',
    'momentum_optimizer': 'momentum_optimizer_value: 0.7',
    'momentumw_optimizer': 'weight_decay: 0.01',
    'rms_prop_optimizer': 'decay: 0.8 epsilon: 0.1',
    'ftrl_optimizer': 'l1_reg: 0.01',
}
LR = ('learning_rate { exponential_decay_learning_rate { '
      'initial_learning_rate: 0.05 decay_steps: 1 decay_factor: 0.5 } }')


@pytest.mark.parametrize('clip', [0.0, 1.0])
@pytest.mark.parametrize('kind', sorted(DENSE_KINDS))
def test_optax_state_maps_onto_the_dense_state(kind, clip):
  """Two optax updates of the JAX builder's dense transform (clipping
  ahead of it where gradient_clipping_by_norm is set), its state mapped by
  convert.optax_to_dense_state onto the port's optimizer, then one more
  step on both sides: the port's step continues the schedule and the
  slots (within 1e-6, test_torch_optim.py's tolerance for the dense
  optimizers), and its state_dict round-trips by parameter name."""
  text = ('train_config { optimizer_config { %s { %s %s } } '
          'gradient_clipping_by_norm: %s }' % (kind, LR, DENSE_KINDS[kind],
                                               clip))
  j_pair = j_builder.build_optimizers(
      j_config.get_configs_from_pipeline_str(text).train_config)[0]
  t_pair = t_builder.build_optimizers(
      t_config.get_configs_from_pipeline_str(text).train_config)[0]
  rng = np.random.default_rng(5)
  shapes = {'dense_0': {'kernel': (4, 3), 'bias': (3,)},
            'bn_0': {'scale': (3,), 'bias': (3,)}}
  params = {'inner': {m: {k: rng.standard_normal(s).astype(np.float32)
                          for k, s in leaves.items()}
                      for m, leaves in shapes.items()}}
  grads = [jax.tree_util.tree_map(
      lambda p: (rng.standard_normal(p.shape) * 2).astype(np.float32),
      params) for _ in range(3)]
  j_params = jax.tree_util.tree_map(jnp.asarray, params)
  j_state = j_pair.dense.init(j_params)
  for g in grads[:2]:
    upd, j_state = j_pair.dense.update(jax.tree_util.tree_map(jnp.asarray,
                                                              g),
                                       j_state, j_params)
    j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params, upd)
  named = {k: v.clone() for k, v in convert.flax_to_state_dict(
      jax.device_get(j_params)).items()}
  dense = t_pair.dense(named)
  state = convert.optax_to_dense_state(
      jax.tree_util.tree_map(np.asarray, j_state), dense.slot_names)
  assert int(state['count']) == 2
  dense.load_state_dict(state)
  upd, _ = j_pair.dense.update(jax.tree_util.tree_map(jnp.asarray,
                                                      grads[2]),
                               j_state, j_params)
  j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params, upd)
  for name, g in convert.flax_to_state_dict(grads[2]).items():
    named[name].grad = g
  dense.step()
  want = convert.flax_to_state_dict(jax.device_get(j_params))
  for name, p in named.items():
    np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                               atol=1e-6, err_msg=name)
  saved = dense.state_dict()
  assert int(saved['count']) == 3
  assert sorted(saved) == ['count'] + sorted(dense.slot_names)
  for slot in dense.slot_names:
    assert sorted(saved[slot]) == sorted(named)
  other = t_pair.dense({k: v.clone() for k, v in named.items()})
  other.load_state_dict(saved)
  _assert_states_equal(other.state_dict(), saved)
  with pytest.raises(ValueError, match='keyed by name'):
    t_pair.dense(list(named.values())).state_dict()


VAR_MAP = ('inner/final_dnn/dense_0/bias:inner/dnn/dense_1/bias,'
           'inner/dnn/dense_0/bias:inner/final_dnn/dense_0/bias')
FILTERS = ['logits', 'bn_1']


def test_fine_tune_selects_the_same_variables_as_jax(tmp_path, monkeypatch):
  """A run of seed 2025 trains 2 steps and checkpoints on each side (the
  port's checkpoint holds the JAX run's state, mapped by convert.py); a
  run of seed 99 warm-starts from it with a var map (final_dnn's bias onto
  dnn/dense_1's, dnn/dense_0's [16] bias clipped onto final_dnn's [8] with
  force_restore_shape_compatible) and restore_filters ('logits', 'bn_1').
  The JAX package's fine_tune_restore and the port's leave the same
  values in every variable, bit for bit: restored, renamed, clipped,
  filtered or fresh alike. JAX's plain layout (the CPU default) keeps its
  tables as weights, so its table restore is by weights too."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '0')
  text = SLICE_CONFIG % {'bn': 'true'}
  src = str(tmp_path / 'src_jax')
  jt = _jax_fit(text, src, 2)
  batch = synthetic_batch(jt.specs, ['label'], 64, seed=0)
  trained = _jax_restored(jt, src, batch)
  # the port's checkpoint of the same trained state
  tt = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  tt.init_state()
  tt.model.load_state_dict(convert.flax_to_state_dict(trained.params,
                                                      trained.batch_stats))
  for key, table in tt.tables.items():
    table[:, :tt.metas[key].dim] = torch.from_numpy(
        np.array(trained.tables[key][:table.shape[0]]))
  t_src = str(tmp_path / 'src_port')
  t_ckpt.CheckpointManager(t_src, layout_stamp=tt.layout_stamp()).save(
      tt.state_dict(), 2)

  dst = text.replace('num_steps: 3', 'num_steps: 3 random_seed: 99 '
                     'force_restore_shape_compatible: true')
  jd = JTrainer(j_config.get_configs_from_pipeline_str(dst),
                devices=jax.devices('cpu')[:1])
  fresh = jd.init_state(batch)
  td = TTrainer(t_config.get_configs_from_pipeline_str(dst), device='cpu')
  td.init_state()
  td.model.load_state_dict(convert.flax_to_state_dict(
      jax.device_get(fresh.params), jax.device_get(fresh.batch_stats)))
  for key, table in td.tables.items():
    table[:, :td.metas[key].dim] = torch.from_numpy(
        np.array(fresh.tables[key])[:table.shape[0]])
  tuned = j_restore.fine_tune_restore(
      fresh, src, var_map=VAR_MAP, restore_filters=FILTERS,
      force_shape_compat=True)
  counts = t_restore.fine_tune_restore(
      td, t_src, var_map=VAR_MAP, restore_filters=FILTERS,
      force_shape_compat=True)
  params, stats = convert.state_dict_to_flax(td.model.state_dict())
  for section, got_tree, want_tree in (
      ('params', params, jax.device_get(tuned.params)),
      ('batch_stats', stats, jax.device_get(tuned.batch_stats))):
    for path, want in jax.tree_util.tree_leaves_with_path(want_tree):
      got = functools.reduce(lambda t, k: t[k.key], path, got_tree)
      np.testing.assert_array_equal(got, np.asarray(want),
                                    err_msg='%s %s' % (
                                        section, jax.tree_util.keystr(path)))
  for key, table in td.tables.items():
    np.testing.assert_array_equal(
        table[:, :td.metas[key].dim].numpy(),
        np.asarray(tuned.tables[key])[:table.shape[0]])
  # what was restored, and what stayed fresh
  p = params['inner']
  np.testing.assert_array_equal(p['dnn']['dense_1']['bias'],
                                trained.params['inner']['final_dnn']
                                ['dense_0']['bias'])
  np.testing.assert_array_equal(p['final_dnn']['dense_0']['bias'],
                                trained.params['inner']['dnn']['dense_0']
                                ['bias'][:8])
  np.testing.assert_array_equal(p['logits']['kernel'],
                                fresh.params['inner']['logits']['kernel'])
  np.testing.assert_array_equal(p['dnn']['dense_0']['bias'],
                                fresh.params['inner']['dnn']['dense_0']
                                ['bias'])
  assert counts['tables'] == len(td.tables)
  assert counts['params'] > 0 and counts['batch_stats'] > 0
  # the slots and the step stay fresh
  assert int(td.step) == 0 and int(td.dense_opt.count) == 0


def test_fit_fine_tunes_only_without_a_checkpoint(tmp_path, monkeypatch):
  """Trainer.fit runs fine_tune_checkpoint (with restore_filters) when its
  own model_dir holds no checkpoint, and not when it does: the restore
  wins, as in the JAX package."""
  from easyrec_torch.train import trainer as t_trainer
  path = fixtures.write_pipeline(tmp_path, num_steps=2)
  cfg = t_config.get_configs_from_pipeline_file(path)
  src = TTrainer(cfg, device='cpu')
  src.fit(eval_at_end=False)
  cfg.model_dir = str(tmp_path / 'tuned')
  cfg.train_config.fine_tune_checkpoint = str(tmp_path / 'ckpt')
  cfg.train_config.random_seed = 5
  cfg.model_config.restore_filters = ['logits']
  tuned = TTrainer(cfg, device='cpu')
  tuned.init_state()
  fresh = {k: v.clone() for k, v in tuned.model.state_dict().items()}
  tuned.train_input = lambda **kw: iter(())      # no step: the restore only
  tuned.fit(eval_at_end=False)
  state, src_state = tuned.model.state_dict(), src.model.state_dict()
  assert torch.equal(state['logits.weight'], fresh['logits.weight'])
  assert torch.equal(state['dnn.dense_0.weight'],
                     src_state['dnn.dense_0.weight'])
  assert not torch.equal(state['dnn.dense_0.weight'],
                         fresh['dnn.dense_0.weight'])
  assert os.listdir(os.path.join(cfg.model_dir, 'checkpoints')) == ['0']

  def refuse(*args, **kwargs):
    raise AssertionError('fine-tuned over a checkpoint of its own')

  monkeypatch.setattr(t_trainer, 'fine_tune_restore', refuse)
  again = TTrainer(cfg, device='cpu')
  again.fit(num_steps=1, eval_at_end=False)
  assert int(again.step) == 1
