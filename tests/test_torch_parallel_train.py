"""The port's data-parallel training (easyrec_torch/parallel, the world
paths of train/trainer.py) against the JAX package's mesh on the CPU.

One world of 4 gloo processes is spawned for the file and runs every case
in it (parallel/launch.py). The global batches come from the JAX side:
synthetic batches for the DeepFM with BatchNorm and the DeepFM with a
pairwise loss under OHEM, the JAX CSV pipeline for the DSSM with a
negative sampler and the MMoE (utils/dryrun.py's configs);
rank r trains on the rows the JAX mesh puts on device r, and every rank on
a sampler's whole 'neg.' view, which the mesh replicates. The reference is
Trainer(cfg, devices=jax.devices()[:4]) under EASYREC_PACKED_TABLES=1
(row-sharded packed tables, the exchange's update and pull), from the same
initial state. Each config runs twice in the world: row-sharded
(train_distribute NoStrategy) and replicated (MirroredStrategy; the JAX
package keeps a replicated table in its plain layout, so both are held to
the sharded JAX run: the same math). EASYREC_GG_BF16=0 and capacity factor
0 in the world.

Tolerances are those of the single-device parity tests
(tests/test_torch_slice.py, test_torch_match.py,
test_torch_multi_task_train.py), for the same reasons: f32 sums in another
order, across the ranks here too. Losses within 2e-5 relative (the DSSM's
in-batch softmax at temperature 1 over untrained towers 5e-5); dense
parameters within 1e-4 with BatchNorm (its Dense biases, whose gradient is
rounding noise, within 2 lr a step) and 2e-5 without; table weights within
1e-4 and Adam's bf16 moments within 3% or 2e-7. The world's tables equal
the single-process port's (the same step on the global batch) within the
same tolerances, the replicated tables are equal bit for bit on every rank,
and the exchange drops nothing on either side.

Also: the process-sharded eval through the real CSV pipeline (uneven
shards, so a rank feeds zero-weight filler batches) equals the
single-process eval in auc and gauc, as tests/test_multihost_eval.py holds
the JAX package; the DSSM with a negative sampler, row-sharded, evaluated
through its pipeline on uneven shards equals one process's eval of the
same global batches, rank 0's 'neg.' view in each (the view every rank
must pull); the exchange-overflow guardrail of
tests/test_guardrails.py:52-136; and the distribution fields of the
schema against the JAX proto.

Nothing of JAX is imported at the top of the module: the spawned processes
import it for its workers."""

import copy
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from easyrec_torch.config import config_util as t_config
from easyrec_torch.parallel import launch, mesh
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_torch.utils import dryrun as t_dryrun

WORLD = 4
STEPS = 3
LR_SUM = 0.01 * STEPS         # the configs' constant rate, 3 steps
BF16_ULP = 2.0 ** -7

DEEPFM_BN = """
  model_class: "DeepFM"
  feature_groups { group_name: "deep" feature_names: "uid"
                   feature_names: "iid" feature_names: "cate"
                   wide_deep: DEEP }
  feature_groups { group_name: "wide" feature_names: "iid"
                   wide_deep: WIDE }
  deepfm { dnn { hidden_units: [16, 8] use_bn: true }
           final_dnn { hidden_units: [8] use_bn: true }
           l2_regularization: 1e-3 }
  embedding_regularization: 1e-4
"""
# a pairwise loss with OHEM beside the classification term: its pairs and
# its hardest pairs are the global batch's (mesh.whole_batch)
DEEPFM_PAIRWISE = DEEPFM_BN.replace('use_bn: true', 'use_bn: false').replace(
    '  embedding_regularization: 1e-4\n', '''  losses { loss_type: CLASSIFICATION weight: 1.0 }
  losses { loss_type: PAIRWISE_LOGISTIC_LOSS weight: 0.5
           pairwise_logistic_loss { ohem_ratio: 0.5 } }
''')
CONFIGS = ('deepfm_bn', 'deepfm_pairwise', 'dssm_sampler', 'mmoe')
BODIES = {'deepfm_bn': DEEPFM_BN, 'deepfm_pairwise': DEEPFM_PAIRWISE}
STRATEGIES = {'sharded': 'NoStrategy', 'replicated': 'MirroredStrategy'}
ENV = {'EASYREC_GG_BF16': '0', 'EASYREC_EXCHANGE_CAP_FACTOR': '0'}


def config_text(name: str, directory: str, batch: int = 32) -> str:
  if name in BODIES:
    train, _ = t_dryrun.write_data(directory)
    return t_dryrun._BASE.format(train=train, batch=batch, sampler='',
                                 ev='', body=BODIES[name])
  return t_dryrun.case_config(name, directory, batch)


def rank_rows(batch, rank: int, world: int):
  """The rows of the global batch the JAX mesh puts on device `rank`: a
  contiguous block of every array, a sampler's 'neg.' view whole."""
  n = batch['sample_weight'].shape[0] // world
  return {k: (np.asarray(v) if k.startswith('neg.') else
              np.asarray(v)[rank * n:(rank + 1) * n])
          for k, v in batch.items()}


# ------------------------------------------------ the losses that pair rows

LOSS_ROWS = 8                 # rows a rank


def loss_inputs():
  """Seeded per-row inputs of the global batch (WORLD * LOSS_ROWS rows);
  a fifth of the rows weigh 0."""
  rng = np.random.default_rng(3)
  n = WORLD * LOSS_ROWS
  return {'labels': rng.integers(0, 2, n).astype(np.float32),
          'logits': (rng.standard_normal(n) * 2).astype(np.float32),
          'weights': (rng.random(n) > 0.2).astype(np.float32),
          'sessions': rng.integers(0, 3, n),
          'emb': rng.standard_normal((n, 4)).astype(np.float32),
          'emb2': rng.standard_normal((n, 4)).astype(np.float32),
          'logits2': rng.standard_normal((n, 2)).astype(np.float32)}


def _info_nce(x1, x2):
  from easyrec_torch.layers.blocks import AuxiliaryLoss
  sink = []
  AuxiliaryLoss(sink, 'aux', 'info_nce', temperature=0.5)([x1, x2])
  return sink[0][1]


# name -> (the loss of the inputs, the inputs it is differentiated by)
PAIRING = {
    'pairwise': (lambda L, d: L.pairwise_loss(
        d['labels'], d['logits'], d['weights'], session_ids=d['sessions']),
                 ('logits',)),
    'pairwise_logistic_ohem': (lambda L, d: L.pairwise_logistic_loss(
        d['labels'], d['logits'], d['weights'], ohem_ratio=0.5),
                               ('logits',)),
    'pairwise_focal': (lambda L, d: L.pairwise_focal_loss(
        d['labels'], d['logits'], d['weights'], alpha=0.7), ('logits',)),
    'pairwise_hinge': (lambda L, d: L.pairwise_hinge_loss(
        d['labels'], d['logits'], d['weights'], session_ids=d['sessions']),
                       ('logits',)),
    'focal_ohem': (lambda L, d: L.binary_focal_loss(
        d['labels'], d['logits'], d['weights'], ohem_ratio=0.5),
                   ('logits',)),
    'jrc': (lambda L, d: L.jrc_loss(d['labels'], d['logits2'],
                                    d['sessions'], d['weights']),
            ('logits2',)),
    'listwise': (lambda L, d: L.listwise_rank_loss(
        d['labels'], d['logits'], d['sessions'], d['weights']),
                 ('logits',)),
    'circle': (lambda L, d: L.circle_loss(d['emb'], d['sessions'],
                                          d['weights']), ('emb',)),
    'multi_similarity': (lambda L, d: L.multi_similarity_loss(
        d['emb'], d['sessions'], d['weights']), ('emb',)),
    'mined_softmax': (lambda L, d: L.softmax_loss_with_negative_mining(
        d['emb'], d['emb2'], d['labels'], d['weights']), ('emb', 'emb2')),
    'info_nce': (lambda L, d: _info_nce(d['emb'], d['emb2']),
                 ('emb', 'emb2')),
}


def pairing_losses(world=None):
  """Each PAIRING loss and its gradients by the inputs it names: in
  `world`, on this rank's rows inside the step's scope, the gradients
  divided by the world size as the trainer divides them; else on the
  global batch in one process."""
  from easyrec_torch.losses import losses as L
  rows = slice(None)
  if world is not None:
    rows = slice(world.rank * LOSS_ROWS, (world.rank + 1) * LOSS_ROWS)
  out = {}
  for name, (fn, by) in PAIRING.items():
    d = {k: torch.from_numpy(v[rows]) for k, v in loss_inputs().items()}
    for k in by:
      d[k].requires_grad_()
    with mesh.step_scope(world):
      loss = fn(L, d)
    loss.backward()
    scale = 1.0 if world is None else world.size
    out[name] = (float(loss.detach()),
                 {k: (d[k].grad / scale).numpy() for k in by})
  return out


# ------------------------------------------------------------- the world

def _floats(d):
  return {k: float(v) for k, v in d.items()}


def train_worker(world, cases, eval_case, sampler_case):
  """Every case on this rank: the losses of each step, the model's state,
  the whole tables, the eval of the last batches on this rank's rows,
  whether every rank holds equal replicated tables; then the real CSV
  pipeline's eval cases."""
  os.environ.update(ENV)
  out = {}
  for name, (text, strategy, state, batches, eval_batches) in cases.items():
    cfg = t_config.get_configs_from_pipeline_str(text)
    cfg.train_config.train_distribute = strategy
    trainer = TTrainer(cfg, world=world)
    trainer.init_state()
    trainer.load_state_dict(state)
    losses = [_floats(trainer.step_batch(rank_rows(b, world.rank, WORLD)))
              for b in batches]
    tables = {k: v.clone() for k, v in trainer.whole_tables().items()}
    metrics = trainer.evaluate(eval_iter=[
        rank_rows(b, world.rank, WORLD) for b in eval_batches])
    out[name] = {
        'losses': losses, 'tables': tables, 'eval': metrics,
        'model': {k: v.clone() for k, v in
                  trainer.model.state_dict().items()},
        'equal': mesh.all_equal(world, list(trainer.tables.values())),
        'local_rows': {k: int(v.shape[0]) for k, v in
                       trainer.tables.items()}}
  text = eval_case
  cfg = t_config.get_configs_from_pipeline_str(text)
  trainer = TTrainer(cfg, world=world)
  trainer.init_state()
  out['pipeline_eval'] = trainer.evaluate()
  text, state = sampler_case
  trainer = TTrainer(t_config.get_configs_from_pipeline_str(text),
                     world=world)
  trainer.init_state()
  trainer.load_state_dict(state)
  out['sampler_eval'] = trainer.evaluate()
  out['pairing'] = pairing_losses(world)
  return out


# ------------------------------------------------------------ the JAX side

def _jax_run(name, directory, monkeypatch):
  """(initial port state_dict, global train batches, eval batches, JAX
  losses, the JAX trainer and final state, the single-process port
  trainer after the same steps)."""
  import jax
  from easyrec_tpu.config import config_util as j_config
  from easyrec_tpu.train.trainer import Trainer as JTrainer
  from easyrec_tpu.utils.synthetic import synthetic_batch
  from easyrec_torch import convert
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  for k, v in ENV.items():
    monkeypatch.setenv(k, v)
  monkeypatch.delenv('EASYREC_EXCHANGE_CAP_FACTOR')
  text = config_text(name, directory)
  jt = JTrainer(j_config.get_configs_from_pipeline_str(text),
                devices=jax.devices('cpu')[:WORLD])
  assert jt.packed_mode and jt.mesh.devices.size == WORLD
  if name in BODIES:
    batches = [synthetic_batch(jt.specs, ['label'], 32, seed=s)
               for s in range(STEPS + 2)]
  else:
    it = iter(jt.train_input())
    batches = [next(it) for _ in range(STEPS + 2)]
  state = jt.init_state(batches[0])
  tt = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  tt.init_state()
  tt.model.load_state_dict(convert.flax_to_state_dict(
      state.params, state.batch_stats, root=tt.model.flax_root))
  for key, meta in jt.pack_metas.items():
    tt.tables[key].copy_(torch.from_numpy(convert.jax_packed_to_table(
        np.asarray(state.tables[key]), meta.dim, tt.metas[key].rows,
        meta.n_parts)))
  init = {'step': tt.step.clone(),
          'model': {k: v.clone() for k, v in tt.model.state_dict().items()},
          'tables': {k: v.clone() for k, v in tt.tables.items()},
          'ev': {}, 'dense_opt': copy.deepcopy(tt.dense_opt.state_dict())}
  j_losses = []
  for b in batches[:STEPS]:
    state, loss = jt.train_step(state, jt.rules.shard_batch(b))
    j_losses.append({k: float(v) for k, v in loss.items()})
    tt.train_step(to_device(b, torch.device('cpu')))
  return (text, init, batches[:STEPS], batches[STEPS:], j_losses, jt, state,
          tt)


@functools.lru_cache(maxsize=None)
def _results():
  """The JAX runs and the single-process port runs in this process, then
  the world once for every case."""
  mp = pytest.MonkeyPatch()
  root = tempfile.mkdtemp(prefix='parallel_train_')
  try:
    jax_side = {}
    cases = {}
    for name in CONFIGS:
      d = os.path.join(root, name)
      os.makedirs(d)
      run = _jax_run(name, d, mp)
      jax_side[name] = run
      text, init, batches, eval_batches = run[:4]
      for mode, strategy in STRATEGIES.items():
        cases['%s/%s' % (name, mode)] = (text, strategy, init, batches,
                                         eval_batches)
  finally:
    mp.undo()
  eval_text = _eval_config(os.path.join(root, 'eval'))
  sampler_case = _sampler_eval_case(os.path.join(root, 'sampler_eval'))
  world = launch.spawn('tests.test_torch_parallel_train:train_worker',
                       [cases, eval_text, sampler_case], WORLD,
                       timeout_s=240)
  cfg = t_config.get_configs_from_pipeline_str(eval_text)
  single = TTrainer(cfg, device='cpu')
  single.init_state()
  return jax_side, world, {'pipeline_eval': single.evaluate(),
                           'sampler_eval': _sampler_eval_one(*sampler_case)}


def _eval_config(directory):
  """A DeepFM with gauc over its own CSV eval file of 4 * 64 + 1 rows, so
  rank 0's shard holds one batch more than the others'."""
  from tests import fixtures
  os.makedirs(directory)
  path = fixtures.write_pipeline(directory, n_eval=4 * 64 + 1,
                                 batch_size=64, num_steps=1)
  with open(path) as f:
    text = f.read()
  return text.replace('eval_config { metrics_set { auc {} } }',
                      'eval_config { metrics_set { auc {} } '
                      'metrics_set { gauc { uid_field: "c1" } } }')


SAMPLER_BATCH = 32


def _sampler_eval_case(directory):
  """(config text, initial state) of the DSSM with a negative sampler,
  row-sharded (the default NoStrategy), whose eval file holds
  4 * SAMPLER_BATCH + 1 rows: rank 0 reads two batches, the others one
  and a filler. The last row, rank 0's second batch, has label 1, so its
  softmax over the sampled negatives counts in the loss; the tables are
  scaled by 10 and the dense parameters by 3, so that the negatives move
  it (by 3e-4 relative where step 2's draw changes; at the initial
  state, by 3e-8)."""
  os.makedirs(directory)
  text = t_dryrun.case_config('dssm_sampler', directory, SAMPLER_BATCH)
  train = os.path.join(directory, 'train.csv')
  path = os.path.join(directory, 'eval.csv')
  with open(train) as f:
    lines = f.readlines()
  n = WORLD * SAMPLER_BATCH
  with open(path, 'w') as f:
    f.writelines(lines[:n] + [next(x for x in lines[n:]
                                   if x.startswith('1,'))])
  text = text.replace('eval_input_path: "%s"' % train,
                      'eval_input_path: "%s"' % path).replace(
      'batch_size: %d' % SAMPLER_BATCH,
      'batch_size: %d eval_batch_size: %d' % (SAMPLER_BATCH, SAMPLER_BATCH))
  one = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  one.init_state()
  with torch.no_grad():
    for t in one.tables.values():
      t.mul_(10.0)
    for v in one.model.state_dict().values():
      if v.is_floating_point():
        v.mul_(3.0)
  return text, one.state_dict()


def _sampler_eval_one(text, state):
  """One process's eval of the world's global batches: at each step every
  rank's batch of its shard in rank order (a rank whose shard ran dry its
  last batch at weight 0) and rank 0's 'neg.' view."""
  from easyrec_torch.data.input_pipeline import InputPipeline
  one = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  one.init_state()
  one.load_state_dict(state)
  cfg = one.pipeline_config
  shards = [list(InputPipeline(
      one.data_config, one.feature_configs,
      t_config.get_eval_input_path(cfg), mode='eval',
      extra_fields=t_config.collect_extra_fields(cfg), shard_index=r,
      shard_num=WORLD)) for r in range(WORLD)]
  batches = []
  for i in range(max(len(b) for b in shards)):
    parts = []
    for b in shards:
      part = dict(b[min(i, len(b) - 1)])
      if i >= len(b):
        part['sample_weight'] = np.zeros_like(part['sample_weight'])
      parts.append(part)
    batches.append({k: (v if k.startswith('neg.') else np.concatenate(
        [p[k] for p in parts])) for k, v in parts[0].items()})
  assert len(batches) == 2 and [len(b) for b in shards] == [2, 1, 1, 1]
  return one.evaluate(eval_iter=batches)


# ------------------------------------------------------------------ tests

def _case(name, mode):
  jax_side, world, _ = _results()
  return jax_side[name], world


@pytest.mark.parametrize('mode', sorted(STRATEGIES))
@pytest.mark.parametrize('name', CONFIGS)
def test_losses_match_jax_mesh(name, mode):
  (_, _, _, _, j_losses, _, _, _), world = _case(name, mode)
  rtol = 5e-5 if name == 'dssm_sampler' else 2e-5
  for rank in world:
    got = rank['%s/%s' % (name, mode)]['losses']
    assert len(got) == STEPS
    for s, (t, j) in enumerate(zip(got, j_losses)):
      np.testing.assert_allclose(t['total_loss'], j['total_loss'],
                                 rtol=rtol, err_msg='step %d' % s)
      if mode == 'sharded':
        # the exchange's counters, summed over the ranks, as the JAX
        # step's psum; neither side drops a row
        assert t['exchange_update_overflow'] == 0.0
        assert t['exchange_ep_pull_overflow'] == 0.0
        assert j['exchange_update_overflow'] == 0.0
        assert j['exchange_ep_pull_overflow'] == 0.0
      else:
        assert not any(k.startswith('exchange_') for k in t)


# parameters whose gradient is rounding noise, held to 2 lr a step (ROADMAP's
# known divergences): the DSSM item tower's last Dense bias adds u.b to
# every column of a row, which the in-batch softmax removes
NOISE = {'dssm_sampler': ('item_dnn/dense_1/bias',)}


def _root(name):
  """The flax scope of a config's model parameters (BaseModel.flax_root)."""
  return 'inner' if name in BODIES else ''


def _bias_before_bn(path):
  keys = path.split('/')
  return keys[-1] == 'bias' and keys[-2].startswith('dense_')


@pytest.mark.parametrize('mode', sorted(STRATEGIES))
@pytest.mark.parametrize('name', CONFIGS)
def test_dense_parameters_match_jax_mesh(name, mode):
  import jax
  from easyrec_torch import convert
  (_, _, _, _, _, jt, state, _), world = _case(name, mode)
  got = world[0]['%s/%s' % (name, mode)]['model']
  params, stats = convert.state_dict_to_flax(got, root=_root(name))
  j_params = jax.device_get(state.params)
  bn = name == 'deepfm_bn'
  for path, leaf in jax.tree_util.tree_leaves_with_path(params):
    want = np.asarray(functools.reduce(lambda t, k: t[k.key], path,
                                       j_params))
    where = '/'.join(str(k.key) for k in path)
    if (bn and _bias_before_bn(where)) or where in NOISE.get(name, ()):
      assert np.abs(leaf - want).max() <= 2 * LR_SUM, where
    else:
      np.testing.assert_allclose(leaf, want, rtol=0,
                                 atol=1e-4 if bn else 2e-5, err_msg=where)
  j_stats = jax.device_get(state.batch_stats)
  for path, leaf in jax.tree_util.tree_leaves_with_path(stats):
    want = np.asarray(functools.reduce(lambda t, k: t[k.key], path,
                                       j_stats))
    # a running mean takes in its Dense bias, +-lr a step on each side
    atol = (1 - 0.99) * 2 * LR_SUM * STEPS if path[-1].key == 'mean' \
        else 1e-5
    np.testing.assert_allclose(leaf, want, rtol=2e-5, atol=atol)
  for rank in world[1:]:
    other = rank['%s/%s' % (name, mode)]['model']
    for k, v in got.items():
      assert torch.equal(v, other[k]), k     # every rank steps alike


@pytest.mark.parametrize('mode', sorted(STRATEGIES))
@pytest.mark.parametrize('name', CONFIGS)
def test_tables_match_jax_mesh_and_one_process(name, mode):
  from easyrec_torch.ops import packed_table as tpt
  from easyrec_tpu.ops import packed_table as jpt
  (_, _, _, _, _, jt, state, tt), world = _case(name, mode)
  res = world[0]['%s/%s' % (name, mode)]
  for key, meta in jt.pack_metas.items():
    tmeta = tt.metas[key]
    got = res['tables'][key].numpy()
    assert got.shape == (tmeta.rows, tmeta.width)
    tw, (tm, tv) = tpt.unpack_host(got, tmeta)
    jw, (jm, jv) = jpt.unpack_host(np.asarray(state.tables[key]), meta,
                                   tmeta.rows)
    ow, (om, ov) = tpt.unpack_host(tt.tables[key].numpy(), tmeta)
    # against the JAX mesh, then against the port on one process
    for want_w, want_m, want_v in ((jw, jm, jv), (ow, om, ov)):
      np.testing.assert_allclose(tw, want_w, rtol=0, atol=1e-4)
      for a, b in ((tm, want_m), (tv, want_v)):
        np.testing.assert_allclose(a, b, rtol=0.03, atol=2e-7)
  if mode == 'replicated':
    assert all(r['%s/%s' % (name, mode)]['equal'] for r in world)
    assert all(n == tt.metas[k].rows for k, n in res['local_rows'].items())
  else:
    # the JAX package's row split: every row on exactly one rank
    for key, meta in tt.metas.items():
      assert sum(r['%s/%s' % (name, mode)]['local_rows'][key]
                 for r in world) == meta.rows


@pytest.mark.parametrize('mode', sorted(STRATEGIES))
@pytest.mark.parametrize('name', CONFIGS)
def test_sharded_eval_matches_one_process(name, mode):
  """Each rank evaluates its rows of the eval batches; the metric states
  summed over the ranks equal those of one process evaluating the global
  batches from the world's trained state (the AUC within one row's bin,
  the loss within 1e-5), every rank reads the same metrics, and the
  row-sharded eval reports the exchange's overflow rate (0 here)."""
  (text, _, _, eval_batches, _, _, _, _), world = _case(name, mode)
  res = world[0]['%s/%s' % (name, mode)]
  one = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  one.init_state()
  one.model.load_state_dict(res['model'])
  for key, t in one.tables.items():
    t.copy_(res['tables'][key])
  want = one.evaluate(eval_iter=eval_batches)
  got = res['eval']
  for rank in world[1:]:
    assert rank['%s/%s' % (name, mode)]['eval'] == got
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-3,
                               err_msg=k)
  assert ('exchange_overflow_rate' in got) == (mode == 'sharded')
  if mode == 'sharded':
    assert got['exchange_overflow_rate'] == 0.0


@pytest.mark.parametrize('metric', ['auc', 'gauc', 'loss'])
def test_pipeline_eval_matches_one_process(metric):
  """The real CSV pipeline's eval, each rank its shard (rank 0 one batch
  more; the others feed zero-weight fillers), against one process reading
  the whole file: auc and gauc equal, every rank the same; the loss is a
  mean over differently cut batches, held within 1e-2."""
  _, world, single = _results()
  single = single['pipeline_eval']
  got = world[0]['pipeline_eval']
  for rank in world[1:]:
    assert rank['pipeline_eval'] == got
  if metric == 'loss':
    np.testing.assert_allclose(got['loss'], single['loss'], rtol=1e-2)
  else:
    np.testing.assert_allclose(got[metric], single[metric], rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize('metric', ['auc', 'loss', 'exchange_overflow_rate'])
def test_sampler_eval_uneven_shards_matches_one_process(metric):
  """The row-sharded DSSM's eval through its pipeline, rank 0 one batch
  more: every rank pulls rank 0's 'neg.' view (a filler rank's own is its
  last draw), so every rank reads one process's eval of the same global
  batches: the loss within 1e-5, the AUC within one row's bin; no row
  dropped."""
  _, world, single = _results()
  got = world[0]['sampler_eval']
  for rank in world[1:]:
    assert rank['sampler_eval'] == got
  if metric == 'exchange_overflow_rate':
    assert got[metric] == 0.0
    return
  np.testing.assert_allclose(got[metric], single['sampler_eval'][metric],
                             rtol=1e-5, atol=1e-3 if metric == 'auc' else 0)


@pytest.mark.parametrize('name', sorted(PAIRING))
def test_pairing_losses_pair_the_global_batch(name):
  """Every loss that pairs rows of the batch, on 4 ranks' rows, equals
  one process's on the global batch on every rank, and each rank's
  gradient (divided by the world size, as the trainer divides it) is one
  process's gradient of its rows; 1e-6 (f32 sums in another order)."""
  _, world, _ = _results()
  want_loss, want_grads = pairing_losses()[name]
  for r, rank in enumerate(world):
    loss, grads = rank['pairing'][name]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for k, g in grads.items():
      np.testing.assert_allclose(
          g, want_grads[k][r * LOSS_ROWS:(r + 1) * LOSS_ROWS], rtol=1e-5,
          atol=1e-6, err_msg='%s, rank %d' % (k, r))


# ---------------------------------------------------------- the guardrail

GUARD = '''
model_dir: ""
train_config {
  log_step_count_steps: 1
  optimizer_config {
    adam_optimizer {
      learning_rate { constant_learning_rate { learning_rate: 0.01 } }
    }
  }
  num_steps: 12
  overflow_abort_rate: 0.01
  overflow_abort_windows: 2
}
data_config {
  batch_size: 16
  label_fields: "label"
  input_fields { input_name: "label" input_type: FLOAT }
  input_fields { input_name: "c1" input_type: STRING }
  input_type: DummyInput
}
feature_config {
  features { input_names: "c1" feature_type: IdFeature
             embedding_dim: 8 hash_bucket_size: 64 }
}
model_config {
  model_class: "DeepFM"
  feature_groups { group_name: "deep" feature_names: "c1"
                   wide_deep: DEEP }
  feature_groups { group_name: "wide" feature_names: "c1"
                   wide_deep: WIDE }
  deepfm { dnn { hidden_units: [8] use_bn: false }
           final_dnn { hidden_units: [4] use_bn: false } }
}
'''


def _leaky_trainer(rate: float, every: int = 1):
  """A trainer whose steps report 1e6 dropped rows on every `every`-th
  call (tests/test_guardrails.py's leaky train_step)."""
  cfg = t_config.get_configs_from_pipeline_str(GUARD)
  cfg.train_config.overflow_abort_rate = rate
  trainer = TTrainer(cfg, device='cpu')
  real, calls = trainer.train_step, [0]

  def leaky(batch):
    out = dict(real(batch))
    calls[0] += 1
    if every == 1 or calls[0] % every:
      out['exchange_pull_overflow'] = torch.tensor(1e6)
    return out

  trainer.train_step = leaky
  return trainer


@pytest.mark.parametrize('case', ['abort', 'disabled', 'transient'])
def test_exchange_overflow_guardrail(case):
  """Sustained overflow above overflow_abort_rate for
  overflow_abort_windows logging windows raises, naming
  EASYREC_EXCHANGE_CAP_FACTOR; a rate of 0 accepts the drops; a window
  over the rate that the next clean one resets does not abort."""
  if case == 'abort':
    with pytest.raises(RuntimeError, match='EASYREC_EXCHANGE_CAP_FACTOR'):
      _leaky_trainer(0.01).fit(checkpoint=False, eval_at_end=False)
    return
  trainer = _leaky_trainer(0.0 if case == 'disabled' else 0.01,
                           every=1 if case == 'disabled' else 2)
  result = trainer.fit(checkpoint=False, eval_at_end=False)
  assert result['global_step'] == 12


def test_sampler_table_size_guard(tmp_path, monkeypatch):
  from easyrec_torch.data import samplers
  path = os.path.join(str(tmp_path), 'items.txt')
  with open(path, 'w') as f:
    f.write('id:int64\tweight:float\tattrs:string\n')
    for i in range(200):
      f.write('%d\t1.0\ti%d:c%d\n' % (i, i, i % 7))
  monkeypatch.setenv('EASYREC_SAMPLER_MAX_GB', '0.000001')
  with pytest.raises(MemoryError, match='EASYREC_SAMPLER_MAX_GB'):
    samplers._load_table(path, 3)
  monkeypatch.delenv('EASYREC_SAMPLER_MAX_GB')
  assert len(samplers._load_table(path, 3)) == 200


# ----------------------------------------------------- the config and mesh

@pytest.mark.parametrize('text', [
    'train_config { train_distribute: EmbeddingParallelStrategy '
    'mesh_data_parallel: 2 mesh_model_parallel: 2 '
    'overflow_abort_rate: 0.2 overflow_abort_windows: 5 }',
    'train_config { train_distribute: MirroredStrategy }',
    'train_config { num_steps: 3 }'])
def test_distribution_fields_read_as_jax(text):
  from easyrec_tpu.config import config_util as j_config
  from tests.test_torch_config import _assert_same
  _assert_same(t_config.get_configs_from_pipeline_str(text),
               j_config.get_configs_from_pipeline_str(text), 'config')


@pytest.mark.parametrize('strategy,shards', [
    ('EmbeddingParallelStrategy', True), ('SokStrategy', True),
    ('NoStrategy', True), ('PSStrategy', True), ('MirroredStrategy', False),
    ('CollectiveAllReduceStrategy', False), ('HorovodStrategy', False)])
def test_make_rules_shards_as_jax(strategy, shards):
  cfg = t_config.get_configs_from_pipeline_str(
      'train_config { train_distribute: %s }' % strategy)
  world = mesh.World(rank=0, size=4, device=torch.device('cpu'))
  rules = mesh.make_rules(cfg.train_config, world)
  assert rules.shard_embeddings == shards and rules.mesh == (4, 1)


def test_build_mesh_checks_the_world():
  assert mesh.build_mesh(0, 1, 4) == (4, 1)
  assert mesh.build_mesh(2, 2, 4) == (2, 2)
  with pytest.raises(ValueError, match='does not cover 4 devices'):
    mesh.build_mesh(3, 1, 4)


@pytest.mark.parametrize('rows,dim,parts,world', [
    (4002, 8, 2, 4), (4002, 8, 3, 3), (1001, 1, 3, 4), (26000014, 32, 2, 1),
    (620001, 16, 2, 3)])
def test_row_split_is_the_jax_packed_geometry(rows, dim, parts, world):
  """Rank r owns rows [r * local_rows, (r + 1) * local_rows): the JAX
  package's PackMeta.local_view() over the padded row count."""
  from easyrec_tpu.ops.packed_table import PackMeta
  sp = mesh.row_split(rows, dim, parts, world)
  pad = max(8 * world, 8)
  meta = PackMeta(-(-rows // pad) * pad, dim, 3 if parts == 2 else parts,
                  shards=world, compact=parts == 2)
  local = meta.local_view()
  assert sp.local_rows == local.groups * meta.group_rows
  assert sp.padded_rows == meta.rows
  assert sum(sp.count(r) for r in range(world)) == rows
  assert sp.live_owners == -(-meta.rows // sp.local_rows)
