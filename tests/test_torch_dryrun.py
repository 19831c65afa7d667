"""The port's multi-process dry-run matrix (easyrec_torch/utils/dryrun.py)
and its sharded KnnIndex (retrieval/knn.py) on the CPU, in gloo worlds of
4 and of 3 processes (3: a row split that is not a power of two), each
spawned once for the file.

Each of the four cases (packed tables with EV admission, the DIN sequence
group, MMoE, the sampler's splice into the in-batch softmax) starts from
the JAX package's initial state and trains one step on the rows of the
JAX case's first batch (easyrec_tpu/utils/dryrun.py's config and CSV
pipeline, 24 rows) that the JAX mesh gives each device; its loss is held
to the JAX case's on 4 virtual devices within 2e-5 relative. A step's loss
is that of the global batch, whatever the number of devices: the JAX
matrix itself reads the same loss at 4 and at 3 devices for one batch,
and so the port's worlds of 4 and 3 are both held to it. Each case then
trains a step on the port's own CSV pipeline (each rank its shard) and
evaluates, finite.

The sharded KnnIndex (a block of the corpus a rank, local top-k, the
candidates gathered and merged) must return the exact single-process
index's rows and scores, ties in its order (lowest row first)."""

import os
import tempfile

import numpy as np
import pytest
import torch

from easyrec_torch.parallel import launch
from easyrec_torch.retrieval.knn import KnnIndex
from easyrec_torch.utils import dryrun

GLOBAL_BATCH = 24
CASES = tuple(dryrun.matrix_cases())


def rank_rows(batch, rank, world):
  n = batch['sample_weight'].shape[0] // world
  return {k: (np.asarray(v) if k.startswith('neg.') else
              np.asarray(v)[rank * n:(rank + 1) * n])
          for k, v in batch.items()}


def corpora():
  """name -> (item embeddings, queries, k): random floats, and small
  integers whose scores tie."""
  rng = np.random.default_rng(0)
  return {
      'random': (rng.standard_normal((1003, 16)).astype(np.float32),
                 rng.standard_normal((64, 16)).astype(np.float32), 10),
      'ties': (rng.integers(-1, 2, (257, 4)).astype(np.float32),
               rng.integers(-1, 2, (32, 4)).astype(np.float32), 20),
      'k_past_a_block': (rng.standard_normal((10, 8)).astype(np.float32),
                         rng.standard_normal((5, 8)).astype(np.float32), 9),
  }


def dryrun_worker(world, payload):
  out = {}
  for name, (state, batch) in payload.items():
    env = dryrun.matrix_cases()[name][3]
    os.environ.update(env)
    out[name] = dryrun.run_case(
        world, name, GLOBAL_BATCH // world.size, state=state,
        rows=rank_rows(batch, world.rank, world.size))
    for k in env:
      os.environ.pop(k)
  for name, (emb, q, k) in corpora().items():
    for metric in ('ip', 'l2'):
      index = KnnIndex(emb, metric=metric, world=world)
      out['knn/%s/%s' % (name, metric)] = index.search(q, k)
  return out


def _jax_case(name, monkeypatch):
  """(the port's initial state_dict from the JAX case's, its first batch,
  the JAX loss on 4 virtual devices)."""
  import jax
  from easyrec_torch import convert
  from easyrec_torch.config import config_util as t_config
  from easyrec_torch.train.trainer import Trainer as TTrainer
  from easyrec_tpu.config import config_util as j_config
  from easyrec_tpu.train.trainer import Trainer as JTrainer
  from easyrec_tpu.utils import dryrun as j_dryrun
  body, ev, sampler_flag, env = j_dryrun.matrix_cases()[name]
  for k, v in env.items():
    monkeypatch.setenv(k, v)
  d = tempfile.mkdtemp(prefix='dryrun_jax_%s_' % name)
  train, items = j_dryrun._write_data(d)
  text = j_dryrun._BASE.format(
      train=train, batch=GLOBAL_BATCH, ev=ev, body=body,
      sampler=j_dryrun._SAMPLER.format(items=items) if sampler_flag else '')
  jt = JTrainer(j_config.get_configs_from_pipeline_str(text),
                devices=jax.devices()[:4])
  batch = next(iter(jt.train_input()))
  state = jt.init_state(batch)
  tt = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  tt.init_state()
  tt.model.load_state_dict(convert.flax_to_state_dict(
      state.params, state.batch_stats, root=tt.model.flax_root))
  for key, table in tt.tables.items():
    j = np.asarray(state.tables[key])
    if jt.packed_mode:
      meta = jt.pack_metas[key]
      j = convert.jax_packed_to_table(j, meta.dim, table.shape[0],
                                      meta.n_parts)
      table.copy_(torch.from_numpy(j))
    else:
      # the plain layout's weights (its slots start at 0, as the port's)
      table[:, :j.shape[1]] = torch.from_numpy(j[:table.shape[0]])
  init = tt.state_dict()
  # the step donates the state: read the loss after the copy above
  _, loss = jt.train_step(state, jt.rules.shard_batch(batch))
  for k in env:
    monkeypatch.delenv(k)
  return init, batch, float(loss['total_loss'])


_CACHE = {}


def _results():
  if not _CACHE:
    mp = pytest.MonkeyPatch()
    try:
      jax_side = {name: _jax_case(name, mp) for name in CASES}
    finally:
      mp.undo()
    payload = {name: (init, batch)
               for name, (init, batch, _) in jax_side.items()}
    _CACHE['jax'] = jax_side
    for world in (4, 3):
      _CACHE[world] = launch.spawn('tests.test_torch_dryrun:dryrun_worker',
                                   [payload], world, timeout_s=240)
  return _CACHE


@pytest.mark.parametrize('world', [4, 3])
@pytest.mark.parametrize('name', CASES)
def test_dryrun_case_matches_jax(name, world):
  res = _results()
  want = res['jax'][name][2]
  for rank in res[world]:
    got = rank[name]
    np.testing.assert_allclose(got['losses']['total_loss'], want,
                               rtol=2e-5)
    # the port's own CSV pipeline, each rank its shard: one more step
    assert np.isfinite(got['pipeline_losses']['total_loss'])
    assert np.isfinite(got['eval']['loss'])
    assert got['losses']['exchange_update_overflow'] == 0.0
    assert got['ev'] == (name == 'packed_ev')
    assert got['eval'] == res[world][0][name]['eval']


@pytest.mark.parametrize('world', [4, 3])
@pytest.mark.parametrize('metric', ['ip', 'l2'])
@pytest.mark.parametrize('corpus', sorted(corpora()))
def test_sharded_knn_matches_one_process(corpus, metric, world):
  emb, q, k = corpora()[corpus]
  want_s, want_i = KnnIndex(emb, metric=metric, device='cpu').search(q, k)
  for rank in _results()[world]:
    got_s, got_i = rank['knn/%s/%s' % (corpus, metric)]
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)

