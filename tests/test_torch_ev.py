"""EVParams admission and eviction in the port (easyrec_torch/features/ev.py,
the trainer's EV step and sweep, the block maths ev_add / ev_set of K2 and
K3's plain versions) against the JAX package, on samples/
deepfm_ev_params.config narrowed to CPU size: hash buckets 1000 / 1000 /
100 (published 100000 / 100000 / 10000), batch 64 (1024), steps_to_live 3
(4000), so that admission, masking and the sweep all act within six steps.
Widths, filter_freq and the model are the sample's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyrec_torch import main as t_main
from easyrec_torch.config import config_util as t_config
from easyrec_torch.features import ev as tev
from easyrec_torch.ops import embedding as t_emb
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.optim import sparse as t_sparse
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.features import ev as jev
from easyrec_tpu.ops import embedding as j_emb
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.train.trainer import Trainer as JTrainer
from easyrec_tpu.utils.synthetic import synthetic_batch
from tests import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 64
STEPS = 6
LR = 0.001                # the sample's constant learning rate
BF16_ULP = 2.0 ** -7


def _config_text():
  with open(os.path.join(REPO, 'samples', 'deepfm_ev_params.config')) as f:
    text = f.read()
  for old, new in (('hash_bucket_size: 100000', 'hash_bucket_size: 1000'),
                   ('hash_bucket_size: 10000', 'hash_bucket_size: 100'),
                   ('batch_size: 1024', 'batch_size: %d' % BS),
                   ('steps_to_live: 4000', 'steps_to_live: 3'),
                   ('hidden_units: [64, 32] }',
                    'hidden_units: [64, 32] use_bn: false }'),
                   ('hidden_units: [32] }', 'hidden_units: [32] use_bn: false }')):
    assert old in text, old
    text = text.replace(old, new)
  return text


def _batches(specs):
  """STEPS seeded batches; uid and iid ids move to a new range halfway, so
  the first half's rows go stale."""
  rng = np.random.default_rng(11)
  out = []
  for s in range(STEPS):
    b = synthetic_batch(specs, ['label'], BS, seed=s)
    lo = 0 if s < STEPS // 2 else 40
    b['feat.uid.ids'] = rng.integers(lo, lo + 40, (BS, 1)).astype(np.int32)
    b['feat.iid.ids'] = rng.integers(lo, lo + 30, (BS, 1)).astype(np.int32)
    out.append(b)
  return out


def test_build_ev_plan_matches_jax():
  text = _config_text()
  jt = JTrainer(j_config.get_configs_from_pipeline_str(text),
                devices=jax.devices('cpu')[:1])
  tt = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  assert set(tt.ev_plan) == set(jt.ev_plan)
  for key, jp in jt.ev_plan.items():
    tp = tt.ev_plan[key]
    np.testing.assert_array_equal(tp.thr_cols, jp.thr_cols)
    np.testing.assert_array_equal(tp.ttl_cols, jp.ttl_cols)
    assert tp.ttl == jp.ttl == 3
    assert tp.row_segments == jp.row_segments
  # members that filter start at zero, the others do not
  tt.init_state()
  for key, ev in tt.ev_plan.items():
    w = tt.tables[key][:, :tt.metas[key].dim]
    for start, end, ff, _ in ev.row_segments:
      assert bool((w[start:end] == 0).all()) == (ff > 0), (start, end)
    assert set(tt.ev_state[key]) == {'ev_count', 'ev_last'}
    assert tt.ev_state[key]['ev_count'].shape == (tt.metas[key].rows, 1)


def _jax_aux(state, jt, key, name, rows):
  a = np.asarray(state.slots[key][name])
  return a.reshape(-1)[:rows] if jt.packed_mode else a[:rows, 0]


def _jax_keep(jt, state, batch, key):
  packs = j_emb.pack_all_views(jt.layout, batch)
  ones = {key: jnp.ones(packs[key].shape + (1,), jnp.float32)}
  out = jev.mask_pulled(ones, packs, state.slots, jt.ev_plan,
                        jt.ev_pack_metas, state.step)
  return np.asarray(out[key])[..., 0] > 0


def _carry(jt, state, tt):
  """The JAX trainer's initial state into the port's trainer."""
  from easyrec_torch import convert
  tt.init_state()
  tt.model.load_state_dict(convert.flax_to_state_dict(state.params,
                                                      state.batch_stats))
  for key, tmeta in tt.metas.items():
    arr = np.asarray(state.tables[key])
    if jt.packed_mode:
      meta = jt.pack_metas[key]
      table = convert.jax_packed_to_table(arr, meta.dim, tmeta.rows,
                                          meta.n_parts)
    else:         # plain: weights here, Adam's slots zero on both sides
      table = np.zeros((tmeta.rows, tmeta.width), np.float32)
      table[:, :tmeta.dim] = arr[:tmeta.rows]
    tt.tables[key].copy_(torch.from_numpy(table))


def _table_parts(jt, state, tt, key):
  """(JAX w, m, v; port w, m, v) of the logical rows."""
  tmeta = tt.metas[key]
  rows = tmeta.rows
  if jt.packed_mode:
    jw, js = jpt.unpack_host(np.asarray(state.tables[key]),
                             jt.pack_metas[key], rows)
  else:
    jw = np.asarray(state.tables[key])[:rows]
    js = [np.asarray(state.slots[key][n])[:rows] for n in ('m', 'v')]
  tw, ts = tpt.unpack_host(tt.tables[key].numpy(), tmeta)
  return [jw] + list(js), [tw] + list(ts)


@pytest.mark.parametrize('jax_path,gg,fused', [
    ('plain', '0', '0'), ('packed', '1', '0'), ('packed', '0', '1')])
def test_steps_match_jax_trainer(jax_path, gg, fused, monkeypatch):
  """Six steps of the narrowed sample through both trainers from the same
  initial state and batches: before every step the admission/TTL mask of
  every id slot, after it ev_count and ev_last, and after the last the
  rows the sweep resets, all exactly; the tables within the slice
  tolerances. Paths: the JAX package's plain layout (f32 id counts by
  dedup_sum, separate f32 Adam slots) against the port's 3-part Adam
  (EASYREC_PACKED_COMPACT=0) with f32 sums; its packed compact layout
  (EASYREC_PACKED_TABLES=1) in EASYREC_GG_BF16 mode 1 against K1 + K2 in
  mode 1; and in mode 0 against K3 (EASYREC_PACKED_FUSED=1, f32 sums).
  No id occurs more than 64 times a batch, so the count sums are exact in
  every mode (test_count_precision_above_256 pins the rest).

  Tolerances, with their reasons. BatchNorm is off in this narrowed copy:
  the Dense biases before it take +-lr Adam steps of unrelated sign on the
  two sides (ROADMAP's known divergences), which would swamp what is
  compared here. With f32 sums, losses within 2e-5 relative, weights
  within 1e-6 and moments within one bf16 ulp or 1e-9 (f32 sums in
  another order). In mode 1 JAX rounds a running bf16 sum of each row's
  gradients and the port one f32 sum once; the raw feature's single row
  takes 64 slots a step and every example's forward reads it, so losses
  part by up to 1e-3 relative and Adam turns each near-zero summed
  gradient into a step of about lr of either sign: weights within 2 lr a
  step, moments within 1e-4 (measured 3.0e-3 and 6.2e-5)."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES',
                     '1' if jax_path == 'packed' else '0')
  monkeypatch.setenv('EASYREC_PACKED_COMPACT',
                     '1' if jax_path == 'packed' else '0')
  monkeypatch.setenv('EASYREC_GG_BF16', gg)
  monkeypatch.setenv('EASYREC_PACKED_FUSED', fused)
  text = _config_text()
  jt = JTrainer(j_config.get_configs_from_pipeline_str(text),
                devices=jax.devices('cpu')[:1])
  assert jt.packed_mode == (jax_path == 'packed')
  tt = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  batches = _batches(jt.specs)
  state = jt.init_state(batches[0])
  _carry(jt, state, tt)
  cpu = torch.device('cpu')
  (key, ev), = tt.ev_plan.items()
  rows = tt.metas[key].rows
  masked = 0
  for b in batches:
    tb = to_device(b, cpu)
    packs = t_emb.pack_ids(tt.layout, tb)
    t_keep = tev.keep_mask(packs[key], tt.ev_state[key], ev, tt.step)
    j_keep = _jax_keep(jt, state, b, key)
    np.testing.assert_array_equal(t_keep.numpy(), j_keep)
    masked += int((~j_keep).sum())
    state, j_loss = jt.train_step(state, jt.rules.shard_batch(b))
    t_loss = tt.train_step(tb)
    np.testing.assert_allclose(float(t_loss['total_loss']),
                               float(j_loss['total_loss']),
                               rtol=1e-3 if gg == '1' else 2e-5)
    for name in ('ev_count', 'ev_last'):
      np.testing.assert_array_equal(
          tt.ev_state[key][name][:, 0].numpy(),
          _jax_aux(state, jt, key, name, rows), err_msg=name)
  assert masked > 0
  assert int(tt.step) == int(state.step) == STEPS

  j_parts, t_parts = _table_parts(jt, state, tt, key)
  w_atol, s_atol = (2 * LR * STEPS, 1e-4) if gg == '1' else (1e-6, 1e-9)
  for i, (got, want) in enumerate(zip(t_parts, j_parts)):
    np.testing.assert_allclose(got, want, rtol=0 if i == 0 else BF16_ULP,
                               atol=w_atol if i == 0 else s_atol)

  stale = tev.stale_rows(tt.ev_state[key], ev, tt.step).numpy()
  live_before = (t_parts[0] != 0).any(axis=1)
  state = jev.evict_stale(state, jt.ev_plan, jt.pack_metas,
                          jt.ev_pack_metas, jt.layout)
  seen = stale & (tt.ev_state[key]['ev_last'][:, 0].numpy() > 0)
  swept = tev.evict_stale(tt.tables, tt.ev_state, tt.ev_plan, tt.step)
  assert swept == {key: (int(stale.sum()), int(seen.sum()))}
  assert (stale & live_before).sum() > 0      # trained rows were swept
  j_parts, t_parts = _table_parts(jt, state, tt, key)
  j_zero = np.all([(p == 0).all(axis=1) for p in j_parts], axis=0)
  t_zero = np.all([(p == 0).all(axis=1) for p in t_parts], axis=0)
  np.testing.assert_array_equal(t_zero, j_zero)
  assert t_zero[stale].all()
  for name in ('ev_count', 'ev_last'):
    np.testing.assert_array_equal(
        tt.ev_state[key][name][:, 0].numpy(),
        _jax_aux(state, jt, key, name, rows), err_msg=name)


def _aux_update(jax_path, ids, rows, step):
  """ev_count and ev_last after one update_ev_state of the JAX package on
  `ids`, starting from zero, on its plain or packed (use_pallas=False, the
  XLA path _rmw_xla) layout."""
  plan = {'t': jev.TableEv(thr_cols=np.array([2], np.int32), ttl=5,
                           ttl_cols=np.array([5], np.int32),
                           row_segments=((0, rows, 2, 5),))}
  if jax_path == 'packed':
    metas = {'t': jpt.PackMeta(rows, 1, 1)}
    shape = (metas['t'].phys_rows, metas['t'].width)
  else:
    metas, shape = None, (rows, 1)
  slots = {'t': {n: jnp.zeros(shape, jnp.float32)
                 for n in ('ev_count', 'ev_last')}}
  out = jev.update_ev_state(slots, {'t': jnp.asarray(ids[:, None])}, plan,
                            metas, jnp.int32(step), use_pallas=False,
                            scratch_rows={'t': rows - 1})
  return {n: np.asarray(out['t'][n]).reshape(-1)[:rows]
          for n in ('ev_count', 'ev_last')}


def _port_update(ids, rows, step):
  plan = {'t': tev.TableEv(thr_cols=np.array([2], np.int32), ttl=5,
                           ttl_cols=np.array([5], np.int32),
                           row_segments=((0, rows, 2, 5),))}
  state = {'t': {n: torch.zeros((rows, 1)) for n in ('ev_count',
                                                      'ev_last')}}
  tev.update_ev_state(state, {'t': torch.from_numpy(ids[:, None])}, plan,
                      torch.tensor(step, dtype=torch.int32))
  return {n: t[:, 0].numpy() for n, t in state['t'].items()}


@pytest.mark.parametrize('gg,fused', [('0', '0'), ('1', '0'), ('mix', '0'),
                                      ('1', '1')])
def test_ev_maths_match_jax_xla_path(gg, fused, monkeypatch):
  """EvAdd and EvSet through K1 + K2's plain versions (or K3's under
  EASYREC_PACKED_FUSED=1) against the JAX package's add_math and set_math
  through apply_packed_update's XLA path (_rmw_xla) and its plain-layout
  scatter, from zero on 300 slots of 50 ids, ids outside the table
  included on neither side: bit for bit, counts up to 256 an id."""
  monkeypatch.setenv('EASYREC_GG_BF16', gg)
  monkeypatch.setenv('EASYREC_PACKED_FUSED', fused)
  rows, step = 64, 37
  ids = np.random.default_rng(3).integers(0, 50, 300).astype(np.int64)
  got = _port_update(ids, rows, step)
  want_count = np.bincount(ids, minlength=rows).astype(np.float32)
  for jax_path in ('plain', 'packed'):
    want = _aux_update(jax_path, ids, rows, step)
    np.testing.assert_array_equal(got['ev_count'].view(np.uint32),
                                  want['ev_count'].view(np.uint32))
    np.testing.assert_array_equal(got['ev_last'].view(np.uint32),
                                  want['ev_last'].view(np.uint32))
  np.testing.assert_array_equal(got['ev_count'], want_count)
  np.testing.assert_array_equal(got['ev_last'],
                                np.where(want_count > 0, step, 0))
  # the block maths alone, on rows outside the table too
  table = torch.arange(8, dtype=torch.float32)[:, None] * 3.0
  uids = torch.tensor([1, 4, 8, 20, -1, 6], dtype=torch.int64)
  g = torch.tensor([[2.0], [1.0], [5.0], [1.0], [1.0], [0.0]])
  hyp = torch.tensor([step], dtype=torch.float32)
  add = tpt.rmw_rows_plain(table.clone(), uids, g, hyp, tev.EV_ADD)
  put = tpt.rmw_rows_plain(table.clone(), uids, g, hyp, tev.EV_SET)
  np.testing.assert_array_equal(add[:, 0].numpy(),
                                [0, 5, 6, 9, 13, 15, 18, 21])
  np.testing.assert_array_equal(put[:, 0].numpy(),
                                [0, 37, 6, 9, 37, 15, 18, 21])
  assert tev.EV_ADD.kernel_math() == (t_sparse.MATH_EV_ADD, [])
  assert tev.EV_SET.kernel_math() == (t_sparse.MATH_EV_SET, [])


@pytest.mark.parametrize('gg,fused,port_count', [
    ('0', '0', 301.0), ('mix', '0', 301.0), ('1', '0', 300.0),
    ('1', '1', 301.0)])
def test_count_precision_above_256(gg, fused, port_count, monkeypatch):
  """One id 301 times in a batch (as the padding id 0 of a sequence
  collects thousands). The JAX package's plain layout counts 301; its
  packed layout sums the ones through _gg_cast: in EASYREC_GG_BF16 mode 1
  XLA's running bf16 sum stops at 256 (256 + 1 rounds back to 256), in
  modes 0 and mix it is exact. The port sums in f32 and, in mode 1 under
  K1 + K2, rounds the sum to bf16 once: 301 -> 300 (ties to even); K3
  sums in f32 in every mode: 301. Up to 256 occurrences every path agrees
  (test_ev_maths_match_jax_xla_path); ROADMAP's known divergences record
  this gap."""
  monkeypatch.setenv('EASYREC_GG_BF16', gg)
  monkeypatch.setenv('EASYREC_PACKED_FUSED', fused)
  rows = 16
  ids = np.concatenate([np.full(301, 3), np.arange(4, rows)]).astype(
      np.int64)
  got = _port_update(ids, rows, 9)
  assert got['ev_count'][3] == port_count
  np.testing.assert_array_equal(got['ev_count'][4:], 1.0)
  np.testing.assert_array_equal(got['ev_last'][3:], 9.0)
  assert _aux_update('plain', ids, rows, 9)['ev_count'][3] == 301.0
  assert _aux_update('packed', ids, rows, 9)['ev_count'][3] == \
      (256.0 if gg == '1' else 301.0)


def _ev_pipeline(tmp, num_steps):
  """The CLI fixture with ev_params on every id feature: filter_freq 2,
  steps_to_live 5, a save (and sweep) every 3 steps, shuffle off."""
  path = fixtures.write_pipeline(str(tmp), num_steps=num_steps)
  with open(path) as f:
    text = f.read()
  text = text.replace(
      'hash_bucket_size: 200 }',
      'hash_bucket_size: 200 ev_params { filter_freq: 2 steps_to_live: 5 } }')
  text = text.replace('save_checkpoints_steps: 500',
                      'save_checkpoints_steps: 3')
  text = text.replace('num_epochs: 0', 'num_epochs: 0 shuffle: false')
  with open(path, 'w') as f:
    f.write(text)
  return path


def test_resume_after_a_sweep_equals_the_uninterrupted_run(tmp_path):
  """Twelve steps through train_and_evaluate in one call, and six then
  twelve in two calls on another model_dir: the sweeps at steps 3, 6, 9
  and 12 fall in both, and the second call resumes from step 6's
  checkpoint. Shuffle is off: the resume drops raw rows before the
  shuffle, which permutes the chunks after it with other seeds than an
  uninterrupted run does. Step, tables, EV counters, model and dense
  optimizer equal bit for bit on the CPU."""
  path = _ev_pipeline(tmp_path, 12)
  one = t_main.train_and_evaluate(
      path, {'model_dir': str(tmp_path / 'one')}, device='cpu')
  t_main.train_and_evaluate(
      path, {'model_dir': str(tmp_path / 'two'),
             'train_config.num_steps': 6}, device='cpu')
  two = t_main.train_and_evaluate(
      path, {'model_dir': str(tmp_path / 'two')}, device='cpu')
  assert one['global_step'] == two['global_step'] == 12
  assert len(two['losses']) == 6
  assert sorted(os.listdir(tmp_path / 'two' / 'checkpoints')) == \
      ['12', '3', '6', '9']
  a, b = one['trainer'], two['trainer']
  for key, aux in a.ev_state.items():
    assert float(aux['ev_count'].sum()) > 0
    for name, t in aux.items():
      assert torch.equal(t, b.ev_state[key][name]), name
  for key in a.tables:
    assert torch.equal(a.tables[key], b.tables[key])
  for k, v in a.model.state_dict().items():
    assert torch.equal(v, b.model.state_dict()[k]), k
  for slot in a.dense_opt.slot_names:
    for x, y in zip(getattr(a.dense_opt, slot), getattr(b.dense_opt, slot)):
      assert torch.equal(x, y)
  assert one['losses'][6:] == two['losses']
