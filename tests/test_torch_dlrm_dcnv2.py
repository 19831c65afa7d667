"""MLPerf's DLRM-DCNv2 (recbench/configs/dlrm_dcnv2.json), the benchmark's
cell `dlrm_dcnv2.multihot_b16384`, on the CPU at recbench/tests/small.py's
size (batch 64, tables of at most 1,000 rows; every width as published):
the port's RankModel against the plain reference
recbench/reference/dlrm_dcnv2.py on the same seeded weights, the cell
through the benchmark's own command, the port's spans of the Cross and the
bags' pooling, the cell's per-layer readers on a canned trace, and the
calibration of its limits (recbench/calibrate_backbone.py)."""

import functools
import json
import os
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from easyrec_torch.ops import embedding as emb_ops
from easyrec_torch.parallel import mesh
from easyrec_torch.train.trainer import Trainer, view_stream
from easyrec_torch.utils import spans
from recbench import (calibrate_backbone, check, faults, harness, peaks, run,
                      trace, traffic, weights)
from recbench.cell import load_cell, table_features
from recbench.reference import common
from recbench.tests.small import SMALL, run_line
from tests.test_torch_spans import _events, _inside, _program_spans

CELL = 'dlrm_dcnv2.multihot_b16384'
SEED = 2 ** 31 + 4099
BAGS = 26


@pytest.fixture
def clean_env():
  """The benchmark's set-up writes the configuration's environment and
  turns TF32 off; both are put back for the tests that follow."""
  env = dict(os.environ)
  tf32 = (torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)
  yield
  os.environ.clear()
  os.environ.update(env)
  torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
      tf32


def _small_cell():
  return load_cell(CELL, shrink=SMALL)


def _trainer(cell):
  trainer = Trainer(cell.pipeline_config(), device='cpu')
  trainer.init_state()
  return trainer


def _port_gradients(trainer, features, batch):
  """(loss, dense gradients by name, each bag's table rows' gradient) of
  the forward and backward of the port's train step."""
  packs = emb_ops.pack_all_views(trainer.layout, batch)
  pulled = {k: v.requires_grad_() for k, v in trainer.pull(packs).items()}
  used = emb_ops.StepPulls(pulled, trainer.layout)
  trainer.model.train()
  with mesh.step_scope(trainer.world):
    outputs = trainer.model(batch, used)
    total, _ = trainer._regularised_loss(outputs, batch, used)
  total.backward()
  dense = {n: p.grad for n, p in trainer.model.named_parameters()}
  sums = {}
  for key, meta in trainer.metas.items():
    ids, grads = view_stream(packs, pulled, key)
    sums[key] = torch.zeros((meta.rows, grads.shape[1])).index_add_(
        0, ids.to(torch.int64), grads)
  tables = {}
  for f in table_features(features):
    key, row, col = weights.program_columns(trainer, f['name'], 'deep')
    tables[f['name']] = sums[key][row:row + int(f['rows']),
                                  col:col + int(f['dim'])]
  return float(total.detach()), dense, tables


def _reference_gradients(cell, batch):
  model = harness.model_description(cell)
  ref_mod = cell.reference()
  std = float(model['init_std'])
  tables = {}
  for f in table_features(model['features']):
    t = torch.empty((int(f['rows']), int(f['dim'])))
    for lo, hi, block in weights.table_chunks(SEED, f, std, 'cpu'):
      t[lo:hi] = block
    tables[(f['name'], 'deep')] = t
  dense = weights.dense_weights(ref_mod.param_shapes(model), SEED, 'cpu')
  ref = common.Reference(model, functools.partial(ref_mod.model_loss, model),
                         tables, dense, None)
  total, emb, params = ref.total_loss(batch)
  total.backward()
  rows = {}
  for f in table_features(model['features']):
    ids = batch['feat.%s.ids' % f['name']].reshape(-1).to(torch.int64)
    g = emb[(f['name'], 'deep')].grad.reshape(-1, int(f['dim']))
    rows[f['name']] = torch.zeros_like(tables[(f['name'], 'deep')]) \
        .index_add_(0, ids, g)
  return float(total.detach()), {k: p.grad for k, p in params.items()}, rows


def _gap(a, b):
  return float(torch.linalg.vector_norm((a - b).double()) /
               torch.linalg.vector_norm(b.double()))


def test_port_follows_the_reference_leaf_by_leaf():
  cell = _small_cell()
  trainer = _trainer(cell)
  model = harness.model_description(cell)
  weights.load_into_program(trainer, model['features'],
                            cell.reference().param_shapes(model), SEED,
                            float(model['init_std']))
  batch = traffic.make_batch(model['features'], cell.traffic, SEED, 0,
                             torch.device('cpu'))
  loss, dense, tables = _port_gradients(trainer, model['features'], batch)
  ref_loss, ref_dense, ref_tables = _reference_gradients(cell, batch)
  assert abs(loss - ref_loss) / abs(ref_loss) < 1e-6
  assert set(dense) == set(ref_dense)
  cross = [n for n in dense if '.CrossNetV2_0.' in n]
  assert sorted(n.split('.')[-2] for n in cross
                if n.endswith('.weight')) == ['u_0', 'u_1', 'u_2', 'v_0',
                                              'v_1', 'v_2']
  # f32 on both sides, summed in other orders: a leaf's gradient agrees to
  # a few units of its rounding, far under a bf16 product's 4e-3
  for name, g in dense.items():
    assert _gap(g, ref_dense[name]) < 1e-5, name
  assert len(tables) == BAGS
  for name, g in tables.items():
    assert torch.count_nonzero(ref_tables[name].abs().sum(dim=1)) > 0, name
    assert _gap(g, ref_tables[name]) < 1e-5, name


def test_the_cell_is_correct_and_half_a_batch_is_not(clean_env,
                                                     monkeypatch):
  # the test process holds jax already (the suite's conftest): the check
  # of what the run loads looks at what it loads itself
  held = set(sys.modules)
  check = run.forbidden_modules
  monkeypatch.setattr(run, 'forbidden_modules', lambda names: check(
      [n for n in names if n not in held]))
  rc, line = run_line(CELL, seed=SEED)
  assert rc == 0 and line['correct'] is True, line
  assert set(line['metrics']) == {'train_examples_per_s', 'peak_mem_gib',
                                  'setup_s'}
  rc, line = run_line(CELL, seed=SEED, fault=faults.half_batch)
  assert rc == 0 and line['correct'] is False
  assert [k for k, c in line['checks'].items() if c['value'] > c['limit']]


def test_the_cross_and_the_pooling_record_their_spans(tmp_path,
                                                     monkeypatch):
  cell = _small_cell()
  trainer = _trainer(cell)
  feats = harness.model_description(cell)['features']
  batch = traffic.make_batch(feats, cell.traffic, SEED, 0,
                             torch.device('cpu'))
  entered = []

  def counting(name):
    entered.append(name)
    return torch.profiler.record_function(name)

  monkeypatch.setattr(spans, 'record_function', counting)
  trainer.train_step(batch)
  assert entered == []                        # no profiler, no record
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    trainer.train_step(batch)
  got = _program_spans(_events(prof, tmp_path))
  by = {}
  for s in got:
    by.setdefault(s[2], []).append(s)
  assert len(by['easyrec.cross']) == 1
  assert len(by['easyrec.embed.pool']) == BAGS
  assert _inside(by['easyrec.cross'][0], by['easyrec.forward'])
  assert all(_inside(s, by['easyrec.embed'])
             for s in by['easyrec.embed.pool'])
  assert not any(_inside(s, by['easyrec.cross'])
                 for s in by['easyrec.embed'])
  assert entered.count('easyrec.cross') == 1
  assert entered.count('easyrec.embed.pool') == BAGS


def _x(cat, name, ts, dur, **kw):
  e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
       'pid': 1, 'tid': 1}
  e.update(kw)
  return e


def canned_trace(spans_on=True):
  """Two steps of 40 ms. The forward holds the embedding (a 0.5 ms split,
  then a 1 ms pooling inside it) and the Cross (7 ms); on the autograd
  engine's thread the Cross's backward takes 14 ms, the pooling's 2 ms.
  Without `spans_on` the program records neither span (the parent's)."""
  ev = []
  for s, t0 in enumerate((0, 40000)):
    c = 10 * s
    pool_seq, cross_seq = 500 + 2 * s, 501 + 2 * s
    ev += [_x('user_annotation', 'easyrec.step', t0, 39000),
           _x('user_annotation', 'easyrec.forward', t0 + 10, 20000),
           _x('user_annotation', 'easyrec.embed', t0 + 20, 3000),
           _x('cuda_runtime', 'cudaLaunchKernel', t0 + 30, 1,
              args={'correlation': c}),
           _x('cpu_op', 'aten::einsum', t0 + 108, 2,
              args={'Sequence number': pool_seq}),
           _x('cuda_runtime', 'cudaLaunchKernel', t0 + 110, 1,
              args={'correlation': c + 1}),
           _x('cpu_op', 'aten::mm', t0 + 3998, 2,
              args={'Sequence number': cross_seq}),
           _x('cuda_runtime', 'cudaLaunchKernel', t0 + 4000, 1,
              args={'correlation': c + 2})]
    if spans_on:
      ev += [_x('user_annotation', 'easyrec.embed.pool', t0 + 100, 1000),
             _x('user_annotation', 'easyrec.cross', t0 + 3900, 8000)]
    for i, (seq, lo) in enumerate(((cross_seq, 21000), (pool_seq, 36000))):
      ev += [_x('cpu_op', 'autograd::engine::evaluate_function: X', t0 + lo,
                100, tid=2, args={'Sequence number': seq}),
             _x('cuda_runtime', 'cudaLaunchKernel', t0 + lo + 1, 1, tid=2,
                args={'correlation': c + 3 + i})]
    for i, (name, lo, dur) in enumerate((
        ('split', 40, 500), ('pool', 600, 1000), ('cross', 4100, 7000),
        ('cross_bwd', 21100, 14000), ('pool_bwd', 36100, 2000))):
      ev.append(_x('kernel', name, t0 + lo, dur, pid=0, tid=7,
                   args={'correlation': c + i}))
  return ev


def _run(profile_):
  return types.SimpleNamespace(cell=load_cell(CELL), profile=profile_)


def test_the_cells_readers_read_their_spans():
  cell = load_cell(CELL)
  rec = _run(trace.parse(canned_trace(), steps=2))
  read = {m['name']: cell.metric_reader(m['name']).read(rec)
          for m in cell.per_layer}
  assert set(read) == {'cross_ms', 'cross_mfu', 'bag_pool_ms'}
  # the Cross's 7 ms and its backward's 14 ms a step; the pooling's 1 ms
  # and 2 ms, not the embedding's split around it
  assert read['cross_ms'] == pytest.approx(21.0)
  assert read['bag_pool_ms'] == pytest.approx(3.0)
  flops = 3 * 21264768 * 16384
  assert read['cross_mfu'] == pytest.approx(
      100.0 * flops / 21e-3 / peaks.FLOPS['float32'])
  assert 0 < read['cross_mfu'] < 100
  # a trace of a program with no such spans (the parent's), and none
  for rec in (_run(trace.parse(canned_trace(spans_on=False), steps=2)),
              _run(None)):
    for m in cell.per_layer:
      assert cell.metric_reader(m['name']).read(rec) is None, m['name']


def test_cross_flops_at_the_published_widths():
  cell = load_cell(CELL)
  model = harness.model_description(cell)
  ref = cell.reference()
  assert model['cross'] == {'num_layers': 3, 'projection_dim': 512}
  # x0: the bottom MLP's 128 and the 26 bags at 128
  assert model['bottom_mlp'][-1] + sum(
      f['dim'] for f in table_features(model['features'])) == 3456
  assert ref.cross_flops_per_example(model) == 21264768
  assert ref.cross_flops_per_example(model) / \
      ref.flops_per_example(model) == pytest.approx(0.6615, abs=1e-4)


def test_the_touched_rows_fault_puts_the_state_back(clean_env):
  cell = _small_cell()
  trainer = _trainer(cell)
  feats = harness.model_description(cell)['features']
  batch = traffic.make_batch(feats, cell.traffic, SEED, 0,
                             torch.device('cpu'))
  opt = trainer.dense_opt

  def state():
    return ([t.clone() for t in trainer.tables.values()] +
            [t.detach().clone() for t in opt.params + opt.mu + opt.nu] +
            [opt.count.clone(), trainer.step.clone()])

  before = state()
  calibrate_backbone.state_unchanged(trainer)
  out = trainer.train_step(batch)
  assert torch.isfinite(out['total_loss'])
  after = state()
  assert len(after) == len(before)
  assert all(torch.equal(a, b) for a, b in zip(after, before))


def test_the_calibration_at_the_cells_size_runs_and_bf16_fails(clean_env,
                                                              tmp_path):
  close, fault = harness.Session.close, faults.FAULTS['state_unchanged']
  loss = common.Reference.total_loss
  out = tmp_path / 'calib.jsonl'
  assert calibrate_backbone.main(
      ['--workload', CELL, '--first_seed', str(SEED), '--seeds', '1',
       '--control_seeds', '1', '--fault_seeds', '0', '--out', str(out)],
      device='cpu', shrink=SMALL) == 0
  # what it changed for the run is put back
  assert harness.Session.close is close
  assert faults.FAULTS['state_unchanged'] is fault
  assert common.Reference.total_loss is loss
  lines = [json.loads(t) for t in out.read_text().splitlines()]
  by = {r['kind']: r for r in lines if 'kind' in r}
  assert set(by) == {'port', 'control_bf16', 'reference_bf16'}
  assert [r['workload'] for r in lines if 'summary' in r] == [CELL, CELL]
  limits = _small_cell().workload['limits']
  assert check.verdict(by['port']['numbers'], limits)[0] is True
  # the plain reference with its products in bfloat16, put in the port's
  # place, is not correct by the cell's limits
  ctl = by['reference_bf16']
  assert ctl['correct'] is False
  assert check.verdict(ctl['numbers'], limits)[0] is False
  assert [k for k in check.NUMBERS if ctl['numbers'][k] > limits[k]]
