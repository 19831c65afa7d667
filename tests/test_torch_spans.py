"""The port's spans (easyrec_torch/utils/spans.py): recorded inside the train
step where the work happens, only while a torch profiler runs; fit's
is_profiling trace; and recbench/spans.py's reading of them from a chrome
trace, beside the harness's own ranges (recbench/trace.py), whose readers
must read what they read before the spans existed."""

import glob
import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from easyrec_torch import main as t_main
from easyrec_torch.config import config_util
from easyrec_torch.parallel import launch
from easyrec_torch.train.trainer import Trainer, to_device
from easyrec_torch.utils import dryrun, spans
from easyrec_torch.utils.synthetic import synthetic_batch
from recbench import counts, peaks, trace
from recbench import spans as rspans
from recbench.cell import load_cell
from tests import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_SPANS = ('easyrec.step', 'easyrec.pack', 'easyrec.pull',
              'easyrec.forward', 'easyrec.embed', 'easyrec.embed.split',
              'easyrec.loss',
              'easyrec.backward', 'easyrec.dense_opt',
              'easyrec.sparse_update', 'easyrec.sparse_update.sort')


def _ev_config_text():
  """samples/deepfm_ev_params.config at CPU size (the widths the
  sample's)."""
  with open(os.path.join(REPO, 'samples', 'deepfm_ev_params.config')) as f:
    text = f.read()
  for old, new in (('hash_bucket_size: 100000', 'hash_bucket_size: 1000'),
                   ('hash_bucket_size: 10000', 'hash_bucket_size: 100'),
                   ('batch_size: 1024', 'batch_size: 32')):
    assert old in text, old
    text = text.replace(old, new)
  return text


def _trainer(tmp_path, which):
  if which == 'ev':
    cfg = config_util.get_configs_from_pipeline_str(_ev_config_text())
  else:
    cfg = config_util.get_configs_from_pipeline_file(
        fixtures.write_pipeline(tmp_path, n_train=64, n_eval=64,
                                batch_size=32))
  trainer = Trainer(cfg, device='cpu')
  trainer.init_state()
  return trainer


def _batch(trainer, seed=0):
  bs = int(trainer.data_config.batch_size)
  return to_device(synthetic_batch(trainer.specs,
                                   list(trainer.ctx.label_fields), bs,
                                   seed=seed), trainer.device)


def _events(prof, tmp_path):
  path = os.path.join(str(tmp_path), 'trace.json')
  prof.export_chrome_trace(path)
  with open(path) as f:
    return json.load(f)['traceEvents']


def _program_spans(events):
  return [(float(e['ts']), float(e['ts']) + float(e['dur']), e['name'])
          for e in events if e.get('ph') == 'X' and
          e.get('cat') == 'user_annotation' and
          e['name'].startswith('easyrec.')]


def _inside(inner, outers):
  return any(lo <= inner[0] and inner[1] <= hi for lo, hi, _ in outers)


@pytest.mark.parametrize('which', ['deepfm', 'ev'])
def test_train_step_records_its_spans_nested(tmp_path, which):
  trainer = _trainer(tmp_path, which)
  batch = _batch(trainer)
  trainer.train_step(batch)                  # the first step, untraced
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    trainer.train_step(batch)
  got = _program_spans(_events(prof, tmp_path))
  names = [n for _, _, n in got]
  by = {n: [s for s in got if s[2] == n] for n in set(names)}
  for name in STEP_SPANS:
    if name in ('easyrec.embed', 'easyrec.sparse_update.sort'):
      assert names.count(name) >= 1
    elif name == 'easyrec.embed.split':
      # one a pack (a table here: no sampled views)
      assert names.count(name) == len(trainer.metas), names.count(name)
    else:
      assert names.count(name) == 1, (name, names.count(name))
  assert names.count('easyrec.ev') == (2 if which == 'ev' else 0)
  # a sort a table in the update, and the EV state's own in its update
  sorts = by['easyrec.sparse_update.sort']
  assert sum(_inside(s, by['easyrec.sparse_update'])
             for s in sorts) == len(trainer.metas)
  assert all(_inside(s, by['easyrec.sparse_update'] +
                     by.get('easyrec.ev', [])) for s in sorts)
  assert 'easyrec.input' not in names         # fit's alone
  for s in got:
    if s[2] != 'easyrec.step':
      assert _inside(s, by['easyrec.step']), s
  for s in by['easyrec.embed']:
    assert _inside(s, by['easyrec.forward']), s
  for s in by['easyrec.embed.split']:
    assert _inside(s, by['easyrec.embed']), s
  for s in by.get('easyrec.ev', []):
    assert not _inside(s, by['easyrec.sparse_update'])
    assert not _inside(s, by['easyrec.forward'])
  # the stages in the step's order
  order = [by[n][0][0] for n in (
      'easyrec.pack', 'easyrec.pull', 'easyrec.forward', 'easyrec.loss',
      'easyrec.backward', 'easyrec.dense_opt', 'easyrec.sparse_update')]
  assert order == sorted(order)


def test_spans_enter_no_record_function_without_a_profiler(tmp_path,
                                                           monkeypatch):
  entered = []

  def counting(name):
    entered.append(name)
    return torch.profiler.record_function(name)

  monkeypatch.setattr(spans, 'record_function', counting)
  trainer = _trainer(tmp_path, 'deepfm')
  batch = _batch(trainer)
  trainer.train_step(batch)
  assert entered == []
  assert spans.span('easyrec.a') is spans.span('easyrec.b')
  # the same step under a profiler enters each span through it
  with profile(activities=[ProfilerActivity.CPU]):
    trainer.train_step(batch)
  assert set(STEP_SPANS) <= set(entered)


def test_fit_is_profiling_writes_a_trace_of_the_first_window(tmp_path):
  path = fixtures.write_pipeline(tmp_path, n_train=256, n_eval=64,
                                 batch_size=32, num_steps=6)
  with open(path) as f:
    text = f.read().replace('log_step_count_steps: 20',
                            'log_step_count_steps: 2 is_profiling: true')
  cfg = config_util.get_configs_from_pipeline_str(text)
  assert cfg.train_config.is_profiling
  assert cfg.train_config.log_step_count_steps == 2
  result = t_main.train_and_evaluate(cfg, device='cpu')
  assert result['global_step'] == 6
  assert not torch.autograd._profiler_enabled()
  files = glob.glob(os.path.join(cfg.model_dir, 'profile', '*.json'))
  assert [os.path.basename(f) for f in files] == ['rank0.pt.trace.json']
  with open(files[0]) as f:
    names = [n for _, _, n in _program_spans(json.load(f)['traceEvents'])]
  # the first logging window: two steps, each with its input
  assert names.count('easyrec.step') == 2
  assert names.count('easyrec.input') >= 2
  assert set(STEP_SPANS) <= set(names)


WORLD_BODY = """
  model_class: "DeepFM"
  feature_groups { group_name: "deep" feature_names: "uid"
                   feature_names: "iid" feature_names: "cate"
                   wide_deep: DEEP }
  feature_groups { group_name: "wide" feature_names: "iid"
                   wide_deep: WIDE }
  deepfm { dnn { hidden_units: [16, 8] use_bn: false }
           final_dnn { hidden_units: [8] use_bn: false } }
"""


def world_fit_worker(world, text):
  """fit on this rank of a world (tables row-sharded): its steps and the
  tables it shards."""
  trainer = Trainer(config_util.get_configs_from_pipeline_str(text),
                    world=world)
  result = trainer.fit(eval_at_end=False, checkpoint=False)
  return result['global_step'], sorted(trainer.sharding.splits)


def test_fit_is_profiling_in_a_world_writes_a_trace_a_rank(tmp_path):
  """Two gloo processes, tables row-sharded: the pull and the update go
  through the exchange, inside the same spans, and each rank writes its
  own trace."""
  train, _ = dryrun.write_data(str(tmp_path))
  model_dir = os.path.join(str(tmp_path), 'md')
  text = dryrun._BASE.format(train=train, batch=16, sampler='', ev='',
                             body=WORLD_BODY)
  for old, new in (('model_dir: ""', 'model_dir: "%s"' % model_dir),
                   ('num_steps: 1', 'num_steps: 4 log_step_count_steps: 2 '
                                    'is_profiling: true')):
    assert old in text
    text = text.replace(old, new)
  out = launch.spawn('tests.test_torch_spans:world_fit_worker', [text], 2,
                     timeout_s=180)
  assert [steps for steps, _ in out] == [4, 4]
  assert all(tables for _, tables in out)      # row-sharded
  for rank in range(2):
    with open(os.path.join(model_dir, 'profile',
                           'rank%d.pt.trace.json' % rank)) as f:
      names = [n for _, _, n in
               _program_spans(json.load(f)['traceEvents'])]
    assert names.count('easyrec.step') == 2
    assert set(STEP_SPANS) <= set(names), rank


def test_is_profiling_is_off_by_default_and_writes_nothing(tmp_path):
  path = fixtures.write_pipeline(tmp_path, n_train=128, n_eval=64,
                                 batch_size=32, num_steps=2)
  cfg = config_util.get_configs_from_pipeline_file(path)
  assert cfg.train_config.is_profiling is False
  assert not cfg.train_config.HasField('is_profiling')
  t_main.train_and_evaluate(cfg, device='cpu')
  assert not os.path.exists(os.path.join(cfg.model_dir, 'profile'))


# -- recbench/spans.py on a synthetic chrome trace -----------------------

MAIN, AUTO = {'pid': 1, 'tid': 1}, {'pid': 1, 'tid': 2}
EVALUATE = 'autograd::engine::evaluate_function: '


def _x(cat, name, ts, dur, **kw):
  e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}
  e.update(kw)
  return e


def _step_events(t0, corr0, program=True, harness=True):
  """One train step from t0 (us): the harness's ranges and, with
  `program`, the port's spans around the same launches; the backward on
  the autograd engine's thread as on a card. Device time a step: pack 2,
  gather 4, the embedding slice 1 and its backward 7, the forward's mm 4
  and its backward 4, the loss 1 and its backward 2, AccumulateGrad 1,
  the ones of backward() 1, the dense Adam 2, the sort 4, K1 2."""
  ev = []

  def x(cat, name, ts, dur, **kw):
    ev.append(_x(cat, name, t0 + ts, dur, **kw))

  def rng(name, ts, dur, span=None):
    if harness:
      x('user_annotation', 'recbench.' + name, ts, dur, **MAIN)
    if program:
      x('user_annotation', 'easyrec.' + (span or name), ts + 0.5, dur - 1,
        **MAIN)

  def launch(ts, c, thread=MAIN):
    x('cuda_runtime', 'cudaLaunchKernel', ts, 0.2,
      args={'correlation': corr0 + c}, **thread)

  def kernel(name, ts, dur, c):
    x('kernel', name, ts, dur, pid=0, tid=7,
      args={'correlation': corr0 + c})

  def seq(n):
    return {'Sequence number': corr0 + n, 'Fwd thread id': 0}

  if harness:
    x('user_annotation', 'recbench.step', 0, 100, **MAIN)
  if program:
    x('user_annotation', 'easyrec.step', 1, 98, **MAIN)
  rng('pack', 2, 5)
  launch(3, 1)
  rng('pull', 7, 5)
  x('cpu_op', 'aten::index_select', 8, 2, **MAIN)
  launch(9, 2)
  rng('forward', 13, 18)
  rng('embed', 14, 4)
  x('cpu_op', 'aten::slice', 15, 1, args=seq(8), **MAIN)
  launch(15.5, 3)
  x('cpu_op', 'aten::mm', 20, 2, args=seq(9), **MAIN)
  launch(21, 4)
  rng('loss', 31, 5)
  x('cpu_op', 'aten::sum', 32, 1, args=seq(10), **MAIN)
  launch(32.5, 5)
  if program:
    x('user_annotation', 'easyrec.backward', 36, 24, **MAIN)
  launch(36.5, 6)
  x('cpu_op', EVALUATE + 'SumBackward0', 37, 3, args=seq(10), **AUTO)
  launch(38, 7, AUTO)
  x('cpu_op', EVALUATE + 'MmBackward0', 41, 4, args=seq(9), **AUTO)
  launch(42, 8, AUTO)
  x('cpu_op', EVALUATE + 'SliceBackward0', 46, 6, args=seq(8), **AUTO)
  launch(47, 9, AUTO)
  x('cpu_op', EVALUATE + 'torch::autograd::AccumulateGrad', 53, 3, **AUTO)
  launch(54, 10, AUTO)
  rng('dense_opt', 61, 5)
  launch(62, 11)
  rng('sparse_update', 67, 27)
  if program:
    x('user_annotation', 'easyrec.sparse_update.sort', 68, 12, **MAIN)
  launch(69, 12)
  x('cpu_op', 'aten::copy_', 75, 4, **MAIN)
  x('cuda_runtime', 'cudaMemcpyAsync', 75.5, 0.3, **MAIN)
  x('cuda_runtime', 'cudaStreamSynchronize', 76, 2, **MAIN)
  launch(81, 13)
  # after the port's step, inside the harness's
  x('cuda_runtime', 'cudaDeviceSynchronize', 99.2, 0.5, **MAIN)
  for name, ts, dur, c in (
      ('pack_k', 10, 2, 1), ('gather', 12, 4, 2), ('slice', 16, 1, 3),
      ('mm', 22, 4, 4), ('sum', 33, 1, 5), ('ones', 37, 1, 6),
      ('sum_bwd', 39, 2, 7), ('mm_bwd', 43, 4, 8), ('slice_bwd', 48, 7, 9),
      ('acc', 55, 1, 10), ('adam', 62, 2, 11), ('sort', 70, 4, 12),
      ('k1', 81, 2, 13)):
    kernel(name, ts, dur, c)
  return ev


def synthetic_trace(program=True, harness=True):
  """Two steps 100 us apart, and an instant event the parsers skip."""
  return (_step_events(0, 0, program, harness) +
          _step_events(100, 100, program, harness) +
          [{'ph': 'i', 'name': 'marker', 'ts': 3}])


def _run(profile):
  return types.SimpleNamespace(
      cell=load_cell('deepfm_criteo.zipf_b131072'), profile=profile,
      setup_s=1.0, peak_bytes=0, flops_per_example=1e6,
      window={'steps': 10, 'seconds': 2.0, 'step_ms': [100.0] * 10},
      trace_counts=[{'slots': 1000, 'rows': 100, 'slot_bytes': 72000}] * 2)


def test_parse_attributes_launches_to_the_innermost_span():
  s = rspans.parse(synthetic_trace(), steps=2)
  by = {}
  for op in s.ops:
    by.setdefault(op.name, set()).add(op.range)
  assert by == {
      'pack_k': {'easyrec.pack'}, 'gather': {'easyrec.pull'},
      'slice': {'easyrec.embed'}, 'mm': {'easyrec.forward'},
      'sum': {'easyrec.loss'}, 'ones': {'easyrec.backward'},
      'sum_bwd': {'backward:easyrec.loss'},
      'mm_bwd': {'backward:easyrec.forward'},
      'slice_bwd': {'backward:easyrec.embed'}, 'acc': {'backward'},
      'adam': {'easyrec.dense_opt'}, 'sort': {'easyrec.sparse_update.sort'},
      'k1': {'easyrec.sparse_update'}}
  assert {op.host_op for op in s.ops if op.name == 'gather'} == \
      {'aten::index_select'}
  assert (s.start, s.end) == (1.0, 183.0)
  assert s.step_thread == (1, 1)


def test_parse_counts_the_step_syncs_with_span_and_host_op():
  s = rspans.parse(synthetic_trace(), steps=2)
  assert [(c.name, c.span, c.host_op) for c in rspans.step_syncs(s)] == [
      ('cudaStreamSynchronize', 'easyrec.sparse_update.sort',
       'aten::copy_')] * 2
  assert rspans.host_syncs_per_step(s) == 1.0
  assert rspans.sync_table(s) == [
      ['cudaStreamSynchronize', 'easyrec.sparse_update.sort', 'aten::copy_',
       1.0],
      ['cudaDeviceSynchronize', 'between steps', '', 1.0]]
  # 98 us of easyrec.step a step on its thread, less its 2 us of sync
  assert rspans.host_issue_ms(s) == pytest.approx(96 / 1e3)


def test_idle_by_span_splits_each_idle_interval_over_the_spans():
  s = rspans.parse(synthetic_trace(), steps=2)
  idle = rspans.idle_by_span(s)
  total = sum(hi - lo for lo, hi in s.idle_intervals())
  assert sum(idle.values()) == pytest.approx(total / 1e3 / 2)
  # the device waits 1-10 us a step: 2.5 in the step, 4 in the pack
  # (2.5-6.5), 2.5 in the pull (7.5-10); 68-70 and 74-80 in the sort
  assert idle['easyrec.pack'] == pytest.approx(4 / 1e3)
  assert idle['easyrec.pull'] == pytest.approx(2.5 / 1e3)
  assert idle['easyrec.sparse_update.sort'] == pytest.approx(
      (2 + 6) / 1e3)
  # between the first step's end (99) and the second's start (101)
  assert idle['between steps'] == pytest.approx(2 / 1e3 / 2)
  inside = rspans._overlap(s.idle_intervals(), s.step_intervals())
  assert rspans.step_idle_ms(s) == pytest.approx(inside / 1e3 / 2)
  assert rspans.step_idle_ms(s) == pytest.approx(
      sum(v for k, v in idle.items() if k != 'between steps'))
  table = rspans.span_table(s)
  assert table['easyrec.sparse_update.sort']['device_ms'] == \
      pytest.approx(4 / 1e3)
  assert table['easyrec.sparse_update.sort']['syncs'] == 1.0
  assert table['backward:easyrec.embed']['host_ms'] is None
  assert table['easyrec.step']['host_ms'] == pytest.approx(98 / 1e3)


def test_program_metrics_equal_their_harness_twins():
  events = synthetic_trace()
  run = _run(trace.parse(events, steps=2))
  s = rspans.parse(events, steps=2)
  got = rspans.metrics(s, run)
  for mine, theirs in rspans.TWINS.items():
    want = run.cell.metric_reader(theirs).read(run)
    assert got[mine] == pytest.approx(want, rel=1e-12), mine
  assert got['embedding_ms'] == pytest.approx(14 / 1e3)
  assert got['dense_model_ms'] == pytest.approx(12 / 1e3)
  assert got['dense_optimizer_ms'] == pytest.approx(2 / 1e3)
  assert got['sparse_sort_ms'] == pytest.approx(4 / 1e3)
  need = 2 * counts.sparse_update_bytes(72000, 100,
                                        run.cell.config['layout'])
  assert got['sparse_update_hbm_pct'] == pytest.approx(
      100 * need / peaks.HBM_BYTES_PER_S * 1e6 / 12)


@pytest.mark.parametrize('what', ['no spans', 'no device operations'])
def test_program_metrics_read_nothing_without_their_spans(what):
  if what == 'no spans':
    events = synthetic_trace(program=False)
    want = set()
  else:
    events = [e for e in synthetic_trace() if e.get('cat') != 'kernel']
    want = {'host_syncs_per_step', 'host_issue_ms'}
  s = rspans.parse(events, steps=2)
  assert set(rspans.metrics(s, _run(None))) == want


# the harness's readers on the synthetic trace, pinned at the values they
# read before the port had spans: the spans change nothing they read
HARNESS_READINGS = {
    'launches_per_step': 13.0,
    'pack_pull_ms': 0.014,
    'dense_fwd_bwd_ms': 0.012,
    'dense_opt_ms': 0.002,
    'sparse_update_roofline': 100 * 2 * (72000 + 2 * 100 * 4 * 64) /
                              3.35e12 * 1e6 / 12,
    'device_idle_pct': 100 * (1 - 70 / 183),
    'step_mfu': 100 * 3e6 * 10 * 131072 / 2.0 / 67e12,
}


@pytest.mark.parametrize('program', [True, False],
                         ids=['with spans', 'without spans'])
@pytest.mark.parametrize('metric', sorted(HARNESS_READINGS))
def test_harness_readers_read_as_before(metric, program):
  run = _run(trace.parse(synthetic_trace(program=program), steps=2))
  got = run.cell.metric_reader(metric).read(run)
  assert got == pytest.approx(HARNESS_READINGS[metric], rel=1e-12)


def test_span_tool_runs_the_cell_small_on_the_cpu(tmp_path, capsys):
  """recbench.spans's own run: the cell at CPU size, both the harness's
  ranges and the spans in one trace."""
  from recbench.tests.small import SMALL, bench_root
  root = bench_root(str(tmp_path))
  threads = torch.get_num_threads()
  torch.set_num_threads(2)
  try:
    assert rspans.main(['--workload', 'deepfm_criteo.zipf_b131072',
                        '--seed', str(2 ** 31 + 5)], device='cpu',
                       root=root, shrink=SMALL) == 0
  finally:
    torch.set_num_threads(threads)
  line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  # no device operations on the CPU: the host's metrics alone
  assert set(line['program']) == {'host_syncs_per_step', 'host_issue_ms'}
  assert line['program']['host_syncs_per_step'] == 0.0
  assert line['harness'] == {}
  table = line['breakdown']['spans']
  assert set(STEP_SPANS) <= set(table)
  assert table['easyrec.step']['host_ms'] == pytest.approx(
      line['program']['host_issue_ms'])
  assert line['span_off_ns'] > 0
  assert np.isfinite(line['spans_per_step'])
