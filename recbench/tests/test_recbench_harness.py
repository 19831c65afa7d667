"""The harness's generality, on the CPU at small.py's size: the DeepFM
traffic and reference read what they read before (pinned_deepfm.json); a
DLRM-DCNv2 cell, with dense values that have no table, multi-hot bags and
the backbone's Cross, enters a copy of the benchmark as files alone and
runs `correct`, and a broken step under it does not; a metric's reader of
one line reads a span of the port by name."""

import hashlib
import json
import os
import shutil

import pytest
import torch

from recbench import faults, harness, spans, trace, traffic
from recbench.cell import REPO_DIR, load_cell
from recbench.tests import dlrm_dcnv2
from recbench.tests.small import SMALL, run_line
from recbench.tests.test_recbench_metrics import canned_run

DEEPFM = 'deepfm_criteo.zipf_b131072'
SPAN_READER = ("from recbench.trace import span_reader; "
               "read = span_reader('easyrec.forward')\n")


def _pinned():
  with open(os.path.join(os.path.dirname(__file__),
                         'pinned_deepfm.json')) as f:
    return json.load(f)


def _digest(batch):
  h = hashlib.sha256()
  for k in sorted(batch):
    t = batch[k].contiguous()
    h.update(('%s %s %s;' % (k, t.dtype, tuple(t.shape))).encode())
    h.update(t.numpy().tobytes())
  return h.hexdigest()


def _deepfm():
  cell = load_cell(DEEPFM, shrink=SMALL)
  harness.set_environment(cell)
  return cell, harness.model_description(cell)['features']


@pytest.mark.parametrize('seed', [7, 11])
def test_deepfm_batches_are_the_pinned_ones(seed):
  cell, feats = _deepfm()
  got = [_digest(b) for b in traffic.make_batches(
      feats, cell.traffic, seed, torch.device('cpu'))]
  assert got == _pinned()['batches'][str(seed)]


def test_deepfm_reference_reads_the_pinned_readings():
  pinned = _pinned()
  cell, feats = _deepfm()
  batches = traffic.make_batches(feats, cell.traffic, pinned['seed'],
                                 torch.device('cpu'), harness.CHECK_STEPS)
  got = harness.reference_readings(cell, pinned['seed'], batches, 'cpu')
  want = pinned['readings']
  assert got['loss'] == pytest.approx(want['loss'], rel=1e-12, abs=0)
  for q in ('grad_m', 'grad_v', 'change'):
    assert set(got[q]) == set(want[q])
    for leaf, value in want[q].items():
      assert got[q][leaf] == pytest.approx(value, rel=1e-12, abs=0), \
          (q, leaf)


def _copy(tmp_path):
  shutil.copy(os.path.join(REPO_DIR, 'BENCHMARK.json'), tmp_path)
  shutil.copytree(os.path.join(REPO_DIR, 'recbench'), tmp_path / 'recbench',
                  ignore=shutil.ignore_patterns('__pycache__', 'tests'))
  return str(tmp_path)


def _sources(root):
  out = {}
  for d, _, names in os.walk(os.path.join(root, 'recbench')):
    for n in names:
      if n.endswith('.py'):
        with open(os.path.join(d, n), 'rb') as f:
          out[os.path.relpath(os.path.join(d, n), root)] = \
              hashlib.sha256(f.read()).hexdigest()
  return out


@pytest.fixture(scope='module')
def dlrm_root(tmp_path_factory):
  """A copy of the benchmark with the DLRM-DCNv2 cell added, and a
  per-layer metric of it that reads the port's easyrec.forward span."""
  root = _copy(tmp_path_factory.mktemp('dlrm'))
  before = _sources(root)
  cell = dlrm_dcnv2.write(root)
  with open(os.path.join(root, 'recbench', 'metrics',
                         'dlrm_forward_ms.py'), 'w') as f:
    f.write(SPAN_READER)
  path = os.path.join(root, 'BENCHMARK.json')
  with open(path) as f:
    bench = json.load(f)
  bench['per_layer'].append({
      'name': 'dlrm_forward_ms', 'unit': 'ms', 'better': 'lower',
      'source': 'device_trace', 'layer': 'dense model',
      'moves': 'train_examples_per_s', 'workloads': [cell]})
  with open(path, 'w') as f:
    json.dump(bench, f)
  after = _sources(root)
  # files added, none of the harness's edited
  assert {k: v for k, v in after.items() if k in before} == before
  return root


def test_dlrm_dcnv2_cell_from_files_alone(dlrm_root):
  cell = load_cell(dlrm_dcnv2.CELL, dlrm_root, SMALL)
  feats = harness.model_description(cell)['features']
  assert [f['name'] for f in feats if f['kind'] == 'dense'] == ['dense']
  batch = traffic.make_batch(feats, cell.traffic, 3, 0, torch.device('cpu'))
  assert batch['feat.dense.dense'].shape == (64, 13)
  assert 'feat.dense.ids' not in batch
  assert batch['feat.C21.ids'].shape == (64, 100)
  assert traffic.slot_counts(feats, batch)['slots'] == 64 * 214
  rc, line = run_line(dlrm_dcnv2.CELL, seed=2 ** 31 + 99, root=dlrm_root)
  assert rc == 0 and line['correct'] is True, line
  assert set(line['metrics']) == {'train_examples_per_s', 'peak_mem_gib',
                                  'setup_s'}
  # traced: no device operation on the CPU, so the span's reader reads
  # nothing and the line leaves it out
  rc, line = run_line(dlrm_dcnv2.CELL, seed=2 ** 31 + 98, trace=1,
                      root=dlrm_root)
  assert rc == 0 and line['correct'] is True
  assert 'dlrm_forward_ms' not in line['metrics']


def test_dlrm_dcnv2_half_batch_is_not_correct(dlrm_root):
  rc, line = run_line(dlrm_dcnv2.CELL, seed=2 ** 31 + 99, root=dlrm_root,
                      fault=faults.half_batch)
  assert rc == 0 and line['correct'] is False
  assert [k for k, c in line['checks'].items() if c['value'] > c['limit']]


def _x(cat, name, ts, dur, **kw):
  e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
       'pid': 1, 'tid': 1}
  e.update(kw)
  return e


def _kernel(name, ts, dur, corr):
  return _x('kernel', name, ts, dur, pid=0, tid=7,
            args={'correlation': corr})


def _launch(ts, corr, tid=1):
  return _x('cuda_runtime', 'cudaLaunchKernel', ts, 0.2, tid=tid,
            args={'correlation': corr})


def canned_trace():
  """Two steps: in each, the forward launches a 3 us kernel whose
  backward (the autograd engine's node of the same sequence number, on
  its own thread) takes 5 us, and the update's sort 4 us of a 6 us
  update."""
  ev = []
  for s, t0 in enumerate((0, 100)):
    c = 10 * s
    seq = {'Sequence number': 1000 + s}
    ev += [
        _x('user_annotation', 'recbench.step', t0, 100),
        _x('user_annotation', 'easyrec.step', t0 + 1, 98),
        _x('user_annotation', 'easyrec.forward', t0 + 2, 10),
        _x('cpu_op', 'aten::mm', t0 + 3, 2, args=seq),
        _launch(t0 + 4, c + 1),
        _x('cpu_op', 'autograd::engine::evaluate_function: MmBackward0',
           t0 + 20, 5, tid=2, args=seq),
        _launch(t0 + 21, c + 2, tid=2),
        _x('user_annotation', 'easyrec.sparse_update', t0 + 40, 30),
        _x('user_annotation', 'easyrec.sparse_update.sort', t0 + 41, 10),
        _launch(t0 + 42, c + 3),
        _launch(t0 + 55, c + 4),
        _kernel('mm', t0 + 5, 3, c + 1),
        _kernel('mm_bwd', t0 + 22, 5, c + 2),
        _kernel('sort', t0 + 43, 4, c + 3),
        _kernel('k2', t0 + 56, 2, c + 4)]
  return ev


def test_a_one_line_reader_reads_a_span_by_name(dlrm_root):
  profile = trace.parse(canned_trace(), steps=2)
  assert profile.spans is not None
  cell = load_cell(dlrm_dcnv2.CELL, dlrm_root, SMALL)
  with open(cell.path('metrics', 'dlrm_forward_ms.py')) as f:
    assert f.read().count('\n') == 1
  reader = cell.metric_reader('dlrm_forward_ms')
  run = canned_run(profile)
  # the forward's 3 us and its backward's 5 us, a step
  assert reader.read(run) == pytest.approx(8 / 1e3)
  assert spans.span_ms(profile.spans, ['easyrec.forward']) == \
      reader.read(run)
  # no trace, a trace without the span, a trace without device operations
  assert reader.read(canned_run(None)) is None
  assert spans.span_ms(profile.spans, ['easyrec.cross']) is None
  quiet = trace.parse([e for e in canned_trace() if e['cat'] != 'kernel'],
                      steps=2)
  assert reader.read(canned_run(quiet)) is None


def test_sparse_sort_ms_reads_the_sort_span():
  profile = trace.parse(canned_trace(), steps=2)
  run = canned_run(profile)
  got = run.cell.metric_reader('sparse_sort_ms').read(run)
  assert got == pytest.approx(4 / 1e3)
  # the twin that recbench.spans prints, on the same trace
  assert got == spans.sparse_sort_ms(profile.spans)
  assert run.cell.metric_reader('sparse_sort_ms').read(
      canned_run(trace.parse(canned_trace()[:4], steps=2))) is None
