"""Each metric reader on canned timings and a canned profile, and the
trace's parse on a canned chrome trace."""

import types

import pytest

from recbench import counts, peaks, trace
from recbench.cell import load_cell


def _op(start, dur, rng, name='k', kind='kernel', host='aten::mul'):
  return trace.DeviceOp(name=name, start=start, dur=dur, kind=kind,
                        range=rng, host_op=host)


def canned_run(profile=None):
  cell = load_cell('deepfm_criteo.zipf_b131072')
  return types.SimpleNamespace(
      cell=cell, setup_s=12.5, peak_bytes=3 * 2 ** 30,
      flops_per_example=1e6,
      window={'steps': 100, 'seconds': 5.0,
              'step_ms': [50.0] * 90 + [60.0 + i for i in range(10)]},
      profile=profile,
      trace_counts=[{'slots': 1000, 'rows': 100, 'slot_bytes': 72000}] * 2)


def canned_profile():
  # two steps over 100 us; the device busy 0-30 (the copy at 20-30 overlaps
  # the pull, counted once), 50-70 and 80-90: 60 us
  ops = [_op(0, 10, 'recbench.pack'), _op(10, 20, 'recbench.pull'),
         _op(20, 10, 'recbench.forward', kind='memcpy'),
         _op(50, 5, trace.backward_of('recbench.forward')),
         _op(55, 5, trace.backward_of('recbench.embed')),
         _op(60, 10, 'recbench.dense_opt'),
         _op(80, 10, 'recbench.sparse_update', host='aten::sort')]
  return trace.Profile(steps=2, start=0.0, end=100.0, ops=ops)


def read(name, run):
  return run.cell.metric_reader(name).read(run)


def test_end_to_end_readers():
  run = canned_run()
  assert read('train_examples_per_s', run) == 100 * 131072 / 5.0
  assert read('step_ms_p95.host_paced', run) == 64.0      # rank 95 of 100
  assert read('peak_mem_gib', run) == 3.0
  assert read('setup_s', run) == 12.5
  # 3 x 1e6 x 100 steps x 131072 / 5 s / 67 TFLOP/s
  assert read('step_mfu', run) == pytest.approx(
      100 * 3e6 * 100 * 131072 / 5.0 / 67e12)


def test_per_layer_readers():
  run = canned_run(canned_profile())
  assert read('launches_per_step', run) == 6 / 2          # memcpy is no kernel
  # the pack, the pull and the backward of the input layer's embedding
  assert read('pack_pull_ms', run) == pytest.approx(35 / 1e3 / 2)
  # the forward and the backward of what it recorded
  assert read('dense_fwd_bwd_ms', run) == pytest.approx(15 / 1e3 / 2)
  assert read('dense_opt_ms', run) == pytest.approx(10 / 1e3 / 2)
  assert read('device_idle_pct', run) == pytest.approx(100 * (1 - 60 / 100))
  need = 2 * counts.sparse_update_bytes(72000, 100,
                                        run.cell.config['layout'])
  assert read('sparse_update_roofline', run) == pytest.approx(
      100 * need / peaks.HBM_BYTES_PER_S * 1e6 / 10)


def test_readers_read_nothing_without_their_ranges():
  empty = trace.Profile(steps=2, start=0.0, end=10.0, ops=[])
  run = canned_run(empty)
  for name in ('launches_per_step', 'pack_pull_ms', 'dense_fwd_bwd_ms',
               'dense_opt_ms', 'sparse_update_roofline', 'device_idle_pct'):
    assert read(name, run) is None
    assert read(name, canned_run(None)) is None


def test_breakdown_and_gaps():
  p = canned_profile()
  b = trace.breakdown(p)
  assert b['device_ops'][0] == ['recbench.pull: k', 20 / 1e6]
  gaps = dict(b['idle_gaps'])
  assert gaps == {'backward:recbench.forward: aten::mul': 20 / 1e6,
                  'recbench.sparse_update: aten::sort': 10 / 1e6}


def test_parse_attributes_launches_to_ranges():
  main, auto = {'pid': 1, 'tid': 1}, {'pid': 1, 'tid': 2}

  def x(cat, name, ts, dur, **kw):
    e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}
    e.update(kw)
    return e

  def seq(n):
    return {'Sequence number': n, 'Fwd thread id': 0}

  def launch(ts, corr, thread=main, name='cudaLaunchKernel'):
    return x('cuda_runtime', name, ts, 1, args={'correlation': corr},
             **thread)

  def kernel(name, ts, dur, corr, cat='kernel'):
    return x(cat, name, ts, dur, pid=0, tid=7, args={'correlation': corr})

  evaluate = 'autograd::engine::evaluate_function: '
  events = [
      x('user_annotation', 'recbench.step', 0, 100, **main),
      x('user_annotation', 'recbench.pull', 1, 10, **main),
      x('cpu_op', 'aten::index_select', 2, 5, args=seq(7), **main),
      launch(3, 1),
      x('user_annotation', 'recbench.forward', 11, 8, **main),
      x('user_annotation', 'recbench.embed', 12, 2, **main),
      x('cpu_op', 'aten::slice', 12.5, 1, args=seq(8), **main),
      # an operation that makes no node holds the number the next one
      # makes its node with: the later one, in the forward, recorded it
      x('cpu_op', 'aten::reshape', 14.5, 0.2, args=seq(9), **main),
      x('cpu_op', 'aten::mm', 15, 2, args=seq(9), **main),
      x('cpu_op', evaluate + 'SliceBackward0', 20, 10, args=seq(8), **auto),
      launch(21, 2, auto),
      x('cpu_op', evaluate + 'MmBackward0', 31, 4, args=seq(9), **auto),
      x('cpu_op', 'MmBackward0', 31.5, 3, args=seq(9), **auto),
      launch(32, 4, auto),
      x('cpu_op', evaluate + 'torch::autograd::AccumulateGrad', 36, 2,
        **auto),
      launch(37, 5, auto),
      launch(40, 3, name='cudaMemsetAsync'),
      kernel('gather', 5, 4, 1),
      kernel('slice_bwd', 25, 6, 2),
      kernel('mm_bwd', 33, 1, 4),
      kernel('acc', 38, 1, 5),
      kernel('Memset', 45, 2, 3, cat='gpu_memset'),
      {'ph': 'i', 'name': 'marker', 'ts': 3},
  ]
  p = trace.parse(events, steps=1)
  by_name = {op.name: op for op in p.ops}
  assert by_name['gather'].range == 'recbench.pull'
  assert by_name['gather'].host_op == 'aten::index_select'
  assert by_name['slice_bwd'].range == 'backward:recbench.embed'
  assert by_name['mm_bwd'].range == 'backward:recbench.forward'
  assert by_name['acc'].range == trace.BACKWARD
  assert by_name['Memset'].range is None and by_name['Memset'].kind == \
      'memset'
  assert (p.start, p.end) == (0.0, 47.0)
  assert p.busy_us() == 14.0
