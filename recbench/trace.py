"""The traced stretch: a few train steps under torch.profiler, with ranges
of the harness's own around the calls into the port's layers, read back
from the profiler's trace as device operations, each attributed to the
range it was launched from.

The ranges wrap, from outside the port, for the stretch only:
  recbench.pack           easyrec_torch.ops.embedding.pack_all_views
  recbench.pull           Trainer.pull
  recbench.forward        the model's forward
  recbench.embed          the model's ctx.input_layer feature_embedding
                          and sequence_embedding (the pulled rows' slices
                          and combiners, inside the forward)
  recbench.loss           Trainer._regularised_loss (the model's loss)
  recbench.dense_opt      the dense optimizer's step
  recbench.sparse_update  easyrec_torch.ops.packed_table.apply_packed_update
A launch inside one of the autograd engine's
`autograd::engine::evaluate_function` events is backward: it goes to
`backward:<range>`, the range of the forward operation that recorded the
engine's node (the two share the profiler's sequence number), or to
`backward` where no forward operation in the stretch holds that number
(a leaf's AccumulateGrad). A call that no longer exists under its name is
not wrapped, and its metric reads nothing.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

BACKWARD = 'backward'
EVALUATE = 'autograd::engine::evaluate_function'
SEQ = 'Sequence number'
STEP = 'recbench.step'
DEVICE_CATS = {'kernel': 'kernel', 'gpu_memcpy': 'memcpy',
               'gpu_memset': 'memset'}
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')


def backward_of(name: str) -> str:
  """The range of the backward of what range `name` recorded."""
  return '%s:%s' % (BACKWARD, name)


@dataclasses.dataclass
class DeviceOp:
  name: str
  start: float          # us, the trace's clock
  dur: float            # us
  kind: str             # kernel | memcpy | memset
  range: Optional[str]  # the harness range it was launched from
  host_op: str = ''     # the host operator that launched it


@dataclasses.dataclass
class Profile:
  """`steps` train steps from `start` (the first step's host range) to
  `end` (the last device operation's end), in us."""
  steps: int
  start: float
  end: float
  ops: List[DeviceOp]

  @property
  def window_us(self) -> float:
    return self.end - self.start

  def busy_us(self) -> float:
    """Time covered by some device operation: the union of their
    intervals, not their sum."""
    busy, cur_lo, cur_hi = 0.0, None, None
    for op in sorted(self.ops, key=lambda o: o.start):
      lo, hi = max(op.start, self.start), min(op.start + op.dur, self.end)
      if hi <= lo:
        continue
      if cur_hi is None or lo > cur_hi:
        if cur_hi is not None:
          busy += cur_hi - cur_lo
        cur_lo, cur_hi = lo, hi
      else:
        cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
      busy += cur_hi - cur_lo
    return busy

  def device_us(self, ranges) -> float:
    """Summed device time of the operations launched from `ranges` (one
    stream: they do not overlap)."""
    return sum(op.dur for op in self.ops if op.range in ranges)

  def has(self, ranges) -> bool:
    return any(op.range in ranges for op in self.ops)

  def idle_gaps(self) -> List[Tuple[str, float]]:
    """Device idle time by what was launched next (range: host operator),
    summed, longest first."""
    out = collections.Counter()
    edge = self.start
    for op in sorted(self.ops, key=lambda o: o.start):
      if op.start > edge:
        out['%s: %s' % (op.range or 'outside the ranges',
                        op.host_op or op.name[:60])] += op.start - edge
      edge = max(edge, op.start + op.dur)
    return out.most_common()

  def top_ops(self) -> List[Tuple[str, float]]:
    out = collections.Counter()
    for op in self.ops:
      out['%s: %s' % (op.range or 'outside the ranges', op.name[:90])] += \
          op.dur
    return out.most_common()


def _patch(obj, attr: str, name: str, undo: list) -> None:
  """Wrap obj.attr in a profiler range `name` until undo runs; a missing
  attribute is left alone."""
  if not hasattr(obj, attr):
    return
  orig = getattr(obj, attr)
  own = attr in vars(obj)

  @functools.wraps(orig)
  def wrapped(*args, **kwargs):
    with torch.profiler.record_function(name):
      return orig(*args, **kwargs)

  setattr(obj, attr, wrapped)
  undo.append((obj, attr, orig if own else None))


@contextlib.contextmanager
def layer_ranges(trainer):
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.ops import packed_table as pt
  undo: list = []
  _patch(emb_ops, 'pack_all_views', 'recbench.pack', undo)
  _patch(trainer, 'pull', 'recbench.pull', undo)
  _patch(trainer.model, 'forward', 'recbench.forward', undo)
  layer = getattr(getattr(trainer.model, 'ctx', None), 'input_layer', None)
  if layer is not None:
    _patch(layer, 'feature_embedding', 'recbench.embed', undo)
    _patch(layer, 'sequence_embedding', 'recbench.embed', undo)
  _patch(trainer, '_regularised_loss', 'recbench.loss', undo)
  _patch(trainer.dense_opt, 'step', 'recbench.dense_opt', undo)
  _patch(pt, 'apply_packed_update', 'recbench.sparse_update', undo)
  try:
    yield
  finally:
    for obj, attr, orig in reversed(undo):
      if orig is None:
        delattr(obj, attr)
      else:
        setattr(obj, attr, orig)


def profile_steps(trainer, batches, first: int, steps: int) -> Profile:
  """Run `steps` train steps on batches[first:] (cycling) under the
  profiler with the layer ranges; the parsed trace (on the CPU, with no
  device operations)."""
  from torch.profiler import ProfilerActivity, profile, record_function
  cuda = trainer.device.type == 'cuda'
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
  sync()
  with layer_ranges(trainer), profile(activities=activities) as prof:
    for i in range(steps):
      with record_function(STEP):
        trainer.train_step(batches[(first + i) % len(batches)])
    sync()
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f)['traceEvents']
  return parse(events, steps)


class _Intervals:
  """Host intervals of one thread, for the innermost one holding a time."""

  def __init__(self, items):
    self.items = sorted(items, key=lambda it: (it[0], it[1]))
    self.starts = [it[0] for it in self.items]

  def find(self, t: float):
    """The (lo, hi, name) holding t that began last, or None."""
    i = bisect.bisect_right(self.starts, t) - 1
    while i >= 0:
      if self.items[i][1] >= t:
        return self.items[i]
      i -= 1
    return None

  def innermost(self, t: float):
    found = self.find(t)
    return None if found is None else found[2]


def parse(events: List[dict], steps: int) -> Profile:
  """A chrome trace of torch.profiler -> Profile: each device operation
  with the harness range, or the backward of one, that its launch lies
  in."""
  launches, ops = {}, []
  ranges = collections.defaultdict(list)
  autograd = collections.defaultdict(list)
  cpu_ops = collections.defaultdict(list)
  numbered = []
  step_starts = []
  for e in events:
    if e.get('ph') != 'X':
      continue
    cat, args = e.get('cat', ''), e.get('args', {})
    thread = (e.get('pid'), e.get('tid'))
    lo = float(e['ts'])
    hi = lo + float(e.get('dur', 0.0))
    if cat in DEVICE_CATS:
      ops.append((e, DEVICE_CATS[cat]))
    elif cat in LAUNCH_CATS and 'correlation' in args:
      launches[args['correlation']] = (thread, lo)
    elif cat == 'user_annotation' and e['name'].startswith('recbench.'):
      if e['name'] == STEP:
        step_starts.append(lo)
      else:
        ranges[thread].append((lo, hi, e['name']))
    elif cat == 'cpu_op':
      if e['name'].startswith(EVALUATE):
        autograd[thread].append((lo, hi, args.get(SEQ)))
      elif SEQ in args:
        numbered.append((lo, thread, args[SEQ]))
      cpu_ops[thread].append((lo, hi, e['name']))
  ranges = {k: _Intervals(v) for k, v in ranges.items()}
  autograd = {k: _Intervals(v) for k, v in autograd.items()}
  cpu_ops = {k: _Intervals(v) for k, v in cpu_ops.items()}
  # The forward operation that recorded a node is the last one, in time,
  # to hold its sequence number outside the engine: the number moves on
  # once a node is made.
  recorded = {}
  for t, thread, seq in sorted(numbered, key=lambda n: n[0]):
    if thread in autograd and autograd[thread].find(t) is not None:
      continue            # a node's own event, inside the engine
    rng = ranges[thread].innermost(t) if thread in ranges else None
    recorded[seq] = rng
  out = []
  for e, kind in ops:
    launch = launches.get(e.get('args', {}).get('correlation'))
    rng = host = None
    if launch is not None:
      thread, t = launch
      if thread in ranges:
        rng = ranges[thread].innermost(t)
      if rng is None and thread in autograd:
        node = autograd[thread].find(t)
        if node is not None:
          fwd = recorded.get(node[2])
          rng = backward_of(fwd) if fwd else BACKWARD
      if thread in cpu_ops:
        host = cpu_ops[thread].innermost(t)
    out.append(DeviceOp(name=e['name'], start=float(e['ts']),
                        dur=float(e.get('dur', 0.0)), kind=kind, range=rng,
                        host_op=host or ''))
  start = min(step_starts) if step_starts else \
      min((o.start for o in out), default=0.0)
  end = max((o.start + o.dur for o in out), default=start)
  return Profile(steps=steps, start=start, end=end, ops=out)


def breakdown(profile: Profile, top: int = 10) -> Dict[str, list]:
  """The result line's breakdown: the device operations that took most
  time and the longest idle gaps, in seconds over the traced stretch."""
  return {'device_ops': [[n, us / 1e6] for n, us in
                         profile.top_ops()[:top]],
          'idle_gaps': [[n, us / 1e6] for n, us in
                        profile.idle_gaps()[:top]]}
