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
The parsed stretch also carries the port's own `easyrec.*` spans
(parse_spans, Profile.spans), so a metric's reader may read a span of
the program by name (span_ms, span_reader); recbench/spans.py reads
more from them.
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
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

BACKWARD = 'backward'
EVALUATE = 'autograd::engine::evaluate_function'
SEQ = 'Sequence number'
STEP = 'recbench.step'
DEVICE_CATS = {'kernel': 'kernel', 'gpu_memcpy': 'memcpy',
               'gpu_memset': 'memset'}
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
# the port's own spans (easyrec_torch/utils/spans.py)
SPAN_PREFIX = 'easyrec.'
SPAN_STEP = 'easyrec.step'


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
  `end` (the last device operation's end), in us; `spans`, the same
  trace read by the port's spans (parse_spans)."""
  steps: int
  start: float
  end: float
  ops: List[DeviceOp]
  spans: Optional['Spans'] = None

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


def record_events(trainer, batches, first: int, steps: int) -> List[dict]:
  """The chrome trace's events of `steps` train steps on batches[first:]
  (cycling) under torch.profiler, inside the layer ranges (on the CPU,
  with no device operations)."""
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
      return json.load(f)['traceEvents']


def profile_steps(trainer, batches, first: int, steps: int) -> Profile:
  """The parsed trace of record_events."""
  return parse(record_events(trainer, batches, first, steps), steps)


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
  in; and the trace's reading by the port's spans."""
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
  return Profile(steps=steps, start=start, end=end, ops=out,
                 spans=parse_spans(events, steps))


# -- the port's own spans, read from the same trace ------------------

# CUDA calls that block the host until the device catches up
SYNC_CALLS = frozenset((
    'cudaStreamSynchronize', 'cudaDeviceSynchronize', 'cudaEventSynchronize',
    'cudaMemcpy', 'cuStreamSynchronize', 'cuCtxSynchronize',
    'cuEventSynchronize', 'cuMemcpyDtoH_v2', 'cuMemcpyHtoD_v2'))


@dataclasses.dataclass
class Sync:
  name: str
  thread: tuple
  start: float          # us, the trace's clock
  dur: float
  span: Optional[str]   # as a launch's range
  host_op: str


@dataclasses.dataclass
class Spans:
  """The parsed trace: `ops` with `range` the program span (or
  backward:<span>) of their launch; `spans` every easyrec.* interval
  (thread, lo, hi, name); the stretch from the first easyrec.step's start
  to the last device operation's end."""
  steps: int
  start: float
  end: float
  ops: List[DeviceOp]
  spans: List[Tuple[tuple, float, float, str]]
  syncs: List[Sync]
  step_thread: Optional[tuple]

  def has(self, name: str) -> bool:
    return any(s[3] == name for s in self.spans)

  def device_ms(self, ranges) -> float:
    """Device ms a step of the operations launched from `ranges`."""
    return sum(op.dur for op in self.ops if op.range in ranges) / 1e3 / \
        self.steps

  def step_intervals(self) -> List[Tuple[float, float]]:
    return sorted((lo, hi) for th, lo, hi, name in self.spans
                  if name == SPAN_STEP and th == self.step_thread)

  def idle_intervals(self) -> List[Tuple[float, float]]:
    """The device's idle intervals inside the stretch."""
    out, edge = [], self.start
    for op in sorted(self.ops, key=lambda o: o.start):
      if op.start > edge and op.start > self.start:
        out.append((edge, min(op.start, self.end)))
      edge = max(edge, op.start + op.dur)
    if edge < self.end:
      out.append((edge, self.end))
    return [(lo, hi) for lo, hi in out if hi > lo]

  def in_step(self, t: float) -> bool:
    return any(lo <= t <= hi for lo, hi in self.step_intervals())


def parse_spans(events: List[dict], steps: int) -> Spans:
  """A chrome trace of torch.profiler -> Spans: each device operation with
  the program span (or backward:<span>) of its launch, attributed as
  parse attributes the harness's ranges."""
  launches, device = {}, []
  spans = collections.defaultdict(list)
  autograd = collections.defaultdict(list)
  cpu_ops = collections.defaultdict(list)
  numbered, calls = [], []
  for e in events:
    if e.get('ph') != 'X':
      continue
    cat, args = e.get('cat', ''), e.get('args', {})
    thread = (e.get('pid'), e.get('tid'))
    lo = float(e['ts'])
    hi = lo + float(e.get('dur', 0.0))
    if cat in DEVICE_CATS:
      device.append((e, DEVICE_CATS[cat]))
    elif cat in LAUNCH_CATS:
      if 'correlation' in args:
        launches[args['correlation']] = (thread, lo)
      if e['name'] in SYNC_CALLS:
        calls.append((e['name'], thread, lo, hi - lo))
    elif cat == 'user_annotation' and e['name'].startswith(SPAN_PREFIX):
      spans[thread].append((lo, hi, e['name']))
    elif cat == 'cpu_op':
      if e['name'].startswith(EVALUATE):
        autograd[thread].append((lo, hi, args.get(SEQ)))
      elif SEQ in args:
        numbered.append((lo, thread, args[SEQ]))
      cpu_ops[thread].append((lo, hi, e['name']))
  flat = [(th, lo, hi, name) for th, items in spans.items()
          for lo, hi, name in items]
  step_counts = collections.Counter(th for th, _, _, name in flat
                                    if name == SPAN_STEP)
  step_thread = step_counts.most_common(1)[0][0] if step_counts else None
  spans = {k: _Intervals(v) for k, v in spans.items()}
  autograd = {k: _Intervals(v) for k, v in autograd.items()}
  cpu_ops = {k: _Intervals(v) for k, v in cpu_ops.items()}
  recorded = {}
  for t, thread, seq in sorted(numbered, key=lambda n: n[0]):
    if thread in autograd and autograd[thread].find(t) is not None:
      continue            # a node's own event, inside the engine
    recorded[seq] = spans[thread].innermost(t) if thread in spans else None

  def attribute(thread, t) -> Optional[str]:
    """The span of a call at t on `thread`: backward:<span> inside a node
    of the autograd engine that began inside the innermost span."""
    inner = spans[thread].find(t) if thread in spans else None
    node = autograd[thread].find(t) if thread in autograd else None
    if node is not None and (inner is None or node[0] >= inner[0]):
      fwd = recorded.get(node[2])
      return backward_of(fwd) if fwd else BACKWARD
    return inner[2] if inner is not None else None

  def host_op(thread, t) -> str:
    return (cpu_ops[thread].innermost(t) if thread in cpu_ops else None) or ''

  ops = []
  for e, kind in device:
    launch = launches.get(e.get('args', {}).get('correlation'))
    rng = host = None
    if launch is not None:
      rng, host = attribute(*launch), host_op(*launch)
    ops.append(DeviceOp(name=e['name'], start=float(e['ts']),
                              dur=float(e.get('dur', 0.0)), kind=kind,
                              range=rng, host_op=host or ''))
  syncs = [Sync(name=n, thread=th, start=t, dur=d, span=attribute(th, t),
                host_op=host_op(th, t)) for n, th, t, d in calls]
  starts = [lo for th, lo, hi, name in flat if name == SPAN_STEP]
  start = min(starts) if starts else \
      min((o.start for o in ops), default=0.0)
  end = max((o.start + o.dur for o in ops), default=start)
  return Spans(steps=steps, start=start, end=end, ops=ops, spans=flat,
               syncs=syncs, step_thread=step_thread)


def span_ms(s: Optional[Spans], names: Iterable[str]) -> Optional[float]:
  """Device ms a step of the operations launched inside the spans `names`
  and in the backward of what they recorded; None without a parsed trace,
  where it holds none of the spans, or no device operation."""
  names = tuple(names)
  if s is None or not s.ops or not any(s.has(n) for n in names):
    return None
  return s.device_ms(names + tuple(backward_of(n) for n in names))


def span_reader(*names: str) -> Callable:
  """A metric's `read(run)`: span_ms of `names` over the run's traced
  stretch (run.profile.spans)."""
  def read(run):
    return span_ms(run.profile.spans if run.profile is not None else None,
                   names)
  return read



def breakdown(profile: Profile, top: int = 10) -> Dict[str, list]:
  """The result line's breakdown: the device operations that took most
  time and the longest idle gaps, in seconds over the traced stretch."""
  return {'device_ops': [[n, us / 1e6] for n, us in
                         profile.top_ops()[:top]],
          'idle_gaps': [[n, us / 1e6] for n, us in
                        profile.idle_gaps()[:top]]}
