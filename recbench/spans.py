"""The port's own spans (easyrec_torch/utils/spans.py: easyrec.step,
easyrec.pack, ...) read back from a torch.profiler chrome trace.

parse() (trace.parse_spans, which trace.parse also runs over the traced
stretch of every run) attributes each device operation as trace.py
attributes it to the harness's ranges: to the innermost program span its launch lies in, or,
for a launch inside the autograd engine, to `backward:<span>`, the span
of the forward operation that recorded the node (the profiler's sequence
number), `backward` where none did. It also collects the synchronizing
CUDA calls (SYNC_CALLS), each with its thread, its span and the host
operator it ran under. Over the parsed trace:

  the metrics (METRICS), a step of the traced stretch:
    host_syncs_per_step    synchronizing calls inside easyrec.step
    host_issue_ms          host ms inside easyrec.step on the thread that
                           runs it, less its ms inside those calls
    step_idle_ms           device idle ms inside easyrec.step: the card
                           waiting on the port's own host code
    sparse_sort_ms         device ms of easyrec.sparse_update.sort
                           (the reader of BENCHMARK.json's sparse_sort_ms
                           is its twin)
    embedding_ms           easyrec.pack, easyrec.pull, easyrec.embed,
                           easyrec.embed.split and their backward
                           (pack_pull_ms's twin)
    dense_model_ms         easyrec.forward outside easyrec.embed,
                           easyrec.loss, and every backward but the
                           embedding's (dense_fwd_bwd_ms's twin)
    dense_optimizer_ms     easyrec.dense_opt (dense_opt_ms's twin)
    sparse_update_hbm_pct  counts.py's bytes over the card's HBM bandwidth
                           over easyrec.sparse_update's device time
                           (sparse_update_roofline's twin)
  breakdown():
    spans         each span's host ms, self device ms, launches and syncs
                  a step (and each backward:<span>'s device ms, launches)
    idle_by_span  each device idle interval split over the innermost
                  spans the step's thread was in, ms a step;
                  `between steps` where it was in none
    syncs         each synchronizing call a step, by span and host op

    python3 -m recbench.spans --workload <cell> --seed <n>

runs the cell's set-up and warm-up as recbench.run does, then its traced
stretch under the harness's ranges (trace.record_events) with the port's
spans on, and prints one JSON line: the harness's per-layer metrics read
by their readers from trace.parse of that trace, the metrics above from
the same trace, and the breakdown.

A metric of BENCHMARK.json reads the spans of a run's traced stretch
through trace.span_ms: trace.parse keeps the spans' parse of the trace
on the Profile (Profile.spans), and a reader file is one line,

    from recbench.trace import span_reader; read = span_reader('easyrec.x')
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
import time
import types
from typing import Dict, List, Optional, Tuple

import torch

from recbench import counts, harness, peaks, trace, traffic
from recbench.cell import REPO_DIR, load_cell
from recbench.trace import (BACKWARD, SYNC_CALLS, Spans, Sync,  # noqa: F401
                            backward_of, span_ms, span_reader)

PREFIX = trace.SPAN_PREFIX
STEP = trace.SPAN_STEP
parse = trace.parse_spans
SORT = 'easyrec.sparse_update.sort'
UPDATE = ('easyrec.sparse_update', SORT)
EMBEDDING = ('easyrec.pack', 'easyrec.pull', 'easyrec.embed',
             'easyrec.embed.split')
DENSE = ('easyrec.forward', 'easyrec.loss')
BETWEEN = 'between steps'
def _overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]
             ) -> float:
  """Length of the intersection of two sorted lists of disjoint
  intervals."""
  i = j = 0
  total = 0.0
  while i < len(a) and j < len(b):
    lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
    if hi > lo:
      total += hi - lo
    if a[i][1] < b[j][1]:
      i += 1
    else:
      j += 1
  return total


def step_syncs(s: Spans) -> List[Sync]:
  """The synchronizing calls that start inside an easyrec.step."""
  return [c for c in s.syncs if s.in_step(c.start)]


# -- the metrics: None where the trace holds none of the metric's spans,
# and a device metric None where it holds no device operation ----------

def host_syncs_per_step(s: Spans, run=None) -> Optional[float]:
  if not s.has(STEP):
    return None
  return len(step_syncs(s)) / s.steps


def host_issue_ms(s: Spans, run=None) -> Optional[float]:
  if not s.has(STEP):
    return None
  host = sum(hi - lo for lo, hi in s.step_intervals())
  waits = sum(c.dur for c in step_syncs(s) if c.thread == s.step_thread)
  return (host - waits) / 1e3 / s.steps


def step_idle_ms(s: Spans, run=None) -> Optional[float]:
  if not s.has(STEP) or not s.ops:
    return None
  return _overlap(s.idle_intervals(), s.step_intervals()) / 1e3 / s.steps


def sparse_sort_ms(s: Spans, run=None) -> Optional[float]:
  return span_ms(s, (SORT,))


def embedding_ms(s: Spans, run=None) -> Optional[float]:
  if not s.ops or not (s.has('easyrec.pack') and s.has('easyrec.pull')):
    return None
  return s.device_ms(EMBEDDING + tuple(backward_of(r) for r in EMBEDDING))


def dense_model_ms(s: Spans, run=None) -> Optional[float]:
  if not s.ops or not s.has('easyrec.forward'):
    return None
  skip = {backward_of(r) for r in EMBEDDING}
  ranges = set(DENSE) | {op.range for op in s.ops if op.range and
                         op.range.startswith(BACKWARD) and
                         op.range not in skip}
  return s.device_ms(ranges)


def dense_optimizer_ms(s: Spans, run=None) -> Optional[float]:
  if not s.ops or not s.has('easyrec.dense_opt'):
    return None
  return s.device_ms(('easyrec.dense_opt',))


def sparse_update_hbm_pct(s: Spans, run) -> Optional[float]:
  ms = s.device_ms(UPDATE) if s.has(UPDATE[0]) else 0.0
  if not ms:
    return None
  layout = run.cell.config['layout']
  need = sum(counts.sparse_update_bytes(c['slot_bytes'], c['rows'], layout)
             for c in run.trace_counts)
  return 100.0 * need / peaks.HBM_BYTES_PER_S * 1e3 / (ms * s.steps)


METRICS = {f.__name__: f for f in (
    host_syncs_per_step, host_issue_ms, step_idle_ms, sparse_sort_ms,
    embedding_ms, dense_model_ms, dense_optimizer_ms, sparse_update_hbm_pct)}
# each program-side metric beside the harness-range metric it twins
TWINS = {'embedding_ms': 'pack_pull_ms', 'dense_model_ms': 'dense_fwd_bwd_ms',
         'dense_optimizer_ms': 'dense_opt_ms',
         'sparse_update_hbm_pct': 'sparse_update_roofline',
         'sparse_sort_ms': 'sparse_sort_ms'}


# -- the breakdown -------------------------------------------------------

def span_table(s: Spans) -> Dict[str, dict]:
  """{span: host_ms, device_ms (self), launches, syncs} a step, and
  {backward:<span>: device_ms, launches}, by device ms."""
  out = collections.defaultdict(lambda: {'host_ms': None, 'device_ms': 0.0,
                                         'launches': 0.0, 'syncs': 0.0})
  for th, lo, hi, name in s.spans:
    row = out[name]
    row['host_ms'] = (row['host_ms'] or 0.0) + (hi - lo) / 1e3 / s.steps
  for op in s.ops:
    if op.range is not None:
      out[op.range]['device_ms'] += op.dur / 1e3 / s.steps
      out[op.range]['launches'] += (op.kind == 'kernel') / s.steps
  for c in s.syncs:
    out[c.span or BETWEEN]['syncs'] += 1.0 / s.steps
  return dict(sorted(out.items(), key=lambda kv: -kv[1]['device_ms']))


def idle_by_span(s: Spans) -> Dict[str, float]:
  """Device idle ms a step by the innermost span the step's thread was in
  during it, longest first."""
  mine = [(lo, hi, name) for th, lo, hi, name in s.spans
          if th == s.step_thread]
  where = trace._Intervals(mine)
  edges = sorted({t for lo, hi, _ in mine for t in (lo, hi)})
  out = collections.Counter()
  for lo, hi in s.idle_intervals():
    cuts = [lo] + edges[bisect.bisect_right(edges, lo):
                        bisect.bisect_left(edges, hi)] + [hi]
    for a, b in zip(cuts, cuts[1:]):
      if b > a:
        out[where.innermost((a + b) / 2) or BETWEEN] += (b - a) / 1e3 / \
            s.steps
  return dict(out.most_common())


def sync_table(s: Spans) -> List[list]:
  """[call, span, host op, count a step] of every synchronizing call."""
  c = collections.Counter((x.name, x.span or BETWEEN, x.host_op)
                          for x in s.syncs)
  return [list(k) + [n / s.steps] for k, n in c.most_common()]


def breakdown(s: Spans) -> dict:
  return {'spans': span_table(s), 'idle_by_span': idle_by_span(s),
          'syncs': sync_table(s)}


def metrics(s: Spans, run) -> Dict[str, float]:
  out = {}
  for name, fn in METRICS.items():
    value = fn(s, run)
    if value is not None:
      out[name] = float(value)
  return out


# -- the tool ------------------------------------------------------------

def span_off_ns(n: int = 200000) -> Optional[float]:
  """ns a span costs with no profiler active (the port's spans module;
  None where the port has none)."""
  try:
    from easyrec_torch.utils.spans import span
  except ImportError:
    return None
  t = time.perf_counter()
  for _ in range(n):
    with span('easyrec.step'):
      pass
  return (time.perf_counter() - t) / n * 1e9


def main(argv=None, device: str = 'cuda', root: str = REPO_DIR,
         shrink: Optional[dict] = None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--workload', required=True)
  ap.add_argument('--seed', type=int, required=True)
  ap.add_argument('--save', default='',
                  help='write the chrome trace here (gzip)')
  args = ap.parse_args(argv)
  cell = load_cell(args.workload, root, shrink)
  dev = torch.device(device)
  harness.set_environment(cell)
  session = harness.Session(cell, args.seed, dev)
  first = harness.CHECK_STEPS
  for i in range(int(cell.workload['warmup_steps'])):
    session.step(first + i)
  first += int(cell.workload['warmup_steps'])
  steps = int(cell.workload['trace_steps'])
  events = trace.record_events(session.trainer, session.batches, first,
                               steps)
  run = types.SimpleNamespace(
      cell=cell, profile=trace.parse(events, steps), window=None,
      trace_counts=[traffic.slot_counts(
          session.features, session.batches[(first + i) %
                                            len(session.batches)])
                    for i in range(steps)])
  harness_metrics = {}
  for m in cell.per_layer:
    value = cell.metric_reader(m['name']).read(run)
    if value is not None:
      harness_metrics[m['name']] = float(value)
  s = run.profile.spans
  program = metrics(s, run)
  line = {'harness': harness_metrics, 'program': program,
          'twins': {p: [program.get(p), harness_metrics.get(h)]
                    for p, h in TWINS.items()},
          'traced_step_ms': run.profile.window_us / 1e3 / steps,
          'spans_per_step': len(s.spans) / steps,
          'span_off_ns': span_off_ns(),
          'breakdown': breakdown(s)}
  if args.save:
    import gzip
    os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
    with gzip.open(args.save, 'wt') as f:
      json.dump({'traceEvents': events}, f)
  print(json.dumps(line))
  return 0


if __name__ == '__main__':
  sys.exit(main())
