"""The benchmark's one command:

    python3 -m recbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up builds the cell's Trainer through the port's normal path, writes
the initial weights drawn on the card from --seed into it, makes the
traffic's batches on the card, runs the first three steps (read for
`correct`, harness.py) and a warm-up, all through Trainer.train_step. The
window then drives train_step for --seconds, cycling through the batches,
a CUDA event on the stream at each step's start, and ends at a
synchronize. With --trace 1 the same window is timed, then a stretch of
the workload's `trace_steps` steps runs under torch.profiler with the
layer ranges of trace.py. After the memory's peak is read and the port's
state freed, the plain reference trains from the same seed on the same
first batches, and `correct` says whether the port's readings lie within
the workload's limits of it.

The last line of standard output is one JSON object: correct, attempted
(the window's steps), failed (steps whose loss is not finite), metrics
(end_to_end with --trace 0, per_layer with --trace 1, as BENCHMARK.json
gives them for the cell), device, with --trace 1 breakdown, and last
`checks`, each number compared with its limit, which are also the last
lines of standard error. Without a CUDA card, with fewer cards than the
cell asks, or with jax, flax or the JAX package loaded, it exits non-zero
and prints no result.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import List, Optional  # noqa: E402

import torch  # noqa: E402

from recbench import check, harness, trace, traffic  # noqa: E402
from recbench.cell import REPO_DIR, Cell, load_cell  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'easyrec_tpu')


def forbidden_modules(names) -> List[str]:
  """Loaded modules whose top-level name (before the first dot) is one of
  FORBIDDEN, compared whole: easyrec_torch is not easyrec_tpu."""
  return sorted(n for n in names if n.split('.')[0] in FORBIDDEN)


@dataclasses.dataclass
class RunRecord:
  """What the metric readers read."""
  cell: Cell
  window: dict
  setup_s: float
  peak_bytes: int
  flops_per_example: float
  profile: Optional[trace.Profile] = None
  trace_counts: Optional[List[dict]] = None


class StepClock:
  """Step starts on the device's own clock: a CUDA event recorded on the
  stream (no sync), read after the window; the host clock on the CPU."""

  def __init__(self, device: torch.device):
    self.cuda = device.type == 'cuda'
    self.marks = []

  def mark(self) -> None:
    if self.cuda:
      ev = torch.cuda.Event(enable_timing=True)
      ev.record()
      self.marks.append(ev)
    else:
      self.marks.append(time.perf_counter())

  def step_ms(self) -> List[float]:
    """Each step's ms, from the marks with one more at the end."""
    if self.cuda:
      return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
    return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _sync(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize()


def card(device: torch.device) -> dict:
  if device.type != 'cuda':
    return {'platform': 'cpu', 'kind': 'cpu', 'count': 1}
  limit = ''
  try:
    limit = subprocess.run(
        ['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader',
         '-i', str(torch.cuda.current_device())],
        capture_output=True, text=True, timeout=30).stdout.strip()
  except (OSError, subprocess.SubprocessError):
    pass
  return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
          'count': 1, 'power_limit': limit}


def measure(cell: Cell, seed: int, seconds: float, traced: bool,
            device: torch.device, fault=None):
  """Set-up, window, traced stretch and reference of one run: (record,
  the numbers of check.gaps, the window's steps whose loss is not
  finite)."""
  phases = [('imports', time.perf_counter() - PROCESS_START)]
  session = harness.Session(cell, seed, device, fault=fault)
  phases += session.phases
  t = time.perf_counter()
  counts = [traffic.slot_counts(session.features, b)
            for b in session.batches]
  first = harness.CHECK_STEPS
  for i in range(int(cell.workload['warmup_steps'])):
    session.step(first + i)
  first += int(cell.workload['warmup_steps'])
  _sync(device)
  phases.append(('counts and warm-up', time.perf_counter() - t))
  setup_s = time.perf_counter() - PROCESS_START
  print('set-up %.3f s: %s' % (setup_s, ', '.join(
      '%s %.3f' % p for p in phases)), file=sys.stderr)

  clock, losses = StepClock(device), []
  t0 = time.perf_counter()
  deadline = t0 + seconds
  n = 0
  while n == 0 or time.perf_counter() < deadline:
    clock.mark()
    losses.append(session.step(first + n)['total_loss'])
    n += 1
  clock.mark()
  _sync(device)
  window = {'steps': n, 'seconds': time.perf_counter() - t0,
            'step_ms': clock.step_ms()}
  failed = int((~torch.isfinite(torch.stack(losses))).sum())
  first += n
  ms = sorted(window['step_ms'])
  print('window: %d steps in %.3f s; step ms min %.3f median %.3f max %.3f'
        % (n, window['seconds'], ms[0], ms[len(ms) // 2], ms[-1]),
        file=sys.stderr)

  profile = trace_counts = None
  if traced:
    steps = int(cell.workload['trace_steps'])
    profile = trace.profile_steps(session.trainer, session.batches, first,
                                  steps)
    trace_counts = [counts[(first + i) % len(counts)] for i in range(steps)]
  peak = torch.cuda.max_memory_allocated() if device.type == 'cuda' else 0
  record = RunRecord(cell=cell, window=window, setup_s=setup_s,
                     peak_bytes=peak,
                     flops_per_example=cell.reference().flops_per_example(
                         session.model),
                     profile=profile, trace_counts=trace_counts)
  prog = session.readings
  batches = session.close()
  del session, losses
  t = time.perf_counter()
  if device.type == 'cuda':
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
  ref = harness.reference_readings(cell, seed, batches, device)
  if device.type == 'cuda':
    print('reference: %.3f s, peak %d B, %d B of it held before it (the '
          'first batches)' % (time.perf_counter() - t,
                              torch.cuda.max_memory_allocated(), held),
          file=sys.stderr)
  return record, check.gaps(prog, ref), failed


def metrics(record: RunRecord, entries: List[dict]) -> dict:
  out = {}
  for m in entries:
    value = record.cell.metric_reader(m['name']).read(record)
    if value is not None:
      out[m['name']] = {'value': float(value), 'unit': m['unit']}
  return out


def main(argv=None, device: str = 'cuda', root: str = REPO_DIR,
         shrink: Optional[dict] = None, fault=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--workload', required=True)
  ap.add_argument('--seed', type=int, required=True)
  ap.add_argument('--seconds', type=float, required=True)
  ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)
  cell = load_cell(args.workload, root, shrink)
  dev = torch.device(device)
  if dev.type == 'cuda' and (not torch.cuda.is_available() or
                             torch.cuda.device_count() < cell.chips):
    print('recbench: the cell needs %d CUDA card(s); torch.cuda.'
          'is_available() is %s, torch.cuda.device_count() is %d'
          % (cell.chips, torch.cuda.is_available(),
             torch.cuda.device_count()), file=sys.stderr)
    return 2
  harness.set_environment(cell)
  record, numbers, failed = measure(cell, args.seed, args.seconds,
                                    bool(args.trace), dev, fault)
  loaded = forbidden_modules(sys.modules)
  if loaded:
    print('recbench: the run loaded %s' % ', '.join(loaded), file=sys.stderr)
    return 3
  correct, rows = check.verdict(numbers, cell.workload['limits'])
  device_info = card(dev)
  device_info['memory_peak_bytes'] = record.peak_bytes
  line = {'correct': bool(correct and failed == 0),
          'attempted': record.window['steps'], 'failed': failed,
          'metrics': metrics(record, cell.per_layer if args.trace
                             else cell.end_to_end),
          'device': device_info}
  if record.profile is not None:
    device_info['busy_s'] = record.profile.busy_us() / 1e6
    device_info['window_s'] = record.profile.window_us / 1e6
    line['breakdown'] = trace.breakdown(record.profile)
  line['checks'] = {name: {'value': value if math.isfinite(value)
                           else str(value), 'limit': limit}
                    for name, value, limit in rows}
  print('card: %s, power limit %s' % (device_info['kind'],
                                      device_info.get('power_limit', '')),
        file=sys.stderr)
  for name, value, limit in rows:
    print('%s %r limit %r' % (name, value, limit), file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(line))
  return 0


if __name__ == '__main__':
  sys.exit(main())
