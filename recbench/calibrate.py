"""The readings the limits of `correct` are set from, at the cell's own
size, in one process (the benchmark's own runs never run this):

    python3 -m recbench.calibrate --workload <cell> [--first_seed N]
        [--seeds 12] [--control_seeds 3] [--fault_seeds 3] [--out FILE]

For each seed the port's first three steps are read as a run reads them
(harness.Session) and compared with the plain reference's: the lower
readings. On the first --control_seeds seeds the control: the port with
its towers in bfloat16 (train_config.compute_dtype), the nearest
precision below the configuration's float32, which the port has as a path
of its own. On the first --fault_seeds seeds each fault of faults.py
(state_unchanged reads 1 on every gradient and change by its
construction; its run gives the losses' readings). Beside the numbers
compared, each reading gives the gradient and change numbers against
each leaf's own norm (check.own_gaps, `own`) with the leaf that reads
widest. One JSON line a reading, then a summary by number: the port's
largest, the control's and each fault's smallest.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from recbench import check, faults, harness
from recbench.cell import load_cell


def reading(cell, seed, device, ref=None, **kw):
  """(numbers, reference readings, the gradient and change numbers
  against each leaf's own norm) of one Session against the reference."""
  s = harness.Session(cell, seed, device, batches=harness.CHECK_STEPS, **kw)
  prog = s.readings
  batches = s.close()
  del s
  if ref is None:
    ref = harness.reference_readings(cell, seed, batches, device)
  if device.type == 'cuda':
    torch.cuda.empty_cache()
  return check.gaps(prog, ref), ref, check.own_gaps(prog, ref)


def main(argv=None, device: str = 'cuda', shrink=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--workload', required=True)
  ap.add_argument('--first_seed', type=int, default=2 ** 31 + 101)
  ap.add_argument('--seeds', type=int, default=12)
  ap.add_argument('--control_seeds', type=int, default=3)
  ap.add_argument('--fault_seeds', type=int, default=3)
  ap.add_argument('--out', default='')
  args = ap.parse_args(argv)
  cell = load_cell(args.workload, shrink=shrink)
  dev = torch.device(device)
  if dev.type == 'cuda' and not torch.cuda.is_available():
    print('calibrate: torch.cuda.is_available() is False', file=sys.stderr)
    return 2
  harness.set_environment(cell)
  rows = []
  out = open(args.out, 'w') if args.out else None

  clock = [time.perf_counter()]

  def emit(kind, seed, result):
    numbers, _, own = result
    now = time.perf_counter()
    row = {'kind': kind, 'seed': seed, 'numbers': numbers, 'own': own,
           'seconds': now - clock[0]}
    clock[0] = now
    rows.append(row)
    text = json.dumps(row)
    print(text, flush=True)
    if out:
      out.write(text + '\n')
      out.flush()

  for i in range(args.seeds):
    seed = args.first_seed + 7919 * i
    result = reading(cell, seed, dev)
    ref = result[1]
    emit('port', seed, result)
    if i < args.control_seeds:
      emit('control_bf16', seed,
           reading(cell, seed, dev, ref, compute_dtype='bfloat16'))
    if i < args.fault_seeds:
      for name, fault in faults.FAULTS.items():
        emit(name, seed, reading(cell, seed, dev, ref, fault=fault))
  summary = {}
  names = list(rows[0]['numbers']) + ['own.' + k for k in rows[0]['own']]
  for name in names:
    by_kind = {}
    for r in rows:
      value = r['own'][name[4:]][0] if name.startswith('own.') else \
          r['numbers'][name]
      by_kind.setdefault(r['kind'], []).append(value)
    summary[name] = {'port_max': max(by_kind['port']),
                     **{k + '_min': min(v) for k, v in by_kind.items()
                        if k != 'port'}}
  text = json.dumps({'summary': summary, 'workload': cell.name})
  print(text)
  if out:
    out.write(text + '\n')
    out.close()
  return 0


if __name__ == '__main__':
  sys.exit(main())
