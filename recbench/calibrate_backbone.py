"""recbench.calibrate for a cell whose tables fill the card and whose model
is built by the backbone DSL (the DLRM-DCNv2's), in one process:

    python3 -m recbench.calibrate_backbone --workload <cell>
        [--first_seed N] [--seeds 12] [--control_seeds 3]
        [--fault_seeds 3] [--out FILE]

It runs recbench.calibrate with two things changed for the run:
  - each Session's close collects what the port's state leaves in
    reference cycles (a fault's wrapper of train_step holds the Trainer),
    so that the next seed's Trainer fits beside nothing of the last;
  - the fault state_unchanged saves and puts back the table rows that the
    step touches, in place of a whole copy of the tables, which does not
    fit beside them (49.5 GiB for the DLRM-DCNv2's).
calibrate's control (train_config.compute_dtype bfloat16) leaves a
backbone RankModel's towers in float32, so it reads as the port. On the
first --control_seeds seeds a second control follows: the plain reference
with its products in bfloat16 (torch.autocast around its loss) against
the same reference in float32, each reading with the verdict of the
cell's limits on it (run.py's check). Its JSON lines are appended to
calibrate's, then a summary of its smallest reading by number.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys

import torch

from easyrec_torch.ops import embedding as emb_ops
from recbench import calibrate, check, faults, harness, traffic
from recbench.cell import load_cell
from recbench.reference import common


def state_unchanged(trainer) -> None:
  """faults.state_unchanged with each table's rows that the step touches
  saved and put back: lazy Adam writes no other row, so the tables come
  back as they were."""
  step = trainer.train_step

  def train_step(batch):
    packs = emb_ops.pack_all_views(trainer.layout, batch)
    rows = {}
    for key, table in trainer.tables.items():
      views = (key,) + tuple(p + key for p in emb_ops.VIEWS)
      ids = torch.unique(torch.cat([packs[v].reshape(-1) for v in views
                                    if v in packs]).to(torch.int64))
      rows[key] = (ids, table[ids].clone())
    opt = trainer.dense_opt
    saved = {'params': [p.detach().clone() for p in opt.params],
             'mu': [t.clone() for t in opt.mu],
             'nu': [t.clone() for t in opt.nu],
             'count': opt.count.clone(), 'step': trainer.step.clone()}
    out = step(batch)
    with torch.no_grad():
      for key, (ids, kept) in rows.items():
        trainer.tables[key][ids] = kept
      for name in ('params', 'mu', 'nu'):
        for dst, src in zip(getattr(opt, name), saved[name]):
          dst.copy_(src)
    opt.count = saved['count']
    trainer.step = saved['step']
    return out

  trainer.train_step = train_step


@contextlib.contextmanager
def at_size():
  """harness.Session.close collecting, and faults.FAULTS' state_unchanged
  this module's, until the block ends."""
  close = harness.Session.close
  fault = faults.FAULTS['state_unchanged']

  def collecting_close(self):
    device = self.device
    kept = close(self)
    gc.collect()
    if device.type == 'cuda':
      torch.cuda.empty_cache()
    return kept

  harness.Session.close = collecting_close
  faults.FAULTS['state_unchanged'] = state_unchanged
  try:
    yield
  finally:
    harness.Session.close = close
    faults.FAULTS['state_unchanged'] = fault


def reference_bf16(cell, seed, device):
  """(numbers, own numbers) of the plain reference with its products in
  bfloat16 against the same reference in float32, on the seed's first
  batches."""
  feats = harness.model_description(cell)['features']
  batches = traffic.make_batches(feats, cell.traffic, seed, device,
                                 harness.CHECK_STEPS)
  ref = harness.reference_readings(cell, seed, batches, device)
  loss = common.Reference.total_loss

  def total_loss(self, batch):
    with torch.autocast(device_type=device.type, dtype=torch.bfloat16):
      return loss(self, batch)

  common.Reference.total_loss = total_loss
  try:
    ctl = harness.reference_readings(cell, seed, batches, device)
  finally:
    common.Reference.total_loss = loss
  return check.gaps(ctl, ref), check.own_gaps(ctl, ref)


def main(argv=None, device: str = 'cuda', shrink=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--workload', required=True)
  ap.add_argument('--first_seed', type=int, default=2 ** 31 + 101)
  ap.add_argument('--control_seeds', type=int, default=3)
  ap.add_argument('--out', default='')
  args, _ = ap.parse_known_args(argv)
  with at_size():
    rc = calibrate.main(argv, device=device, shrink=shrink)
  if rc:
    return rc
  cell = load_cell(args.workload, shrink=shrink)
  dev = torch.device(device)
  out = open(args.out, 'a') if args.out else None

  def emit(line):
    text = json.dumps(line)
    print(text, flush=True)
    if out:
      out.write(text + '\n')
      out.flush()

  least = {}
  for i in range(args.control_seeds):
    seed = args.first_seed + 7919 * i
    numbers, own = reference_bf16(cell, seed, dev)
    emit({'kind': 'reference_bf16', 'seed': seed, 'numbers': numbers,
          'own': own,
          'correct': check.verdict(numbers, cell.workload['limits'])[0]})
    for k, v in numbers.items():
      least[k] = min(v, least.get(k, v))
    if dev.type == 'cuda':
      torch.cuda.empty_cache()
  emit({'summary': {k: {'reference_bf16_min': v} for k, v in least.items()},
        'workload': cell.name})
  if out:
    out.close()
  return 0


if __name__ == '__main__':
  sys.exit(main())
