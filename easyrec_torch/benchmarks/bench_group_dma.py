"""Whole-group RMW over a 5 GB packed table, on the card.

Counterpart of benchmarks/bench_pallas_group_dma.py: a physical table of
[G, 8, 384] f32 (G super-groups of 8 physical rows; each physical row = 8
logical rows x 48 combined columns), 98,304 unique sorted groups from
default_rng(0), and one in-place RMW g = g*0.999 + 0.001 of each listed
group through kernel K5 (ops/group_dma.py `group_rmw`). The table is
random from seed 0 (the JAX script's is zero, on which a*x drops out):
the correctness line holds one application byte for byte against the
plain version on a copy, over the whole table. Then it prints the time of
one application over REPS back to back.

Run (on the card unless --device cpu):

    python -m easyrec_torch.benchmarks.bench_group_dma
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from easyrec_torch.benchmarks.bench_packed_v2 import sync
from easyrec_torch.device import resolve_device
from easyrec_torch.ops.group_dma import (check_ids, group_rmw,
                                         group_rmw_plain)

G = 406_252            # ~26M logical rows / 64
W = 384
SLOTS = 98_304
REPS = 30


def main(argv=None):
  """Returns {'correct': bool, 'ms': ms an application, 'gb': GB moved an
  application}."""
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--device', default=None,
                 help="'cuda' (default) or 'cpu'")
  p.add_argument('--groups', type=int, default=G)
  p.add_argument('--slots', type=int, default=SLOTS)
  p.add_argument('--reps', type=int, default=REPS)
  args = p.parse_args(argv)
  dev = resolve_device(args.device)
  groups = args.groups
  gen = torch.Generator(device=dev).manual_seed(0)
  table = torch.randn((groups, 8, W), generator=gen, device=dev)
  rng = np.random.default_rng(0)
  sgids_np = np.sort(rng.choice(groups, args.slots, replace=False)
                     ).astype(np.int32)
  sgids = torch.from_numpy(sgids_np).to(dev)

  want = group_rmw_plain(table.clone(), sgids, 0.999, 0.001)
  group_rmw(table, sgids, 0.999, 0.001)
  check_ids(dev)
  # byte-equal to the plain version: listed groups a*x + b rounded as
  # two f32 ops, every other group unchanged
  ok = torch.equal(table.view(torch.int32), want.view(torch.int32))
  v = float(table[sgids_np[0], 0, 0])
  print('correct:', ok, v, flush=True)
  del want

  sync(table)
  t0 = time.perf_counter()
  for _ in range(args.reps):
    group_rmw(table, sgids, 0.999, 0.001)
  sync(table)
  ms = (time.perf_counter() - t0) / args.reps * 1e3
  gb = args.slots * (8 * W * 4 * 2 + 4) / 1e9
  print('group RMW (K5): %.2f ms/op (%d groups, %.2f GB moved)'
        % (ms, args.slots, gb), flush=True)
  del table
  return {'correct': ok, 'ms': ms, 'gb': gb}


if __name__ == '__main__':
  main()
