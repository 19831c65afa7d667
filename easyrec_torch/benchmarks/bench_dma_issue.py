"""Launch-shape microbenchmark of the whole-group RMW kernel K5, on the
card.

Counterpart of benchmarks/bench_dma_issue.py. That script compares ways a
TPU core issues and waits on its per-group DMAs (loop unrolling, bulk
semaphore waits, chunk size, sub-tiled math). Those choices have no
counterpart on Hopper, where thousands of threads keep loads in flight
without an issue loop. The variants here are K5's own launch shapes
instead: threads a group, groups a block, and whether the slots are
padded with scratch-group slots to a chunk (as page_ids pads the TPU's id
pages). Every variant RMWs the same group set of the same [GROUPS, 8,
384] f32 table, random from seed 0, with g = g*0.999 - 0.001; each is
held byte for byte against the plain version on a copy (the scratch
group, whose pad slots race, excluded), then timed.

Run (on the card unless --device cpu):

    python -m easyrec_torch.benchmarks.bench_dma_issue
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

ROWS = 26_000_000
W = 384                      # combined adam width for dim 16
GROUP_ROWS = 64
GROUPS = ROWS // GROUP_ROWS + 2
SCRATCH_GID = GROUPS - 1
N = 4096 * 26                # group slots (dedup-padded)
SLOTS = 98_304               # unique groups listed

# (name, threads a group, groups a block, scratch-pad the slots or not):
# I pads to N slots at the full shape (8,192 scratch slots), to the same
# share at any other
VARIANTS = [
    ('A: 64 threads x 4 groups (default)', 64, 4, False),
    ('B: 32 threads x 8 groups', 32, 8, False),
    ('C: 128 threads x 2 groups', 128, 2, False),
    ('D: 256 threads x 1 group', 256, 1, False),
    ('E: 512 threads x 1 group', 512, 1, False),
    ('F: 1024 threads x 1 group', 1024, 1, False),
    ('G: 64 threads x 1 group', 64, 1, False),
    ('H: 64 threads x 16 groups', 64, 16, False),
    ('I: default, scratch-padded to N', 64, 4, True),
]


def make_kernel(threads: int, per_block: int):
  """K5 at one launch shape: run(gids, table3) applies
  g = g*0.999 - 0.001 to every listed group in place."""
  def run(gids, table3):
    return group_rmw(table3, gids, 0.999, -0.001, threads=threads,
                     per_block=per_block)
  return run


def page_ids(ugids: np.ndarray, chunk: int,
             scratch_gid: int = SCRATCH_GID) -> np.ndarray:
  """Ids padded with `scratch_gid` to a multiple of `chunk` (flat: Hopper
  needs no SMEM id pages)."""
  n = len(ugids)
  out = np.full((-(-n // chunk) * chunk,), scratch_gid, np.int32)
  out[:n] = ugids
  return out


def main(argv=None):
  """Returns {'correct': bool, 'variants': [(name, ms, ok), ...]}."""
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--device', default=None,
                 help="'cuda' (default) or 'cpu'")
  p.add_argument('--groups', type=int, default=GROUPS)
  p.add_argument('--slots', type=int, default=SLOTS)
  p.add_argument('--iters', type=int, default=10)
  args = p.parse_args(argv)
  dev = resolve_device(args.device)
  groups = args.groups
  scratch = groups - 1
  rng = np.random.default_rng(0)
  # unique sorted group ids (plus scratch padding via page_ids)
  ugids = np.sort(rng.choice(groups - 1, args.slots, replace=False)
                  ).astype(np.int32)
  gen = torch.Generator(device=dev).manual_seed(0)
  base = torch.randn((groups, 8, W), generator=gen, device=dev)
  want = group_rmw_plain(base.clone(), torch.from_numpy(ugids).to(dev),
                         0.999, -0.001)
  table = torch.empty_like(base)

  results = []
  padded = page_ids(ugids, args.slots * N // SLOTS, scratch)
  for name, threads, per_block, pad in VARIANTS:
    fn = make_kernel(threads, per_block)
    ids = padded if pad else ugids
    gid = torch.from_numpy(ids).to(dev)
    table.copy_(base)
    fn(gid, table)
    check_ids(dev)
    # byte-equal to the plain version on every group but the scratch group
    # (the last; no listed group names it)
    ok = torch.equal(table[:scratch].view(torch.int32),
                     want[:scratch].view(torch.int32))
    for _ in range(3):
      fn(gid, table)
    sync(table)
    t0 = time.perf_counter()
    for _ in range(args.iters):
      fn(gid, table)
    sync(table)
    dt = (time.perf_counter() - t0) / args.iters
    results.append((name, dt * 1e3, ok))
    print(f'{name:36s}: {dt*1e3:7.3f} ms   correct={ok}', flush=True)
  del table, base, want
  return {'correct': all(r[2] for r in results), 'variants': results}


if __name__ == '__main__':
  main()
