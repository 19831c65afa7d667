"""Stage-by-stage profile of the packed-v2 update path, on the card.

Counterpart of benchmarks/bench_packed_stages.py: times each stage of the
update of bench_packed_v2 on its own (argsort, the two takes by order, the
segment sums, the 1-D scatters, dedup_sum, group_prep, take_groups, the
math), then the write-back alone (`push_variant`, kernel K4) and the
in-place RMW with a gradient (`rmw_variant`, kernel K5), each checked
against its plain version.

Run (on the card unless --device cpu):

    python -m easyrec_torch.benchmarks.bench_packed_stages
"""

from __future__ import annotations

import argparse

import torch

from easyrec_torch.benchmarks.bench_packed_v2 import (
    PackMeta, group_prep, take_groups, time_simple, time_threaded)
from easyrec_torch.device import resolve_device
from easyrec_torch.ops.group_dma import (check_ids, group_push, group_rmw,
                                         group_rmw_plain)
from easyrec_torch.optim.sparse import dedup_sum


def push_variant(packed3, ugids, new_rows):
  """Push only: packed3[ugids[i]] = new_rows[i] through K4, in place."""
  return group_push(packed3, ugids, new_rows)


def rmw_variant(packed3, ugids, gg):
  """Pull, math, push in one kernel (K5): g = g*0.999 - 0.001*gg, in
  place."""
  return group_rmw(packed3, ugids, 0.999, 0.0, gg=gg, c=-0.001)


def main(argv=None):
  """Prints one line a stage and a correctness line each for push and
  RMW; returns {'correct': bool, 'ms': {stage: ms}}."""
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--device', default=None,
                 help="'cuda' (default) or 'cpu'")
  p.add_argument('--rows', type=int, default=26_000_000)
  p.add_argument('--ids', type=int, default=4096 * 26)
  p.add_argument('--iters', type=int, default=10)
  args = p.parse_args(argv)
  dev = resolve_device(args.device)
  rows, n_ids, iters = args.rows, args.ids, args.iters
  gen = torch.Generator(device=dev).manual_seed(0)
  meta = PackMeta(rows, 16)
  ids = torch.randint(0, rows, (n_ids,), generator=gen, device=dev,
                      dtype=torch.int32)
  grads = torch.randn((n_ids, 16), generator=gen, device=dev)
  ms = {}

  def stage(name, fn, *a):
    ms[name] = time_simple(fn, *a, iters=iters) * 1e3
    print(f'{name:21s}: {ms[name]:8.2f} ms', flush=True)

  # -- micro stages: where does dedup/prep time go? -------------------
  stage(f'argsort {n_ids}', torch.argsort, ids)
  order = torch.argsort(ids)

  def sort_take(ids, grads, order):
    return ids.index_select(0, order), grads.index_select(0, order)
  stage('2x take by order', sort_take, ids, grads, order)
  sids, sgrads = sort_take(ids, grads, order)
  first = torch.ones(n_ids, dtype=torch.bool, device=dev)
  first[1:] = sids[1:] != sids[:-1]
  seg = torch.cumsum(first, 0) - 1
  lengths = torch.bincount(seg)
  n = n_ids
  stage(f'segsum [{n},16]', lambda s, g: torch.zeros(
      (n, 16), device=dev).index_add_(0, s, g), seg, sgrads)
  stage('segsum sorted', lambda g, ln: torch.segment_reduce(
      g, 'sum', lengths=ln), sgrads, lengths)
  stage('1-D scatter_', lambda s, v: torch.zeros(
      (n,), dtype=torch.int32, device=dev).scatter_(0, s, v), seg, sids)
  stage('1-D index_put_', lambda s, v: torch.zeros(
      (n,), dtype=torch.int32, device=dev).index_put_((s,), v), seg, sids)

  stage('dedup_sum', lambda i, g: dedup_sum(i, g, meta.scratch), ids, grads)
  uids, ug = dedup_sum(ids, grads, meta.scratch)
  stage('group_prep', lambda u, g: group_prep(u, g, meta), uids, ug)
  ugids, gg, touched = group_prep(uids, ug, meta)

  packed = torch.randn((meta.groups * 8, meta.width), generator=gen,
                       device=dev) * 0.01
  stage('take_groups (x1)', lambda p_, u: take_groups(p_, u, meta), packed,
        ugids)
  gw = take_groups(packed, ugids, meta)

  def math_only(gw, gg, touched):
    nm = 0.9 * gw + 0.1 * gg
    return torch.where(touched, gw - 0.001 * nm, gw)
  stage('math (x1)', math_only, gw, gg, touched)
  new_rows = math_only(gw, gg, touched).contiguous()

  packed3 = packed.view(meta.groups, 8, meta.width)
  del packed, gw
  real = ugids != meta.scratch_gid
  n_real = int(real.sum())
  if bool(real[n_real:].any()):
    raise AssertionError('a real group slot follows a scratch slot')

  t, (packed3,) = time_threaded(
      lambda st, u, r: (push_variant(st, u, r),), (packed3,),
      (ugids, new_rows), iters=iters)
  ms['push'] = t * 1e3
  check_ids(dev)
  got = packed3.index_select(0, ugids[:n_real])
  ok_push = torch.equal(got.view(torch.int32),
                        new_rows[:n_real].view(torch.int32))
  print(f'push only (K4)       : {ms["push"]:8.2f} ms   correct={ok_push}',
        flush=True)
  del got

  gg3 = gg.reshape(-1, 8, meta.width).contiguous()
  want = group_rmw_plain(packed3.clone(), ugids, 0.999, 0.0, gg=gg3,
                         c=-0.001)
  rmw_variant(packed3, ugids, gg3)
  check_ids(dev)
  keep = torch.ones(meta.groups, dtype=torch.bool, device=dev)
  keep[meta.scratch_gid] = False
  ok_rmw = torch.equal(packed3[keep].view(torch.int32),
                       want[keep].view(torch.int32))
  del want
  t, (packed3,) = time_threaded(
      lambda st, u, g: (rmw_variant(st, u, g),), (packed3,), (ugids, gg3),
      iters=iters)
  ms['rmw'] = t * 1e3
  print(f'RMW in-kernel (K5)   : {ms["rmw"]:8.2f} ms   correct={ok_rmw} '
        f'(scratch group excluded)', flush=True)
  del new_rows, packed3
  return {'correct': ok_push and ok_rmw, 'ms': ms}


if __name__ == '__main__':
  main()
