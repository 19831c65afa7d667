"""K2's or K3's time at its main-path shape, to compare two trees on one
card.

    python easyrec_torch/tools/time_update.py [--tree DIR]
        [--kernel rows|fused] [--reps 20]

Run as a file, not with -m, so that nothing of easyrec_torch is imported
before it imports easyrec_torch from DIR (default: this checkout): a second
tree (an earlier commit unpacked with `git archive`) can then be timed in
its own process on the same card, in turns with this one. The inputs are
chip_smoke.py's, with compact Adam:
  rows   K2 at the flagship DeepFM's shape: one DummyInput batch packed,
         sorted and summed by K1 (EASYREC_GG_BF16 '1'), every 97th
         gradient row zero, the 26,000,014-row [w | mv] table;
  fused  K3 at the Taobao DIN's shape: one synthetic batch (471,040 id
         slots, two padding segments of ~100k), dim 16, the 620,311-row
         table.
The wrapper is `rmw_rows` / `rmw_fused`, or in trees before they took
every block math `rmw_adam` / `rmw_fused_adam`. It is timed with CUDA
events over --reps calls, each after a 256 MB write that flushes L2, and
again under torch.profiler for the device time of its kernels alone (the
kernels launched inside each call's window, never the flush's).
Prints one JSON line with the tree, the card's name and power limit and
both times in ms a call. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


KERNEL_RANGE = 'time_update.call'


def kernel_times(torch, fn, reps, flush):
  """Device time of the kernels fn() launches, per call, from
  torch.profiler: {kernel name: ms per call} summed over its launches.
  Each call runs inside a record_function range that opens after the L2
  flush has finished (a synchronize). A device event counts when the
  CUDA API call that launched it (the host event of the same correlation
  id: cudaLaunchKernel, cudaMemsetAsync, ...) starts inside a range, on
  the host's clock, so the flush's kernel never does, whatever the
  profiler names it and however the device's clock is offset from the
  host's. The wrapper's host gaps between its launches are not in the
  sum. The profiler may drop a device event (its buffers are cleared as
  it goes), which would leave a call's sum short: only the calls each of
  whose launches, memsets and copies has its device event are averaged.
  Returns {} where the profiler records no device time, not every range,
  a device event without its launching call, or no call whole."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile, record_function

  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      flush.zero_()
      torch.cuda.synchronize()
      with record_function(KERNEL_RANGE):
        fn()
        torch.cuda.synchronize()
  events = prof.events()
  host = [e for e in events if e.device_type == DeviceType.CPU]
  ranges = [(e.time_range.start, e.time_range.end) for e in host
            if e.name == KERNEL_RANGE]
  # the CUDA API calls, by correlation id (operators number themselves
  # from another counter, so only the API calls are looked up)
  launched = {e.id: e.time_range.start for e in host
              if e.name.startswith('cu')}
  # the range's own device-side annotation is not a kernel
  device = [e for e in events if e.device_type == DeviceType.CUDA and
            e.name != KERNEL_RANGE]
  if len(ranges) != reps or not device or \
      any(e.id not in launched for e in device):
    return {}
  ran = {}
  for e in device:
    ran.setdefault(e.id, []).append(e)
  # the API calls that put work on the card
  work = [e for e in host if e.name.startswith('cu') and any(
      k in e.name for k in ('LaunchKernel', 'Memset', 'Memcpy'))]
  out, whole = {}, 0
  for lo, hi in ranges:
    calls = [e.id for e in work if lo <= e.time_range.start <= hi]
    if not calls or any(i not in ran for i in calls):
      continue
    whole += 1
    for i in calls:
      for e in ran[i]:
        out[e.name] = out.get(e.name, 0.0) + (e.time_range.end -
                                              e.time_range.start)
  if not whole:
    return {}
  return {k: v / 1e3 / whole for k, v in out.items() if v > 0}


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--tree', default=None)
  ap.add_argument('--kernel', choices=('rows', 'fused'), default='rows')
  ap.add_argument('--reps', type=int, default=20)
  args = ap.parse_args(argv)
  tree = os.path.abspath(args.tree) if args.tree else os.path.dirname(
      os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
  sys.path.insert(0, tree)
  import torch
  if not torch.cuda.is_available():
    print('time_update: torch.cuda.is_available() is False',
          file=sys.stderr)
    return 1
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.ops import packed_table as pt
  from easyrec_torch.optim.sparse import SparseAdam, pack_pair
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils import flagship
  from easyrec_torch.utils.synthetic import synthetic_batch
  assert os.path.dirname(os.path.dirname(pt.__file__)) == \
      os.path.join(tree, 'easyrec_torch'), pt.__file__

  dev = torch.device('cuda')
  fused = args.kernel == 'fused'
  trainer = Trainer(flagship.taobao_din_config() if fused else
                    flagship.criteo_deepfm_config(), device='cuda')
  batch = synthetic_batch(trainer.specs, list(trainer.ctx.label_fields),
                          4096, seed=0) if fused else \
      next(iter(trainer.train_input()))
  (key, meta), = trainer.metas.items()
  ids = emb_ops.pack_ids(trainer.layout, to_device(batch, dev))[key]
  ids = ids.reshape(-1)
  n, dim = ids.shape[0], meta.dim
  used = trainer.layout.tables[key].used_dim
  gen = torch.Generator(device=dev).manual_seed(4321 if fused else 1234)
  grads = torch.randn((n, dim), generator=gen, device=dev) * 1e-3
  grads[:, used:] = 0.0
  grads[::97] = 0.0
  table = torch.empty((meta.rows, 2 * dim), device=dev)
  trainer.layout.init_weights(key, 7, dev, table)
  for lo in range(0, meta.rows, 1 << 22):
    hi = min(meta.rows, lo + (1 << 22))
    table[lo:hi, dim:] = pack_pair(
        torch.randn((hi - lo, dim), generator=gen, device=dev) * 1e-3,
        torch.rand((hi - lo, dim), generator=gen, device=dev) * 1e-6)
  sids, order, starts = pt.sort_segments(ids)
  opt = SparseAdam()
  hypers = opt.hypers(torch.tensor(1e-3, device=dev),
                      torch.tensor(3, dtype=torch.int32, device=dev))
  if fused:
    wrapper = getattr(pt, 'rmw_fused', None) or pt.rmw_fused_adam
    call = lambda: wrapper(table, sids, order, starts, grads,  # noqa: E731
                           hypers, opt)
  else:
    uids, gsum = pt.seg_sum(sids, order, starts, grads, meta.sentinel, '1')
    wrapper = getattr(pt, 'rmw_rows', None) or pt.rmw_adam
    call = lambda: wrapper(table, uids, gsum, hypers, opt)  # noqa: E731
  flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
  call()
  torch.cuda.synchronize()
  total = 0.0
  for _ in range(args.reps):
    flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    end.synchronize()
    total += start.elapsed_time(end)
  kernels_ms = sum(kernel_times(torch, call, args.reps, flush).values()) \
      or None
  smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60).stdout.strip()
  print(json.dumps({'tree': tree, 'wrapper': wrapper.__name__, 'card': smi,
                    'slots': n, 'dim': dim, 'ms': total / args.reps,
                    'kernels_ms': kernels_ms}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
