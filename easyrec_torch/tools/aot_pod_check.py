"""Pre-flight check of the row-sharded flagship step for a world of H100s
larger than the hardware at hand: one 8-GPU node, or several.

Counterpart of easyrec_tpu/tools/aot_pod_check.py (:40-134), which
compiles the sharded step ahead of time for a TPU pod's topology. On H100s
the step is the port's: a process a GPU, the tables row-sharded under
train_distribute EmbeddingParallelStrategy, the ids and rows routed to
their owners by all_to_all_single (parallel/exchange.py; NCCL between the
cards). What is checked without those GPUs:

  1. the step at the world's size: --world x --nodes gloo processes on this
     host's CPU (parallel/launch.py spawn), each a rank of the flagship
     DeepFM (utils/flagship.py criteo_deepfm_config) at --batch_per_chip
     rows a rank, 4,096 buckets a feature and dim 16, one train step. One
     card cannot hold several NCCL ranks, and the JAX tool builds its
     template on a CPU mesh too: this is the tool's design, not a fallback.
     It must hold: every table row-sharded, the step through the exchange
     (its all_to_all_single calls counted by the World's traffic counter,
     parallel/mesh.py), the owner's K1 and K2 run (their plain versions on
     the CPU), both overflow counts 0, and the loss equal on every rank;
  2. each rank's memory (the counterpart of memory_analysis()): its table
     shard and slots, its dense parameters and optimizer state, and the
     exchange's owner-side buffers at capacity_rows; at the run's width,
     where the table and dense bytes must equal those of the tensors the
     rank holds, and reckoned at the flagship's full width (1,000,000
     buckets a feature) against the card's memory;
  3. on a card (the default --device cuda), K1 and K2 launched at rank 0's
     owner shapes for that world at full width: the shard's rows of the
     26,000,014-row table, capacity_rows slots, and the fill that the
     world's synthetic ids at full width give owner 0; each bit-exact
     against its plain version, with its time. It is the counterpart of
     the JAX check that the Mosaic kernel compiles inside the sharded
     program. --device cpu runs the plain versions.

  python -m easyrec_torch.tools.aot_pod_check [--world 8] [--nodes 1] \\
      [--batch_per_chip 8] [--device cuda|cpu]

Prints a line a check and, last, one JSON line; exits 0 when every check
holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# the flagship's full width, which the memory is also reckoned at
FULL_BUCKETS = 1000000
# an H100 SXM's memory (80 GB HBM3), where no card is at hand to ask
H100_BYTES = 80 * 10 ** 9
# at most this many ranks draw their table at a time (each draws the whole
# table and keeps its block, so the draws equal one device's)
INIT_AT_ONCE = 8


def flagship(batch_per_chip: int, hash_buckets: int, dim: int = 16):
  """The flagship DeepFM, row-sharded, at batch_per_chip rows a rank."""
  from easyrec_torch import main as main_lib
  from easyrec_torch.utils import flagship as flagship_lib
  return main_lib.load_config(
      flagship_lib.criteo_deepfm_config(batch_size=batch_per_chip,
                                        hash_bucket_size=hash_buckets,
                                        embedding_dim=dim),
      {'train_config.train_distribute': 'EmbeddingParallelStrategy'})


def rank_step(world, batch_per_chip: int, hash_buckets: int,
              dim: int) -> dict:
  """One rank of the flagship's sharded step (run in each process of a
  spawn): one train step on this rank's synthetic batch. Returns the
  step's losses, its collective traffic (World.traffic) and K1 / K2 calls
  with their sizes, the tables' split, and the bytes the rank holds."""
  import torch
  from easyrec_torch.ops import packed_table as pt
  from easyrec_torch.train.trainer import Trainer
  from easyrec_torch.utils.synthetic import synthetic_batch
  torch.set_num_threads(1)
  cfg = flagship(batch_per_chip, hash_buckets, dim)
  trainer = Trainer(cfg, device=world.device)
  for first in range(0, world.size, INIT_AT_ONCE):
    if first <= world.rank < first + INIT_AT_ONCE:
      trainer.init_state()
    world.barrier()
  batch = synthetic_batch(trainer.specs, list(cfg.data_config.label_fields),
                          batch_per_chip, seed=world.rank)
  calls = {'seg_sum': [], 'rmw_rows': []}
  seg, rmw = pt.seg_sum, pt.rmw_rows

  def seg_counted(sids, order, starts, grads, sentinel, mode=None):
    calls['seg_sum'].append((int(sids.shape[0]),
                             int((sids < sentinel).sum())))
    return seg(sids, order, starts, grads, sentinel, mode)

  def rmw_counted(table, uids, gsum, hypers, opt):
    calls['rmw_rows'].append((int(table.shape[0]), int(uids.shape[0])))
    return rmw(table, uids, gsum, hypers, opt)

  pt.seg_sum, pt.rmw_rows = seg_counted, rmw_counted
  world.reset_traffic()
  try:
    out = trainer.step_batch(batch)
  finally:
    pt.seg_sum, pt.rmw_rows = seg, rmw
  sh = trainer.sharding
  opt_state = trainer.dense_opt.state_dict()
  return {
      'rank': world.rank, 'loss': {k: float(v) for k, v in out.items()},
      'traffic': world.traffic(),
      'calls': calls,
      'sharded': sorted(sh.splits) if sh is not None else [],
      'tables': sorted(trainer.metas),
      'table_bytes': sum(t.numel() * t.element_size()
                         for t in trainer.tables.values()),
      'param_bytes': sum(p.numel() * p.element_size()
                         for p in trainer.model.parameters()),
      'param_count': sum(p.numel() for p in trainer.model.parameters()),
      'opt_bytes': _tensor_bytes(opt_state),
      'opt_slots': len(trainer.dense_opt.state_slots),
  }


def _tensor_bytes(obj) -> int:
  import torch
  if isinstance(obj, torch.Tensor):
    return obj.numel() * obj.element_size()
  if isinstance(obj, dict):
    return sum(_tensor_bytes(v) for v in obj.values())
  if isinstance(obj, (list, tuple)):
    return sum(_tensor_bytes(v) for v in obj)
  return 0


def rank_steps(world, configs) -> list:
  """rank_step for each (batch_per_chip, hash_buckets, dim) of `configs`,
  one after the other in this process."""
  return [rank_step(world, *c) for c in configs]


def run_worlds(n: int, configs, timeout_s: float = 600.0) -> list:
  """rank_step of each config in `configs` on each of n gloo processes of
  this host, the configs one after the other in one world (one start of
  the processes); for each config, the results in rank order."""
  from easyrec_torch.parallel import launch
  ranks = launch.spawn('easyrec_torch.tools.aot_pod_check:rank_steps',
                       [list(configs)], n, device='cpu', timeout_s=timeout_s,
                       env={'OMP_NUM_THREADS': '1', 'MKL_NUM_THREADS': '1'})
  return [list(per_config) for per_config in zip(*ranks)]


def run_world(n: int, batch_per_chip: int, hash_buckets: int, dim: int = 16,
              timeout_s: float = 600.0) -> list:
  """rank_step on each of n gloo processes of this host; results in rank
  order."""
  return run_worlds(n, [(batch_per_chip, hash_buckets, dim)], timeout_s)[0]


def reckon(n: int, batch_per_chip: int, hash_buckets: int, dim: int,
           res: dict) -> dict:
  """A rank's bytes by the formulas, at `hash_buckets` a feature: each
  table's block of row_split and its width (rank 0's, and every rank's in
  'tables'); the dense parameters (the run's count) and the dense
  optimizer's slots of each (Adam's two moments) with its int32 step
  count; the exchange's owner-side buffers at capacity_rows (the pull's
  ids and rows, the update's ids and gradients). Also each table's owner
  shape for K1 and K2 (rows, slots, fill)."""
  import torch
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.parallel import exchange as xch
  from easyrec_torch.parallel import mesh
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils.synthetic import synthetic_batch
  cfg = flagship(batch_per_chip, hash_buckets, dim)
  tr = Trainer(cfg, device='cpu', world=None)     # geometry only, no state
  labels = list(cfg.data_config.label_fields)
  packs = [emb_ops.pack_all_views(tr.layout, to_device(synthetic_batch(
      tr.specs, labels, batch_per_chip, seed=r), torch.device('cpu')))
           for r in range(n)]
  tables, xbuf = [0] * n, 0
  shapes = {}
  for key, meta in tr.metas.items():
    split = mesh.row_split(meta.rows, meta.dim, meta.n_parts, n)
    for r in range(n):
      tables[r] += split.count(r) * meta.width * 4
    n_loc = int(packs[0][key].numel())
    cap = xch.capacity_rows(n_loc, n, split.live_owners)
    xbuf += 2 * cap * (8 + 4 * meta.dim)
    # the distinct ids of each rank that land in owner 0's block
    fill = sum(int((torch.unique(p[key].reshape(-1)) <
                    split.local_rows).sum()) for p in packs)
    shapes[key] = {'rows': split.count(0), 'width': meta.width,
                   'dim': meta.dim, 'slots': cap, 'fill': min(fill, cap),
                   'n_loc': n_loc}
  params = res['param_count'] * 4
  return {'table': tables[0], 'tables': tables, 'params': params,
          'opt': res['opt_slots'] * params + 4, 'exchange': xbuf,
          'shapes': shapes}


def card_check(shapes: dict, hash_buckets: int, dim: int, batch: int,
               device: str) -> list:
  """K1 and K2 at owner 0's shapes (reckon's), on `device`: K1 over the
  owner's slots (the fill real ids of its block, the rest the sentinel),
  then K2 on a table of the shard's rows, each against its plain version
  bit for bit on the same inputs; their ms (CUDA events, the mean of 20
  calls after 3) on a card."""
  import torch
  from easyrec_torch.ops import packed_table as pt
  from easyrec_torch.train.trainer import Trainer
  dev = torch.device(device)
  cfg = flagship(batch, hash_buckets, dim)
  tr = Trainer(cfg, device='cpu', world=None)
  opt = tr.embed_pair.sparse
  step = torch.zeros((), dtype=torch.int64)
  hypers = opt.hypers(tr.embed_pair.schedule(step), step).to(dev)
  gen = torch.Generator(device=dev).manual_seed(17)
  out = []
  for key, s in shapes.items():
    full = tr.metas[key]
    meta = pt.TableMeta(s['rows'], full.dim, full.logical_parts,
                        full.compact)
    table = torch.zeros((meta.rows, meta.width), device=dev)
    table[:, :meta.dim] = 0.01 * torch.randn((meta.rows, meta.dim),
                                             generator=gen, device=dev)
    for p, v in enumerate(pt.slot_fill(meta, opt.slot_init), 1):
      table[:, p * meta.dim:(p + 1) * meta.dim] = v
    ids = torch.full((s['slots'],), meta.sentinel, dtype=torch.int64,
                     device=dev)
    ids[:s['fill']] = torch.randint(0, meta.rows, (s['fill'],),
                                    generator=gen, device=dev)
    grads = torch.zeros((s['slots'], meta.dim), device=dev)
    grads[:s['fill']] = torch.randn((s['fill'], meta.dim), generator=gen,
                                    device=dev)
    sids, order, starts = pt.sort_segments(ids)
    mode = pt.gg_mode()
    uk, sk = pt.seg_sum(sids, order, starts, grads, meta.sentinel, mode)
    up, sp = pt.seg_sum_plain(sids, order, starts, grads, meta.sentinel,
                              mode)
    k1 = torch.equal(uk, up) and torch.equal(sk.view(torch.int32),
                                             sp.view(torch.int32))
    a, b = table.clone(), table.clone()
    pt.rmw_rows(a, up, sp, hypers, opt)
    pt.rmw_rows_plain(b, up, sp, hypers, opt)
    k2 = torch.equal(a.view(torch.int32), b.view(torch.int32))
    rec = {'table': key, 'k1_exact': bool(k1), 'k2_exact': bool(k2),
           'k1_max_abs_err': float((sk - sp).abs().max()),
           'k2_max_abs_err': float((a - b).abs().max())}
    if dev.type == 'cuda':
      rec['k1_ms'] = _cuda_ms(lambda: pt.seg_sum(
          sids, order, starts, grads, meta.sentinel, mode))
      rec['k2_ms'] = _cuda_ms(lambda: pt.rmw_rows(a, up, sp, hypers, opt))
    del table, a, b
    out.append(rec)
  return out


def _cuda_ms(fn, reps: int = 20) -> float:
  import torch
  for _ in range(3):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def check(world: int = 8, nodes: int = 1, batch_per_chip: int = 8,
          device: str = 'cuda', dim: int = 16, hash_buckets: int = 4096,
          timeout_s: float = 600.0, log=print, results=None) -> dict:
  """Run the checks; returns the summary, its 'ok' False where one
  failed (each failure also logged). `results`, where given, are the
  world's rank_step results of these settings (run_worlds), else the
  world runs here."""
  import torch
  if device != 'cpu' and not torch.cuda.is_available():
    raise RuntimeError('--device %s was asked for but torch.cuda.is_'
                       'available() is False; pass --device cpu to run the '
                       'plain versions' % device)
  n = world * nodes
  failures = []

  def hold(ok, what):
    if not ok:
      failures.append(what)
      log('FAILED: %s' % what)

  t0 = time.time()
  if results is None:
    results = run_world(n, batch_per_chip, hash_buckets, dim,
                        timeout_s=timeout_s)
  log('world: %d ranks (%d node(s) of %d GPUs) as gloo processes on this '
      'host, the flagship DeepFM at %d rows a rank, %d buckets a feature, '
      'dim %d: one train step (%.1f s here)'
      % (n, nodes, world, batch_per_chip, hash_buckets, dim,
         time.time() - t0))
  r0 = results[0]
  hold(all(r['sharded'] == r['tables'] and r['sharded'] for r in results),
       'every table row-sharded on every rank')
  a2a = [r['traffic']['kinds'].get('all_to_all', {}).get('calls', 0)
         for r in results]
  log('exchange: all_to_all_single %s calls a rank in the step; traffic of '
      'rank 0 by kind %s' % (a2a[0] if len(set(a2a)) == 1 else a2a,
                              json.dumps(r0['traffic']['kinds'],
                                         sort_keys=True)))
  hold(all(c >= 4 * len(r0['tables']) for c in a2a),
       'the step ran the owner-routed exchange (4 all_to_all_single a '
       'table)')
  k1 = [len(r['calls']['seg_sum']) for r in results]
  k2 = [len(r['calls']['rmw_rows']) for r in results]
  log('owner update: K1 %s and K2 %s calls a rank (plain versions on the '
      'CPU); rank 0: K1 sizes (slots, live) %s, K2 (table rows, ids) %s'
      % (k1[0] if len(set(k1)) == 1 else k1,
         k2[0] if len(set(k2)) == 1 else k2, r0['calls']['seg_sum'],
         r0['calls']['rmw_rows']))
  hold(all(a >= 2 * len(r0['tables']) for a in k1) and
       all(b >= len(r0['tables']) for b in k2),
       'K1 (local dedup and owner sum) and K2 ran on every rank')
  over = [(r['loss']['exchange_update_overflow'],
           r['loss']['exchange_ep_pull_overflow']) for r in results]
  hold(all(o == (0.0, 0.0) for o in over), 'no overflow (%s)' % (over[0],))
  loss = [r['loss']['total_loss'] for r in results]
  hold(len(set(loss)) == 1, 'the loss equal on every rank (%s)' % loss)
  log('overflow (update, pull) %s on every rank; loss %.9g on every rank'
      % (over[0], loss[0]))

  run = reckon(n, batch_per_chip, hash_buckets, dim, r0)
  full = reckon(n, batch_per_chip, FULL_BUCKETS, dim, r0)
  for r in results:
    held = (r['table_bytes'], r['param_bytes'], r['opt_bytes'])
    want = (run['tables'][r['rank']], run['params'], run['opt'])
    hold(held == want, 'rank %d bytes (table, dense parameters, optimizer '
         'state) reckoned %s, held %s' % (r['rank'], want, held))
  log('bytes each rank holds at run width (table shard, dense parameters, '
      'optimizer state), equal to the reckoned bytes: %s'
      % [(r['table_bytes'], r['param_bytes'], r['opt_bytes'])
         for r in results])
  cap = torch.cuda.get_device_properties(0).total_memory \
      if torch.cuda.is_available() else H100_BYTES
  card = torch.cuda.get_device_name(0) if torch.cuda.is_available() else \
      'no card here: an H100 SXM\'s'
  for what, m in (('run width (%d buckets)' % hash_buckets, run),
                  ('full width (%d buckets)' % FULL_BUCKETS, full)):
    total = m['table'] + m['params'] + m['opt'] + m['exchange']
    log('memory of rank 0 (the largest block) at %s: table shard and '
        'slots %d B, dense parameters %d B, dense optimizer state %d B, '
        'exchange buffers at capacity_rows %d B; total %.4f GB, %.2f%% of '
        'the card\'s %.1f GB (%s)'
        % (what, m['table'], m['params'], m['opt'], m['exchange'],
           total / 1e9, 100.0 * total / cap, cap / 1e9, card))
  hold(full['table'] + full['params'] + full['opt'] + full['exchange'] < cap,
       'the full-width rank fits the card')

  kernels = card_check(full['shapes'], FULL_BUCKETS, dim, batch_per_chip,
                       device)
  for rec in kernels:
    s = full['shapes'][rec['table']]
    log('owner kernels at full width on %s, table %s: K1 over %d slots (%d '
        'filled), K2 on [%d, %d]: K1 %s, K2 %s%s'
        % (device, rec['table'], s['slots'], s['fill'], s['rows'],
           s['width'], 'bit-exact' if rec['k1_exact'] else 'DIFFERS',
           'bit-exact' if rec['k2_exact'] else 'DIFFERS',
           '; K1 %.4f ms, K2 %.4f ms' % (rec['k1_ms'], rec['k2_ms'])
           if 'k1_ms' in rec else ' (plain versions)'))
    hold(rec['k1_exact'] and rec['k2_exact'],
         'K1 and K2 at the owner shapes equal their plain versions')
  return {'ok': not failures, 'failures': failures, 'ranks': n,
          'nodes': nodes, 'batch_per_chip': batch_per_chip,
          'all_to_all_calls': a2a[0], 'loss': loss[0],
          'bytes_run': {k: v for k, v in run.items() if k != 'shapes'},
          'bytes_full': {k: v for k, v in full.items() if k != 'shapes'},
          'owner_shapes': full['shapes'], 'kernels': kernels,
          'device': device}


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--world', type=int, default=8,
                      help='GPUs a node (8: one 8-GPU H100 node)')
  parser.add_argument('--nodes', type=int, default=1,
                      help='nodes of --world GPUs each')
  parser.add_argument('--batch_per_chip', type=int, default=8)
  parser.add_argument('--device', default='cuda',
                      help='where K1 and K2 run at the owner shapes')
  parser.add_argument('--timeout', type=float, default=600.0,
                      help='seconds the world may take')
  args = parser.parse_args(argv)
  summary = check(args.world, args.nodes, args.batch_per_chip, args.device,
                  timeout_s=args.timeout)
  print(json.dumps(summary, sort_keys=True), flush=True)
  return 0 if summary['ok'] else 1


if __name__ == '__main__':
  sys.exit(main())
