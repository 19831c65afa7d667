"""Projected step time of the row-sharded flagship on 8, 16 and 32 H100s.

Counterpart of easyrec_tpu/tools/scaling_model.py, which reads a TPU pod
program's collectives from its HLO and prices them at published link rates
beside a measured one-chip step. The port's collectives are the ones its
processes call, so it counts them: for each world of --worlds it runs the
flagship DeepFM row-sharded (train_distribute EmbeddingParallelStrategy)
in that many gloo processes on this host (aot_pod_check.run_world), one
step at --batch_per_chip rows a rank (a step's bytes do not change with
the step: a warm-up would not change them), and reads each rank's
collectives from its World's traffic counter (parallel/mesh.py).
Wire bytes a rank, priced as the JAX analyze_hlo (:62-88) prices them: an
all_reduce twice its tensor, an all_gather (or all_gather_object) the
gathered result, an all_to_all what it sends and receives (the JAX tool's
twice its buffer) less a rank's rows to itself, a broadcast its payload.
The busiest rank's bytes stand for the world's.

--hash_buckets defaults to the flagship's 1,000,000, not the JAX tool's
4,096: the JAX HLO sizes the exchange's buffers by capacity, which the
table's size leaves alone, but the port's all_to_all_single sends the rows
a step touches, and a smaller table folds more of a batch's ids into one
row.

The projection (project, as the JAX :91-107) is additive: the measured
one-GPU step, plus the intra-node bytes over NVLink, plus the cross-node
share over InfiniBand. An all_to_all's bytes split by each peer's node
(--gpus_per_node GPUs a node); a ring collective's cross-node share is
1/nodes of its bytes, the JAX model's share.

Link rates, NVIDIA's published figures for an H100 SXM:
  NVLink 4, 900 GB/s total a GPU, derated as the JAX tool derates its
  links for all-to-all traffic (45 of 200 GB/s, 0.225): 202.5 GB/s;
  SCALING_NVLINK_BPS overrides it;
  InfiniBand NDR, 400 Gb/s a GPU (one ConnectX-7 port a GPU on a DGX
  H100): 50 GB/s, its raw share, as the JAX tool prices its data-center
  network; SCALING_IB_BPS overrides it.

The one-GPU step: --measure times the flagship's sharded step at
--batch_per_chip rows in a world of one on the card (NCCL, synchronised,
as chip_smoke.py's phase 34 runs it); else --step_ms gives it, which is
required without a card.

What the model leaves out: a collective whose result the host waits for
(each route's [W, W] all_gather and its .cpu(), parallel/exchange.py; the
sizes of all_gather_rows) costs a round trip whatever its bytes, which a
model that prices bytes does not see. Each record counts them
(host_syncs_per_step) beside the projection.

  python -m easyrec_torch.tools.scaling_model [--worlds 8,16,32] \\
      [--gpus_per_node 8] [--batch_per_chip 4096] \\
      [--hash_buckets 1000000] (--step_ms MS | --measure) [--device cuda]

Prints one JSON line a world.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

NVLINK_RAW_BPS = 900e9          # NVLink 4, total a GPU
A2A_DERATE = 45.0 / 200.0       # the JAX tool's all-to-all derate
IB_RAW_BPS = 400e9 / 8          # NDR InfiniBand, a GPU
NVLINK_EFF_BPS = float(os.environ.get('SCALING_NVLINK_BPS',
                                      NVLINK_RAW_BPS * A2A_DERATE))
IB_EFF_BPS = float(os.environ.get('SCALING_IB_BPS', IB_RAW_BPS))


def wire_bytes(traffic: dict, rank: int, gpus_per_node: int):
  """One rank's traffic (World.traffic) -> (wire bytes by kind, the
  all_to_all bytes to and from peers on other nodes)."""
  wire = {}
  for kind, c in traffic['kinds'].items():
    if kind == 'all_reduce':
      b = 2 * c['sent']
    elif kind in ('all_gather', 'all_gather_object'):
      b = c['recv']
    elif kind == 'all_to_all':
      b = sum(p['sent'] + p['recv'] for peer, p in traffic['peers'].items()
              if int(peer) != rank)
    else:
      b = max(c['sent'], c['recv'])
    wire[kind] = int(b)
  node = rank // gpus_per_node
  cross = sum(p['sent'] + p['recv'] for peer, p in traffic['peers'].items()
              if int(peer) // gpus_per_node != node)
  return wire, int(cross)


def project(wire: dict, n_nodes: int, step_ms: float,
            nvlink_bps: float = None, ib_bps: float = None,
            a2a_cross: float = None):
  """(projected step ms, comm ms): step_ms plus the wire bytes' time. With
  a2a_cross (the all_to_all's cross-node bytes) the all_to_all is split
  by node; every other byte, or every byte without it, is ring traffic
  whose 1/n_nodes share crosses nodes (the JAX project)."""
  nvlink = NVLINK_EFF_BPS if nvlink_bps is None else nvlink_bps
  ib = IB_EFF_BPS if ib_bps is None else ib_bps
  total = float(sum(wire.values()))
  a2a = float(wire.get('all_to_all', 0)) if a2a_cross is not None else 0.0
  ring = total - a2a
  cross = (ring / n_nodes if n_nodes > 1 else 0.0) + \
      (float(a2a_cross) if a2a_cross is not None else 0.0)
  comm_s = (total - cross) / nvlink + cross / ib
  return step_ms + comm_s * 1e3, comm_s * 1e3


def one_gpu_step(world, batch_per_chip: int, hash_buckets: int,
                 steps: int = 10) -> float:
  """ms of the flagship's sharded step in a world of one on the card: the
  mean of `steps` steps after one warm-up, synchronised."""
  import torch
  from easyrec_torch.tools.aot_pod_check import flagship
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils.synthetic import synthetic_batch
  cfg = flagship(batch_per_chip, hash_buckets)
  trainer = Trainer(cfg, device=world.device)
  trainer.init_state()
  labels = list(cfg.data_config.label_fields)
  batches = [to_device(synthetic_batch(trainer.specs, labels, batch_per_chip,
                                       seed=s), world.device)
             for s in range(steps + 1)]
  trainer.train_step(batches[0])
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for b in batches[1:]:
    trainer.train_step(b)
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) * 1e3 / steps


def measure_step_ms(batch_per_chip: int, hash_buckets: int) -> float:
  from easyrec_torch.parallel import launch
  (ms,) = launch.spawn('easyrec_torch.tools.scaling_model:one_gpu_step',
                       [batch_per_chip, hash_buckets], 1, device='cuda',
                       timeout_s=600)
  return ms


def model_world(n: int, gpus_per_node: int, batch_per_chip: int,
                hash_buckets: int, step_ms: float, step_from: str,
                timeout_s: float = 1800.0, results=None) -> dict:
  """The record of one world: its collectives counted, then projected.
  `results`, where given, are the world's rank_step results of these
  settings (aot_pod_check.run_worlds), else the world runs here."""
  from easyrec_torch.tools import aot_pod_check
  t0 = time.time()
  if results is None:
    results = aot_pod_check.run_world(n, batch_per_chip, hash_buckets,
                                      timeout_s=timeout_s)
  per_rank = [wire_bytes(r['traffic'], r['rank'], gpus_per_node)
              for r in results]
  busiest = max(range(n), key=lambda r: sum(per_rank[r][0].values()))
  wire, cross = per_rank[busiest]
  traffic = results[busiest]['traffic']
  nodes = -(-n // gpus_per_node)
  step, comm = project(wire, nodes, step_ms, a2a_cross=cross)
  last = results[busiest]['loss']
  return {
      'gpus': n, 'nodes': nodes, 'gpus_per_node': gpus_per_node,
      'batch_per_chip': batch_per_chip, 'hash_buckets': hash_buckets,
      'busiest_rank': busiest,
      'collective_counts': {k: c['calls']
                            for k, c in sorted(traffic['kinds'].items())},
      'wire_bytes_per_chip': dict(sorted(wire.items())),
      'wire_mb_per_chip_per_step': sum(wire.values()) / 1e6,
      'a2a_cross_node_bytes': cross,
      'host_syncs_per_step': traffic['host_syncs'],
      'overflow': [last['exchange_update_overflow'],
                   last['exchange_ep_pull_overflow']],
      'projected_comm_ms': comm,
      'projected_step_ms': step,
      'projected_ex_s_per_chip': batch_per_chip / step * 1e3,
      'world_seconds': time.time() - t0,
      'assumptions': {
          'nvlink_eff_bps': NVLINK_EFF_BPS, 'ib_eff_bps': IB_EFF_BPS,
          'nvlink': 'NVLink 4, 900 GB/s a GPU (H100 SXM) x %.3f' % A2A_DERATE,
          'ib': 'NDR InfiniBand, 400 Gb/s a GPU (DGX H100)',
          'measured_single_gpu_ms': step_ms, 'step_from': step_from},
  }


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--worlds', default='8,16,32')
  parser.add_argument('--gpus_per_node', type=int, default=8)
  parser.add_argument('--batch_per_chip', type=int, default=4096)
  parser.add_argument('--hash_buckets', type=int, default=1000000)
  parser.add_argument('--step_ms', type=float, default=None,
                      help='the one-GPU step, ms (required without a card)')
  parser.add_argument('--measure', action='store_true',
                      help='time the one-GPU step on the card')
  parser.add_argument('--device', default='cuda',
                      help='cuda: the card that --measure times')
  parser.add_argument('--timeout', type=float, default=1800.0,
                      help='seconds a world may take')
  args = parser.parse_args(argv)
  if args.measure:
    import torch
    if args.device == 'cpu' or not torch.cuda.is_available():
      parser.error('--measure times the step on a card, and there is none '
                   '(--device %s); give --step_ms' % args.device)
    step_ms = measure_step_ms(args.batch_per_chip, args.hash_buckets)
    step_from = 'measured on %s' % torch.cuda.get_device_name(0)
  elif args.step_ms is not None:
    step_ms, step_from = float(args.step_ms), '--step_ms'
  else:
    parser.error('--step_ms is required without --measure (a card)')
  for w in args.worlds.split(','):
    rec = model_world(int(w), args.gpus_per_node, args.batch_per_chip,
                      args.hash_buckets, step_ms, step_from, args.timeout)
    print(json.dumps(rec, sort_keys=True), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
