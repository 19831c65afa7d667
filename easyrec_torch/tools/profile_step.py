"""Where the time of a benchmark model's train step goes, on the GPU.

    python -m easyrec_torch.tools.profile_step
        [--model deepfm|deepfm_adagrad|dlrm|dlrm_backbone|din|bst|mmoe|dssm]
        [--data_dir DIR]  (dssm: write_dssm_data's files)
        [--steps 10]
        [--top 25]

Builds the trainer of the flagship Criteo DeepFM (K1 + K2; deepfm_adagrad:
its Adagrad-tables configuration), of the Criteo DLRM (K1 + K2; the
quality harness's DLRM on the flagship's schema; dlrm_backbone: the same
DLRM built by the backbone DSL, samples/dlrm_backbone.config's), of the
Taobao DIN
(EASYREC_PACKED_FUSED=1, K3), of the Taobao BST (K1 + K2; its attention
under EASYREC_ATTN_IMPL, default vpu_bf16) or of the Taobao MMoE (K1 +
K2; two labels, four experts, two towers), all from
easyrec_torch/utils/flagship.py, on the card at batch 4096, or of the
DSSM of samples/dssm_neg_sampler.config (K1 + K2 over the base batch's
and the neg. view's ids; batch 1,024 and 1,024 sampled negatives, on a
--data_dir of chip_smoke.py's write_dssm_data), warms it up for 5 steps
on pre-built batches already on the device (synthetic; the DSSM's from
its input pipeline, the sampler's views in them), then
runs --steps steps without and then under torch.profiler and prints, with
the card's name and power limit:
  - wall time per step without the profiler (ends in
    torch.cuda.synchronize()), and with it (the profiler adds host time to
    every operator);
  - device busy time per step under the profiler (the sum of kernel times;
    the step runs on one stream, so kernels do not overlap) and the idle
    share of the unprofiled wall time;
  - kernel launches per step;
  - the top device kernels and the top host operators by total time.
Needs a GPU; fails where torch.cuda.is_available() is False.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

WARMUP_STEPS = 5
# --model -> (flagship config function, EASYREC_PACKED_FUSED, name)
MODELS = {'deepfm': ('criteo_deepfm_config', '0', 'flagship DeepFM'),
          'deepfm_adagrad': ('criteo_deepfm_adagrad_config', '0',
                             'flagship DeepFM, Adagrad tables'),
          'dlrm': ('criteo_dlrm_config', '0', 'Criteo DLRM'),
          'dlrm_backbone': ('criteo_dlrm_backbone_config', '0',
                            'Criteo DLRM, backbone DSL'),
          'din': ('taobao_din_config', '1', 'Taobao DIN'),
          'bst': ('taobao_bst_config', '0', 'Taobao BST'),
          'mmoe': ('taobao_mmoe_config', '0', 'Taobao MMoE'),
          'dssm': ('dssm_neg_sampler_config', '0', 'DSSM (dssm_neg_sampler)')}


def _device_us(evt) -> float:
  for name in ('self_device_time_total', 'self_cuda_time_total'):
    v = getattr(evt, name, None)
    if v is not None:
      return float(v)
  return 0.0


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--model', choices=sorted(MODELS), default='deepfm')
  ap.add_argument('--data_dir', default='',
                  help='train.csv, eval.csv and items.txt of --model dssm')
  ap.add_argument('--steps', type=int, default=10)
  ap.add_argument('--top', type=int, default=25)
  args = ap.parse_args(argv)

  import torch
  from torch.profiler import ProfilerActivity, profile

  if not torch.cuda.is_available():
    print('profile_step: torch.cuda.is_available() is False',
          file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils import flagship
  from easyrec_torch.utils.synthetic import synthetic_batch

  smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60).stdout.strip()
  card = '%s (nvidia-smi: %s)' % (torch.cuda.get_device_name(0), smi)
  dev = torch.device('cuda')
  config_fn, fused, what = MODELS[args.model]
  os.environ['EASYREC_PACKED_FUSED'] = fused
  if args.model == 'dssm':
    if not args.data_dir:
      ap.error('--model dssm reads --data_dir')
    cfg = flagship.dssm_neg_sampler_config(args.data_dir)
  else:
    cfg = getattr(flagship, config_fn)()
  trainer = Trainer(cfg, device='cuda')
  trainer.init_state()
  bs = int(trainer.data_config.batch_size)
  labels = list(trainer.ctx.label_fields)
  if args.model == 'dssm':
    batches = [to_device(b, dev) for _, b in zip(range(4),
                                                 trainer.train_input())]
  else:
    batches = [to_device(synthetic_batch(trainer.specs, labels,
                                         bs, seed=i), dev)
               for i in range(4)]
  for i in range(WARMUP_STEPS):
    trainer.train_step(batches[i % len(batches)])
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for i in range(args.steps):
    trainer.train_step(batches[i % len(batches)])
  torch.cuda.synchronize()
  plain_ms = (time.perf_counter() - t0) * 1e3 / args.steps

  t0 = time.perf_counter()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for i in range(args.steps):
      trainer.train_step(batches[i % len(batches)])
    torch.cuda.synchronize()
  wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

  events = prof.key_averages()
  kernels = [e for e in events if _device_us(e) > 0 and
             getattr(e, 'device_type', None) is not None and
             str(e.device_type).endswith('CUDA')]
  busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / args.steps
  if busy_ms <= 0:
    print('profile_step: the profiler recorded no device time',
          file=sys.stderr)
    return 1
  launches = sum(e.count for e in kernels) / args.steps
  print('card: %s' % card)
  print('%s train step, batch %d, EASYREC_PACKED_FUSED=%s, %d steps '
        'under the profiler' % (what, bs, fused, args.steps))
  print('wall %.3f ms/step (%.1f examples/s) without the profiler, %.3f '
        'with it; device busy %.3f ms/step; device idle %.1f%% of the '
        'unprofiled wall; %.0f kernel launches/step'
        % (plain_ms, bs / plain_ms * 1e3, wall_ms, busy_ms,
           100.0 * max(0.0, 1 - busy_ms / plain_ms), launches))
  print('top device kernels (ms/step, launches/step, name):')
  for e in sorted(kernels, key=_device_us, reverse=True)[:args.top]:
    print('  %9.4f  %6.1f  %s' % (_device_us(e) / 1e3 / args.steps,
                                  e.count / args.steps, e.key[:110]))
  ops = [e for e in events if e not in kernels and
         not e.key.startswith('ProfilerStep')]
  print('top host operators by self CPU time (ms/step, calls/step, name):')
  for e in sorted(ops, key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:args.top]:
    print('  %9.4f  %6.1f  %s' % (e.self_cpu_time_total / 1e3 / args.steps,
                                  e.count / args.steps, e.key[:110]))
  return 0


if __name__ == '__main__':
  sys.exit(main())
