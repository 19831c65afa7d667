#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (easyrec_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the result line:
  1. device  the card's name, count, and nvidia-smi's name and power limit;
  2. build   both CUDA kernels from easyrec_torch/csrc with nvcc for sm_90a
             (one nvcc per source, started together), with ptxas's report;
  3. kernels each kernel against its plain PyTorch version at the flagship
             shapes (a DummyInput batch of the Criteo DeepFM: 39 id slots
             per example at batch 4096, dim 32, 26M-row table), with its
             time from CUDA events beside its bound, the plain version's
             time and, for the segmented sum, index_add_'s;
  4. agree   a small DeepFM trains 3 steps on the card and on the CPU from
             the same weights and batches; losses and tables must agree;
  5. slice   the flagship config through easyrec_torch.main
             .train_and_evaluate at full width (num_steps cut to 20; eval
             runs DummyInput's cap of 50 batches), with every kernel's
             launch counter read around the run, then the steady-state
             train-step rate over pre-built synthetic batches.
Then one JSON line of kernel numbers, nvidia-smi's line, and as the last
line {"ok": true, "device": {...}}.
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and f32 outside the tensor
# cores; every bound below is computed from these and this run's inputs
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SLICE_STEPS = 20
RATE_STEPS = 20


def fail(msg):
  print('chip_smoke: FAIL: %s' % msg, file=sys.stderr, flush=True)
  sys.exit(1)


def log(msg):
  print(msg, flush=True)


def nvidia_smi_line():
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout
  return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps, flush):
  """Mean device time of fn() over reps launches, each after a write of a
  buffer larger than L2 so the call finds its inputs cold."""
  fn()
  torch.cuda.synchronize()
  total = 0.0
  for _ in range(reps):
    flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    total += start.elapsed_time(end)
  return total / reps


def bound_ms(nbytes, nops):
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = nops / F32_OPS_PER_S * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def phase_kernels(torch):
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.ops import packed_table as pt
  from easyrec_torch.optim.sparse import SparseAdam, pack_pair
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils import flagship

  dev = torch.device('cuda')
  trainer = Trainer(flagship.criteo_deepfm_config(), device='cuda')
  batch = next(iter(trainer.train_input()))
  packs = emb_ops.pack_ids(trainer.layout, to_device(batch, dev))
  (key, meta), = trainer.metas.items()
  used = trainer.layout.tables[key].used_dim
  ids = packs[key].reshape(-1)
  n, dim = ids.shape[0], meta.dim
  log('kernel shapes: table %s [%d, %d] f32, %d id slots, dim %d (%d used)'
      % (key, meta.rows, meta.width, n, dim, used))

  gen = torch.Generator(device=dev).manual_seed(1234)
  grads = torch.randn((n, dim), generator=gen, device=dev) * 1e-3
  grads[:, used:] = 0.0                 # alignment lanes carry no gradient
  grads[::97] = 0.0                     # zero-sum rows stay untouched
  table = torch.empty((meta.rows, meta.width), device=dev)
  trainer.layout.init_weights(key, 7, dev, table)
  for lo in range(0, meta.rows, 1 << 22):     # nonzero moments, chunked
    hi = min(meta.rows, lo + (1 << 22))
    m = torch.randn((hi - lo, dim), generator=gen, device=dev) * 1e-3
    v = torch.rand((hi - lo, dim), generator=gen, device=dev) * 1e-6
    table[lo:hi, dim:] = pack_pair(m, v)
  del m, v
  flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB

  sids, order, starts = pt.sort_segments(ids)
  n_seg = int((starts[:n] < n).sum())
  results = []

  # -- K1: segmented gradient sum, every EASYREC_GG_BF16 mode, bit-exact
  err1 = 0.0
  for mode in ('0', 'mix', '1'):
    uk, sk = pt.seg_sum(sids, order, starts, grads, meta.sentinel, mode)
    up, sp = pt.seg_sum_plain(sids, order, starts, grads, meta.sentinel,
                              mode)
    torch.cuda.synchronize()
    if not torch.equal(uk, up):
      fail('seg_sum mode %s: unique ids differ from the plain version'
           % mode)
    if not torch.equal(sk.view(torch.int32), sp.view(torch.int32)):
      fail('seg_sum mode %s: sums differ from the plain version (max %g)'
           % (mode, float((sk - sp).abs().max())))
    err1 = max(err1, float((sk - sp).abs().max()))
    log('seg_sum mode %-3s: %d segments, bit-exact against the plain '
        'version (tolerance 0: the same f32 additions in the same order)'
        % (mode, n_seg))
  k1_ms = cuda_ms(torch, lambda: pt.seg_sum(sids, order, starts, grads,
                                            meta.sentinel, '1'), 20, flush)
  k1_plain = cuda_ms(torch, lambda: pt.seg_sum_plain(
      sids, order, starts, grads, meta.sentinel, '1'), 2, flush)
  first = torch.ones(n, dtype=torch.bool, device=dev)
  first[1:] = sids[1:] != sids[:-1]
  seg_of_slot = torch.empty(n, dtype=torch.int64, device=dev)
  seg_of_slot[order] = torch.cumsum(first, 0) - 1
  acc = torch.zeros((n, dim), device=dev)
  k1_lib = cuda_ms(torch, lambda: acc.index_add_(0, seg_of_slot, grads),
                   20, flush)
  k1_bytes = (n + 1) * 8 + n * 8 + n * dim * 4 + n_seg * 8 + \
      n * 8 + n * dim * 4
  k1_bound, k1_by = bound_ms(k1_bytes, n * dim)
  log('seg_sum: %.4f ms, bound %.4f ms (%d bytes / 3.35 TB/s), plain '
      '%.3f ms, index_add_ %.4f ms' % (k1_ms, k1_bound, k1_bytes, k1_plain,
                                        k1_lib))
  results.append(dict(
      name='seg_sum', route='cuda', source='easyrec_torch/csrc/seg_sum.cu',
      replaces='easyrec_tpu/ops/packed_table.py:301', max_abs_err=err1,
      ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by,
      library_ms=k1_lib))

  # -- K2: row read-modify-write with compact lazy Adam, in place
  uids, gsum = pt.seg_sum(sids, order, starts, grads, meta.sentinel, '1')
  opt = SparseAdam()
  hypers = opt.hypers(torch.tensor(1e-3, device=dev),
                      torch.tensor(3, dtype=torch.int32, device=dev))
  orig = table.clone()
  ref = table.clone()
  pt.rmw_adam(table, uids, gsum, hypers, opt)
  pt.rmw_adam_plain(ref, uids, gsum, hypers, opt)
  torch.cuda.synchronize()
  live = uids < meta.rows
  touched_slot = live & (gsum != 0).any(dim=1)
  n_touched = int(touched_slot.sum())
  n_untouched = int((live & ~touched_slot).sum())
  rows = uids[touched_slot]
  touched = torch.zeros(meta.rows, dtype=torch.bool, device=dev)
  touched[rows] = True
  got = table.index_select(0, rows)
  want = ref.index_select(0, rows)
  wk, wp = got[:, :dim], want[:, :dim]
  ulp = (wk.contiguous().view(torch.int32).to(torch.int64) -
         wp.contiguous().view(torch.int32).to(torch.int64)).abs().max()
  if int(ulp) > 1:
    fail('rmw_adam: w differs from the plain version by %d ulp' % int(ulp))
  if not torch.equal(got[:, dim:].contiguous().view(torch.int32),
                     want[:, dim:].contiguous().view(torch.int32)):
    fail('rmw_adam: m/v bits differ from the plain version')
  changed = (table.view(torch.int32) != orig.view(torch.int32)).any(dim=1)
  if bool((changed & ~touched).any()):
    fail('rmw_adam: an untouched or sentinel row changed')
  if not bool(changed[touched].any()):
    fail('rmw_adam: no touched row changed')
  err2 = float((wk - wp).abs().max())
  del orig, ref, changed
  log('rmw_adam: %d touched rows, %d live untouched (zero-sum) slots, %d '
      'sentinel slots; m/v bit-exact, w within %d ulp (tolerance 1 ulp), '
      'untouched and sentinel rows byte-identical'
      % (n_touched, n_untouched, n - n_seg, int(ulp)))
  k2_ms = cuda_ms(torch, lambda: pt.rmw_adam(table, uids, gsum, hypers, opt),
                  20, flush)
  k2_plain = cuda_ms(torch, lambda: pt.rmw_adam_plain(table, uids, gsum,
                                                      hypers, opt), 3, flush)
  k2_bytes = n * 8 + 12 + n_seg * dim * 4 + n_touched * meta.width * 4 * 2
  k2_bound, k2_by = bound_ms(k2_bytes, n_touched * dim * 13)
  log('rmw_adam: %.4f ms, bound %.4f ms (%d bytes / 3.35 TB/s), plain '
      '%.3f ms' % (k2_ms, k2_bound, k2_bytes, k2_plain))
  results.append(dict(
      name='rmw_adam', route='cuda', source='easyrec_torch/csrc/rmw_adam.cu',
      replaces='easyrec_tpu/ops/packed_table.py:701', max_abs_err=err2,
      ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by,
      library_ms=None))
  del table, flush, acc
  torch.cuda.empty_cache()
  return results


def phase_agree(torch):
  """A small DeepFM: 3 steps on the card and on the CPU from the same
  weights and batches. The CPU path runs the kernels' plain versions,
  whose agreement with the JAX package the CPU tests hold."""
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils import flagship
  from easyrec_torch.utils.synthetic import synthetic_batch

  cfg = flagship.criteo_deepfm_config(batch_size=256, hash_bucket_size=1000,
                                      num_dense=3, num_cat=6)
  runs = {}
  for name in ('cpu', 'cuda'):
    t = Trainer(cfg, device=name)
    t.init_state()
    runs[name] = t
  for key, table in runs['cpu'].tables.items():
    runs['cuda'].tables[key].copy_(table)
  losses = {}
  for name, t in runs.items():
    dev = torch.device(name)
    losses[name] = []
    for step in range(3):
      batch = synthetic_batch(t.specs, list(t.ctx.label_fields), 256,
                              seed=step)
      losses[name].append(float(t.train_step(to_device(batch,
                                                        dev))['total_loss']))
  for a, b in zip(losses['cpu'], losses['cuda']):
    if not math.isfinite(b) or abs(a - b) > 1e-5 * max(1.0, abs(a)):
      fail('small DeepFM: losses differ on the card %s and the CPU %s'
           % (losses['cuda'], losses['cpu']))
  for key, table in runs['cpu'].tables.items():
    w_gpu = runs['cuda'].tables[key][:, :table.shape[1] // 2].cpu()
    err = float((w_gpu - table[:, :table.shape[1] // 2]).abs().max())
    # f32 reduction order differs between the card and the CPU; after 3
    # Adam steps of lr 1e-3 the weights agree far inside one step's size
    if err > 1e-5:
      fail('small DeepFM: table %s weights differ by %g' % (key, err))
  log('agree: small DeepFM, 3 steps, card vs CPU losses %s vs %s; table '
      'weights within 1e-5' % (losses['cuda'], losses['cpu']))


def phase_slice(torch, card):
  from easyrec_torch import main as main_lib
  from easyrec_torch.ops import kernels
  from easyrec_torch.train.trainer import to_device
  from easyrec_torch.utils import flagship
  from easyrec_torch.utils.synthetic import synthetic_batch

  cfg = flagship.criteo_deepfm_config()
  bs = int(cfg.data_config.batch_size)
  edits = {'train_config.num_steps': SLICE_STEPS,
           'train_config.log_step_count_steps': 5}
  torch.cuda.reset_peak_memory_stats()
  kernels.reset_launches()
  t0 = time.time()
  result = main_lib.train_and_evaluate(cfg, edit_config_json=edits,
                                     device='cuda')
  torch.cuda.synchronize()
  wall = time.time() - t0
  counts = kernels.launch_counts()
  losses = result['losses']
  log('slice: train_and_evaluate of the flagship DeepFM, %d steps in %.1f s '
      '(set-up, input and eval included)' % (result['global_step'], wall))
  log('slice losses: %s' % ['%.6f' % x for x in losses])
  log('slice eval: %s' % result.get('eval_metrics'))
  log('slice launches: %s' % counts)
  if result['global_step'] != SLICE_STEPS or len(losses) != SLICE_STEPS:
    fail('slice ran %d steps, %d asked' % (result['global_step'],
                                           SLICE_STEPS))
  if not all(math.isfinite(x) for x in losses):
    fail('slice: a loss is not finite')
  auc = result.get('eval_metrics', {}).get('auc')
  if auc is None or not 0.0 <= auc <= 1.0:
    fail('slice: eval AUC missing or out of range: %r' % auc)
  n_tables = len(result['trainer'].tables)
  for name, c in counts.items():
    if c != SLICE_STEPS * n_tables:
      fail('slice: kernel %s launched %d times in %d steps over %d tables'
           % (name, c, SLICE_STEPS, n_tables))
  peak = torch.cuda.max_memory_allocated()
  log('slice peak device memory: %.3f GB' % (peak / 1e9))

  trainer = result['trainer']
  batches = [to_device(synthetic_batch(trainer.specs,
                                       list(trainer.ctx.label_fields), bs,
                                       seed=100 + i), torch.device('cuda'))
             for i in range(4)]
  for b in batches[:3]:
    trainer.train_step(b)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for i in range(RATE_STEPS):
    out = trainer.train_step(batches[i % len(batches)])
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  if not math.isfinite(float(out['total_loss'])):
    fail('rate: a loss is not finite')
  log('train step (flagship DeepFM, batch %d, pre-built synthetic batches '
      'on the device): %.3f ms/step, %.1f examples/s on %s'
      % (bs, dt / RATE_STEPS * 1e3, RATE_STEPS * bs / dt, card))
  return counts


def main():
  if not os.path.isdir(os.path.join(HERE, 'easyrec_torch')):
    fail('easyrec_torch/ is not beside chip_smoke.py: run it from the '
         'root of a checkout')
  sys.path.insert(0, HERE)
  import torch
  if not torch.cuda.is_available():
    fail('torch.cuda.is_available() is False: this script needs a GPU')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  # 1. device
  name = torch.cuda.get_device_name(0)
  count = torch.cuda.device_count()
  smi = nvidia_smi_line()
  log('device: %s, count %d; nvidia-smi: %s; torch %s, CUDA %s'
      % (name, count, smi, torch.__version__, torch.version.cuda))
  card = '%s (nvidia-smi: %s)' % (name, smi)

  # 2. build
  from easyrec_torch.ops import kernels
  t0 = time.time()
  reports = kernels.build_all(verbose=True)
  log('build: %d kernels in %.1f s' % (len(reports), time.time() - t0))
  for kname, report in reports.items():
    for line in report.splitlines():
      if line.strip():
        log('  [%s] %s' % (kname, line.strip()))
  log('kernels: %s' % ', '.join(k.name for k in kernels.ALL))

  # 3-5
  results = phase_kernels(torch)
  phase_agree(torch)
  counts = phase_slice(torch, card)
  for r in results:
    r['launches'] = counts[r['name']]
  keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
          'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
  print(json.dumps({'kernels': [{k: r[k] for k in keys} for r in results]}))
  print(smi)
  print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                           'count': count}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
