#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (easyrec_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the result line:
  1. device  the card's name, count, and nvidia-smi's name and power limit;
  2. build   the three CUDA kernels from easyrec_torch/csrc with nvcc for
             sm_90a (one nvcc per source, started together), with ptxas's
             report;
  3. kernels each kernel against its plain PyTorch version on the card:
             K1 and K2 at the flagship shapes (a DummyInput batch of the
             Criteo DeepFM: 39 id slots per example at batch 4096, dim 32,
             26M-row table), K3 at the flagship shape and at the Taobao
             DIN's (a synthetic batch: 115 id slots per example at batch
             4096, two padding segments of ~100k slots, dim 16, 620k-row
             table), with times from CUDA events beside bounds, the plain
             versions' times and the library yardsticks;
  4. agree   a small DeepFM (K1 + K2) and a small DIN (K3) train 3 steps on
             the card and on the CPU from the same weights and batches;
             losses and tables must agree;
  5. din     the Taobao DIN config through easyrec_torch.main
             .train_and_evaluate at full width with EASYREC_PACKED_FUSED=1
             (num_steps cut to 20; eval runs DummyInput's cap of 50
             batches): K3 must launch once per step and table, K1 and K2
             not at all; then the steady-state train-step rate over
             pre-built synthetic batches;
  6. deepfm  the flagship config the same way, unfused: K1 and K2 once per
             step and table, K3 not at all; then its rate.
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
  del orig, ref, changed, touched
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
  del acc, uids, gsum

  # -- K3 at the flagship shape (13 segments of 4,096 slots: two-level)
  _, _, err3f = check_fused(torch, pt, table, sids, order, starts, grads,
                            hypers, opt, 'flagship')
  k3f_ms = cuda_ms(torch, lambda: pt.rmw_fused_adam(
      table, sids, order, starts, grads, hypers, opt), 20, flush)
  log('rmw_fused_adam at the flagship shape: %.4f ms (K1 + K2 above: %.4f '
      'ms)' % (k3f_ms, k1_ms + k2_ms))
  del table, flush, grads
  torch.cuda.empty_cache()
  k3 = phase_kernel_din(torch)
  k3['max_abs_err'] = max(k3['max_abs_err'], err3f)
  results.append(k3)
  return results


def check_fused(torch, pt, table, sids, order, starts, grads, hypers, opt,
                what):
  """K3 and its plain version from the same table: w, m and v must agree
  bit for bit (the same f32 additions in the same order, the same IEEE
  Adam), and every row whose segment sums to zero, that no id names, or
  that lies outside the table keeps its bytes. Returns the number of
  touched rows, the number of live segments and the largest |w| difference
  between the kernel and its plain version."""
  n = grads.shape[0]
  rows = table.shape[0]
  orig = table.clone()
  ref = table.clone()
  pt.rmw_fused_adam(table, sids, order, starts, grads, hypers, opt)
  pt.rmw_fused_adam_plain(ref, sids, order, starts, grads, hypers, opt)
  torch.cuda.synchronize()
  if not torch.equal(table.view(torch.int32), ref.view(torch.int32)):
    bad = int((table.view(torch.int32) != ref.view(torch.int32)).any(dim=1)
              .sum())
    fail('rmw_fused_adam (%s): %d rows differ from the plain version'
         % (what, bad))
  dim = table.shape[1] // 2
  err = float((table[:, :dim] - ref[:, :dim]).abs().max())
  del ref
  sums = pt.segment_sums_by_chunk(order, starts, grads)
  live = starts[:n] < n
  nz = live & (sums != 0).any(dim=1)
  uids = sids[starts[:n].clamp(max=n - 1)]
  touched = torch.zeros(rows, dtype=torch.bool, device=table.device)
  touched[uids[nz & (uids < rows)]] = True
  changed = (table.view(torch.int32) != orig.view(torch.int32)).any(dim=1)
  if bool((changed & ~touched).any()):
    fail('rmw_fused_adam (%s): an untouched row changed' % what)
  if not bool(changed[touched].all()):
    fail('rmw_fused_adam (%s): a touched row kept its bytes' % what)
  lens = starts[1:] - starts[:n]
  n_touched = int(touched.sum())
  log('rmw_fused_adam (%s): %d slots, %d segments (%d longer than %d '
      'slots, the longest %d), %d touched rows, %d live zero-sum segments; '
      'w, m and v bit-exact against the plain version (tolerance 0), '
      'untouched rows byte-identical'
      % (what, n, int(live.sum()), int((lens > pt.FUSED_CHUNK).sum()),
         pt.FUSED_CHUNK, int(lens.max()), n_touched,
         int((live & ~nz).sum())))
  return n_touched, int(live.sum()), err


def phase_kernel_din(torch):
  """K3 at the shape the DIN path gives it: the pack of one synthetic
  batch of the full-width Taobao DIN (lengths uniform in 1..50, so each of
  the two sequence features' padding id 0 collects ~100k slots)."""
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.ops import packed_table as pt
  from easyrec_torch.optim.sparse import SparseAdam, pack_pair
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils import flagship
  from easyrec_torch.utils.synthetic import synthetic_batch

  dev = torch.device('cuda')
  trainer = Trainer(flagship.taobao_din_config(), device='cuda')
  bs = int(trainer.data_config.batch_size)
  batch = synthetic_batch(trainer.specs, list(trainer.ctx.label_fields), bs,
                          seed=0)
  packs = emb_ops.pack_ids(trainer.layout, to_device(batch, dev))
  (key, meta), = trainer.metas.items()
  ids = packs[key].reshape(-1)
  n, dim = ids.shape[0], meta.dim
  log('K3 DIN shape: table %s [%d, %d] f32, %d id slots, dim %d'
      % (key, meta.rows, meta.width, n, dim))
  gen = torch.Generator(device=dev).manual_seed(4321)
  grads = torch.randn((n, dim), generator=gen, device=dev) * 1e-3
  grads[::97] = 0.0
  table = torch.empty((meta.rows, meta.width), device=dev)
  trainer.layout.init_weights(key, 7, dev, table)
  table[:, dim:] = pack_pair(
      torch.randn((meta.rows, dim), generator=gen, device=dev) * 1e-3,
      torch.rand((meta.rows, dim), generator=gen, device=dev) * 1e-6)
  flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
  opt = SparseAdam()
  hypers = opt.hypers(torch.tensor(1e-3, device=dev),
                      torch.tensor(3, dtype=torch.int32, device=dev))
  sids, order, starts = pt.sort_segments(ids)
  n_touched, n_live, err3 = check_fused(torch, pt, table, sids, order,
                                        starts, grads, hypers, opt, 'DIN')
  k3_ms = cuda_ms(torch, lambda: pt.rmw_fused_adam(
      table, sids, order, starts, grads, hypers, opt), 20, flush)
  k3_plain = cuda_ms(torch, lambda: pt.rmw_fused_adam_plain(
      table, sids, order, starts, grads, hypers, opt), 2, flush)
  # library yardstick for the sum half: index_add_ (atomics, no fixed
  # order) into a zero [rows, dim] buffer, then K2 over every row
  acc = torch.zeros((meta.rows, dim), device=dev)
  every_row = torch.arange(meta.rows, device=dev)

  def library():
    acc.zero_()
    acc.index_add_(0, ids, grads)
    pt.rmw_adam(table, every_row, acc, hypers, opt)

  k3_lib = cuda_ms(torch, library, 20, flush)
  # the unfused path at the same shape, for comparison: K1 walks each
  # padding segment with one warp
  def unfused():
    uids, gsum = pt.seg_sum(sids, order, starts, grads, meta.sentinel, '0')
    pt.rmw_adam(table, uids, gsum, hypers, opt)

  k12_ms = cuda_ms(torch, unfused, 5, flush)
  map_ms = cuda_ms(torch, lambda: pt.fused_chunk_map(starts, n), 20, flush)
  # gradients, order and starts read whole, the first sid of each live
  # segment, hypers, and each touched row read and written
  k3_bytes = n * dim * 4 + 2 * n * 8 + 8 + n_live * 8 + 12 + \
      n_touched * meta.width * 4 * 2
  k3_bound, k3_by = bound_ms(k3_bytes, n * dim + n_touched * dim * 13)
  log('rmw_fused_adam (DIN): %.4f ms, bound %.4f ms (%d bytes / 3.35 '
      'TB/s), plain %.3f ms, index_add_ + K2 over all rows (closest '
      'library call for the sum half) %.4f ms; K1 (mode 0) + K2 at this '
      'shape %.4f ms; the wrapper\'s chunk map (PyTorch ops, inside K3\'s '
      'time) %.4f ms' % (k3_ms, k3_bound, k3_bytes, k3_plain, k3_lib,
                         k12_ms, map_ms))
  del table, flush, acc, grads
  torch.cuda.empty_cache()
  return dict(
      name='rmw_fused_adam', route='cuda',
      source='easyrec_torch/csrc/rmw_fused_adam.cu',
      replaces='easyrec_tpu/ops/packed_table.py:1024', max_abs_err=err3,
      ms=k3_ms, plain_ms=k3_plain, bound_ms=k3_bound, bound_by=k3_by,
      library_ms=k3_lib)


def phase_agree(torch, what, cfg, fused):
  """A small model: 3 steps on the card and on the CPU from the same
  weights and batches. The CPU path runs the kernels' plain versions,
  whose agreement with the JAX package the CPU tests hold."""
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils.synthetic import synthetic_batch

  os.environ['EASYREC_PACKED_FUSED'] = fused
  bs = int(cfg.data_config.batch_size)
  runs = {}
  for name in ('cpu', 'cuda'):
    t = Trainer(cfg, device=name)
    t.init_state()
    runs[name] = t
  runs['cuda'].model.load_state_dict(runs['cpu'].model.state_dict())
  for key, table in runs['cpu'].tables.items():
    runs['cuda'].tables[key].copy_(table)
  losses = {}
  for name, t in runs.items():
    dev = torch.device(name)
    losses[name] = []
    for step in range(3):
      batch = synthetic_batch(t.specs, list(t.ctx.label_fields), bs,
                              seed=step)
      losses[name].append(float(t.train_step(to_device(batch,
                                                        dev))['total_loss']))
  for a, b in zip(losses['cpu'], losses['cuda']):
    if not math.isfinite(b) or abs(a - b) > 1e-5 * max(1.0, abs(a)):
      fail('small %s: losses differ on the card %s and the CPU %s'
           % (what, losses['cuda'], losses['cpu']))
  for key, table in runs['cpu'].tables.items():
    w_gpu = runs['cuda'].tables[key][:, :table.shape[1] // 2].cpu()
    err = float((w_gpu - table[:, :table.shape[1] // 2]).abs().max())
    # f32 reduction order differs between the card and the CPU; after 3
    # Adam steps of lr 1e-3 the weights agree far inside one step's size
    if err > 1e-5:
      fail('small %s: table %s weights differ by %g' % (what, key, err))
  log('agree: small %s, 3 steps, card vs CPU losses %s vs %s; table '
      'weights within 1e-5' % (what, losses['cuda'], losses['cpu']))


def phase_slice(torch, card, what, cfg, fused, path_kernels):
  """train_and_evaluate of `cfg` at full width, SLICE_STEPS steps, with
  every launch counter set to 0 just before and read just after: each
  kernel of `path_kernels` must launch once per step and table, every
  other kernel not at all. Then the steady-state train-step rate over
  pre-built synthetic batches. Returns the counts."""
  from easyrec_torch import main as main_lib
  from easyrec_torch.ops import kernels
  from easyrec_torch.train.trainer import to_device
  from easyrec_torch.utils.synthetic import synthetic_batch

  os.environ['EASYREC_PACKED_FUSED'] = fused
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
  log('%s: train_and_evaluate, EASYREC_PACKED_FUSED=%s, %d steps in %.1f s '
      '(set-up, input and eval included)'
      % (what, fused, result['global_step'], wall))
  log('%s losses: %s' % (what, ['%.6f' % x for x in losses]))
  log('%s eval: %s' % (what, result.get('eval_metrics')))
  log('%s launches: %s' % (what, counts))
  if result['global_step'] != SLICE_STEPS or len(losses) != SLICE_STEPS:
    fail('%s ran %d steps, %d asked' % (what, result['global_step'],
                                        SLICE_STEPS))
  if not all(math.isfinite(x) for x in losses):
    fail('%s: a loss is not finite' % what)
  auc = result.get('eval_metrics', {}).get('auc')
  if auc is None or not 0.0 <= auc <= 1.0:
    fail('%s: eval AUC missing or out of range: %r' % (what, auc))
  n_tables = len(result['trainer'].tables)
  for name, c in counts.items():
    want = SLICE_STEPS * n_tables if name in path_kernels else 0
    if c != want:
      fail('%s: kernel %s launched %d times in %d steps over %d tables, '
           '%d expected' % (what, name, c, SLICE_STEPS, n_tables, want))
  peak = torch.cuda.max_memory_allocated()
  log('%s peak device memory: %.3f GB' % (what, peak / 1e9))

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
    fail('%s rate: a loss is not finite' % what)
  log('train step (%s, batch %d, pre-built synthetic batches on the '
      'device): %.3f ms/step, %.1f examples/s on %s'
      % (what, bs, dt / RATE_STEPS * 1e3, RATE_STEPS * bs / dt, card))
  del result, trainer, batches
  torch.cuda.empty_cache()
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

  # 3-6
  from easyrec_torch.utils import flagship
  results = phase_kernels(torch)
  phase_agree(torch, 'DeepFM', flagship.criteo_deepfm_config(
      batch_size=256, hash_bucket_size=1000, num_dense=3, num_cat=6), '0')
  phase_agree(torch, 'DIN', flagship.taobao_din_config(
      batch_size=256, seq_len=8), '1')
  din = phase_slice(torch, card, 'Taobao DIN', flagship.taobao_din_config(),
                    '1', ('rmw_fused_adam',))
  deepfm = phase_slice(torch, card, 'flagship DeepFM',
                       flagship.criteo_deepfm_config(), '0',
                       ('seg_sum', 'rmw_adam'))
  for r in results:
    r['launches'] = (din if r['name'] == 'rmw_fused_adam'
                     else deepfm)[r['name']]
  keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
          'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
  print(json.dumps({'kernels': [{k: r[k] for k in keys} for r in results]}))
  print(smi)
  print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                           'count': count}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
