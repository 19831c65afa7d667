#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (easyrec_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the result line:
  1. device  the card's name, count, and nvidia-smi's name and power limit;
  2. build   the five CUDA kernels from easyrec_torch/csrc with nvcc for
             sm_90a (one nvcc per source, started together), with ptxas's
             report;
  3. kernels each kernel against its plain PyTorch version on the card:
             K1 at the flagship shape (a DummyInput batch of the Criteo
             DeepFM: 39 id slots per example at batch 4096, dim 32, 26M-row
             table) and the Taobao DIN's (a synthetic batch: 115 id slots
             per example at batch 4096, two padding segments of ~100k
             slots, dim 16, 620k-row table); K2 with every block math
             (sgd, momentum, Adagrad, 3-part Adam, compact Adam, FTRL) at
             the flagship shape; K3 with every block math at the DIN shape
             and at dim 256; K2 and K3 with the EV maths (ev_add, ev_set)
             on the [210,002, 1] aux table of the EV sample (phase 10's
             shape); all bit-exact, with times from CUDA events beside
             bounds, the plain versions' times and the library
             yardsticks;
  4. groups  K4 (group push) and K5 (group RMW) against their plain
             versions at the ported benchmarks' shapes (K4: 106,496 slots
             into [406,252, 8, 128]; K5: 98,304 groups of a 5 GB
             [406,252, 8, 384] table, and the 106,496 slots with gg),
             with times; then every easyrec_torch.benchmarks main() at its
             full shape and experimental_packed_update at a small one:
             every correctness line must read true, K4 and K5 must
             launch, K1-K3 must not;
  5. agree   a small DeepFM trains 3 steps on the card and on the CPU from
             the same weights and batches once per optimizer message (Adam
             compact and 3-part, AdamW, Adagrad, momentum, momentumW,
             RMSProp, FTRL), unfused (K1 + K2) and fused (K3), and a small
             DIN (K3): losses and table weights must agree, and K2/K3 must
             launch with the optimizer's block math;
  6. din     the Taobao DIN config through easyrec_torch.main
             .train_and_evaluate at full width with EASYREC_PACKED_FUSED=1
             (num_steps cut to 20; eval runs DummyInput's cap of 50
             batches): K3 (compact Adam) must launch once per step and
             table, K1 and K2 not at all; then the steady-state train-step
             rate over pre-built synthetic batches;
  7. deepfm  the flagship config the same way, unfused: K1 and K2 (compact
             Adam) once per step and table, K3 not at all; then its rate;
  8. adagrad the flagship with Adagrad tables and Adam dense weights
             (flagship.criteo_deepfm_adagrad_config; the table is [w |
             accum], 6.66 GB) the same way: K1 and K2 (Adagrad) once per
             step and table, K3 not at all; then its rate.
K4 and K5 must launch 0 times in 6-8.
  9. ckpt    the full-width Taobao DIN (K3), unshuffled: a Trainer fits 20
             steps with saves at 10 and 20; a fresh Trainer on the same
             model_dir, its step-20 checkpoint removed, restores step 10 and
             fits to 20, and must equal the uninterrupted run bit for bit
             (step, tables, model, dense optimizer); then a timed save and
             restore, with the checkpoint's size;
 10. ev      samples/deepfm_ev_params.config at its published widths
             through train_and_evaluate, cut to 40 steps with a save (and
             TTL sweep) every 10 and steps_to_live 10, on generated data
             whose ids move halfway: K1 + K2 and K3, each on the card and
             the CPU; ev_add and ev_set once a step each, rows admitted,
             slots masked and rows evicted above zero, counters exact card
             against CPU (phase_ev says how the tables are held);
 11. kernel-only K1, K2 (compact Adam and Adagrad) at the flagship shape,
             K3 and K1 + K2 at the DIN shape and K2 and K3 with the EV maths
             at the EV shape, their kernels alone, timed by torch.profiler
             on the inputs of phase 3, after the slices because the
             profiler stays hooked into the process once it has traced the
             card.
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


def kernel_ms(torch, fn, reps, flush):
  """Device time of the kernels fn() launches, per call, from
  torch.profiler: {kernel name: ms per call} summed over its launches,
  with the L2 flush before each call (and the flush's own kernel) left
  out of the sum. The wrapper's host gaps between its launches are not in
  it. Returns {} where the profiler records no device time."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  def device_us(body):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      body()
      torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
      if e.device_type == DeviceType.CUDA:
        for name in ('self_device_time_total', 'self_cuda_time_total'):
          t = getattr(e, name, None)
          if t is not None:
            out[e.key] = out.get(e.key, 0.0) + float(t)
            break
    return out

  fn()
  torch.cuda.synchronize()
  skip = set(device_us(flush.zero_))

  def body():
    for _ in range(reps):
      flush.zero_()
      fn()

  return {k: v / 1e3 / reps for k, v in device_us(body).items()
          if k not in skip and v > 0}


# wrapper calls whose kernels torch.profiler times after the slices: once
# the profiler has traced the card it stays hooked into the process, so the
# step rates are taken first. (label, event ms, bound ms, call, a function
# that makes the call's inputs on the card)
KERNEL_ONLY = []


def queue_kernel_only(label, event_ms, bound, call, make=None, **tensors):
  """Queue `call` for phase_kernel_only: on `make()`'s inputs, or on copies
  of `tensors` kept on the host until then."""
  if make is None:
    host = {k: v.cpu() for k, v in tensors.items()}
    make = lambda: {k: v.cuda() for k, v in host.items()}  # noqa: E731
  KERNEL_ONLY.append((label, event_ms, bound, call, make))


def phase_kernel_only(torch):
  """The queued wrapper calls again, on their inputs remade on the card,
  under torch.profiler: the kernels' own device time beside the event
  time of the whole wrapper and the bound."""
  flush = torch.empty(64 << 20, dtype=torch.float32, device='cuda')
  for label, event_ms, bound, call, make in KERNEL_ONLY:
    dev = make()
    total = log_kernel_ms(label, kernel_ms(torch, lambda: call(**dev), 20,
                                           flush), event_ms)
    if total is not None:
      log('%s: kernels only %.2f x the bound (%.4f ms)'
          % (label, total / bound, bound))
    del dev
    torch.cuda.empty_cache()
  del flush
  torch.cuda.empty_cache()


def log_kernel_ms(what, by_name, event_ms):
  """One line: the kernels' summed device time beside the event time of
  the whole wrapper, and each kernel's share."""
  if not by_name:
    log('%s: kernel-only time not measured (the profiler recorded no '
        'device time); event time %.4f ms' % (what, event_ms))
    return None
  total = sum(by_name.values())
  log('%s: kernels only %.4f ms a call (profiler), event time of the '
      'wrapper %.4f ms; %s' % (what, total, event_ms, '; '.join(
          '%s %.4f' % (k[:60], v) for k, v in sorted(
              by_name.items(), key=lambda kv: -kv[1]))))
  return total


def block_maths():
  """Every block math of K2 and K3, as the kernel phases drive it: (name,
  optimizer, compact layout, f32 operations an element of the math, for
  the bound). Constants off their defaults so every term of the math
  runs (Adam's weight decay, FTRL's l1, l2 and shrinkage); the flagship's
  compact Adam and the Adagrad of its Adagrad-tables path at theirs."""
  from easyrec_torch.optim import sparse
  return [('sgd', sparse.SparseSGD(), False, 2),
          ('momentum', sparse.SparseMomentum(0.8), False, 4),
          ('adagrad', sparse.SparseAdagrad(), False, 8),
          ('adam', sparse.SparseAdam(weight_decay=0.01), False, 17),
          ('compact_adam', sparse.SparseAdam(), True, 14),
          ('ftrl', sparse.SparseFtrl(l1=0.01, l2=0.02, l2_shrinkage=0.05),
           False, 20)]


def math_table(torch, layout, key, rows, dim, opt, compact, gen):
  """A [rows, P*dim] table of `opt`'s layout on the card: the layout's
  initial weights, then slots drawn chunk by chunk (Adam moments small
  with v >= 0, accumulators at least 0.1, FTRL's z of either sign)."""
  from easyrec_torch.optim.sparse import pack_pair
  dev = torch.device('cuda')
  width = (2 if compact else opt.n_parts) * dim
  table = torch.empty((rows, width), device=dev)
  if layout is not None:
    layout.init_weights(key, 7, dev, table)
  else:
    table[:, :dim] = torch.randn((rows, dim), generator=gen, device=dev)
  for lo in range(0, rows, 1 << 22):
    hi = min(rows, lo + (1 << 22))
    slots = []
    for name in opt.slot_names:
      shape = (hi - lo, dim)
      slots.append(
          torch.rand(shape, generator=gen, device=dev) * 1e-6
          if name == 'v' else
          0.1 + torch.rand(shape, generator=gen, device=dev) * 0.5
          if name == 'accum' else
          torch.randn(shape, generator=gen, device=dev) *
          (0.05 if name == 'z' else 1e-3))
    if compact:
      slots = [pack_pair(slots[0], slots[1])]
    for p, part in enumerate(slots, 1):
      table[lo:hi, p * dim:(p + 1) * dim] = part
  return table


def phase_kernels(torch):
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.ops import packed_table as pt
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
  del acc
  k1_bytes = (n + 1) * 8 + n * 8 + n * dim * 4 + n_seg * 8 + \
      n * 8 + n * dim * 4
  k1_bound, k1_by = bound_ms(k1_bytes, n * dim)
  log('seg_sum: %.4f ms, bound %.4f ms (%d bytes / 3.35 TB/s), plain '
      '%.3f ms, index_add_ %.4f ms; %s than index_add_'
      % (k1_ms, k1_bound, k1_bytes, k1_plain, k1_lib,
         'no slower' if k1_ms <= k1_lib else 'SLOWER'))
  sentinel = meta.sentinel
  queue_kernel_only(
      'seg_sum (flagship, mode 1)', k1_ms, k1_bound,
      lambda sids, order, starts, grads: pt.seg_sum(sids, order, starts,
                                                    grads, sentinel, '1'),
      sids=sids, order=order, starts=starts, grads=grads)
  results.append(dict(
      name='seg_sum', route='cuda', source='easyrec_torch/csrc/seg_sum.cu',
      replaces='easyrec_tpu/ops/packed_table.py:301', max_abs_err=err1,
      ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by,
      library_ms=k1_lib))

  # -- K2: row read-modify-write, every block math, at the flagship shape
  uids, gsum = pt.seg_sum(sids, order, starts, grads, meta.sentinel, '1')
  live = uids < meta.rows
  touched_slot = live & (gsum != 0).any(dim=1)
  n_touched = int(touched_slot.sum())
  rows = uids[touched_slot]
  log('rmw_rows inputs: %d touched rows, %d live untouched (zero-sum) '
      'slots, %d sentinel slots' % (n_touched,
                                    int((live & ~touched_slot).sum()),
                                    n - n_seg))
  k2_compact = None
  for name, opt, compact, ops in block_maths():
    table = math_table(torch, trainer.layout, key, meta.rows, dim, opt,
                       compact, gen)
    width = table.shape[1]
    hypers = opt.hypers(torch.tensor(1e-3, device=dev),
                        torch.tensor(3, dtype=torch.int32, device=dev))
    before = table.index_select(0, rows)
    ref = table.clone()
    pt.rmw_rows(table, uids, gsum, hypers, opt)
    pt.rmw_rows_plain(ref, uids, gsum, hypers, opt)
    torch.cuda.synchronize()
    # the plain version writes only the touched rows, so equal tables
    # leave every untouched and sentinel row byte-identical too
    if not torch.equal(table.view(torch.int32), ref.view(torch.int32)):
      bad = int((table.view(torch.int32) != ref.view(torch.int32))
                .any(dim=1).sum())
      fail('rmw_rows (%s): %d rows differ from the plain version'
           % (name, bad))
    err = float((table[:, :dim] - ref[:, :dim]).abs().max())
    del ref
    after = table.index_select(0, rows)
    if not bool((after.view(torch.int32) != before.view(torch.int32))
                .any(dim=1).all()):
      fail('rmw_rows (%s): a touched row kept its bytes' % name)
    del before, after
    ms = cuda_ms(torch, lambda: pt.rmw_rows(table, uids, gsum, hypers,
                                            opt), 20, flush)
    plain = cuda_ms(torch, lambda: pt.rmw_rows_plain(table, uids, gsum,
                                                     hypers, opt), 3, flush)
    nbytes = n * 8 + opt.n_hypers * 4 + n_seg * dim * 4 + \
        n_touched * width * 4 * 2
    bound, by = bound_ms(nbytes, n_touched * dim * ops)
    log('rmw_rows (%s, [%d, %d]): bit-exact against the plain version '
        '(tolerance 0); %.4f ms, bound %.4f ms (%d bytes / 3.35 TB/s, %.2f '
        'x the compact Adam row), %.2f x the bound, plain %.3f ms'
        % (name, meta.rows, width, ms, bound, nbytes,
           width / (2.0 * dim), ms / bound, plain))
    queue_k2(torch, pt, trainer.layout, key, meta, name, opt, compact, ms,
             bound, uids, gsum, hypers)
    if name == 'compact_adam':
      k2_compact = (table, ms, bound, opt, hypers)
    else:
      del table
    torch.cuda.empty_cache()
    results.append(dict(
        name='rmw_rows/%s' % name, route='cuda',
        source='easyrec_torch/csrc/rmw_rows.cu',
        replaces='easyrec_tpu/ops/packed_table.py:701', max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
        library_ms=None))

  # -- K3 (compact Adam) at the flagship shape: 13 segments of 4,096 slots
  table, k2_ms, k2_bound, opt, hypers = k2_compact
  _, _, err3f = check_fused(torch, pt, table, sids, order, starts, grads,
                            hypers, opt, 'flagship, compact_adam')
  k3f_ms = cuda_ms(torch, lambda: pt.rmw_fused(
      table, sids, order, starts, grads, hypers, opt), 20, flush)
  log('rmw_fused (compact_adam) at the flagship shape: %.4f ms (K1 + K2 '
      'above: %.4f ms)' % (k3f_ms, k1_ms + k2_ms))
  del table, flush, grads, uids, gsum
  torch.cuda.empty_cache()
  k3 = phase_kernel_din(torch)
  for r in k3:
    if r['name'] == 'rmw_fused/compact_adam':
      r['max_abs_err'] = max(r['max_abs_err'], err3f)
  results[0]['max_abs_err'] = max(err1, k3[0].pop('seg_sum_din_err'))
  return results + k3


def queue_k2(torch, pt, layout, key, meta, name, opt, compact, ms, bound,
             uids, gsum, hypers):
  """Queue K2 at the flagship shape for the kernel-only phase; its 26M-row
  table is drawn anew on the card then, not kept on the host."""
  host = dict(uids=uids.cpu(), gsum=gsum.cpu(), hypers=hypers.cpu())

  def make():
    gen = torch.Generator(device='cuda').manual_seed(99)
    return dict(table=math_table(torch, layout, key, meta.rows, meta.dim,
                                 opt, compact, gen),
                **{k: v.cuda() for k, v in host.items()})

  queue_kernel_only('rmw_rows (flagship, %s)' % name, ms, bound,
                    lambda table, uids, gsum, hypers: pt.rmw_rows(
                        table, uids, gsum, hypers, opt), make=make)


def check_fused(torch, pt, table, sids, order, starts, grads, hypers, opt,
                what):
  """K3 and its plain version from the same table: every part must agree
  bit for bit (the same f32 additions in the same order, the same IEEE
  block math), and every row whose segment sums to zero, that no id names,
  or that lies outside the table keeps its bytes (the plain version writes
  only touched rows). Returns the number of touched rows, the number of
  live segments and the largest |w| difference between the kernel and its
  plain version."""
  n, dim = grads.shape
  rows = table.shape[0]
  sums = pt.segment_sums_by_chunk(order, starts, grads)
  live = starts[:n] < n
  nz = live & (sums != 0).any(dim=1)
  uids = sids[starts[:n].clamp(max=n - 1)]
  touched = torch.zeros(rows, dtype=torch.bool, device=table.device)
  touched[uids[nz & (uids < rows)]] = True
  del sums
  idx = torch.nonzero(touched)[:, 0]
  before = table.index_select(0, idx)
  ref = table.clone()
  pt.rmw_fused(table, sids, order, starts, grads, hypers, opt)
  pt.rmw_fused_plain(ref, sids, order, starts, grads, hypers, opt)
  torch.cuda.synchronize()
  if not torch.equal(table.view(torch.int32), ref.view(torch.int32)):
    bad = int((table.view(torch.int32) != ref.view(torch.int32)).any(dim=1)
              .sum())
    fail('rmw_fused (%s): %d rows differ from the plain version'
         % (what, bad))
  err = float((table[:, :dim] - ref[:, :dim]).abs().max())
  del ref
  after = table.index_select(0, idx)
  if not bool((after.view(torch.int32) != before.view(torch.int32))
              .any(dim=1).all()):
    fail('rmw_fused (%s): a touched row kept its bytes' % what)
  lens = starts[1:] - starts[:n]
  n_touched = int(idx.shape[0])
  log('rmw_fused (%s): %d slots, %d segments (%d longer than %d slots, the '
      'longest %d), %d touched rows, %d live zero-sum segments; every part '
      'bit-exact against the plain version (tolerance 0), untouched rows '
      'byte-identical'
      % (what, n, int(live.sum()), int((lens > pt.FUSED_CHUNK).sum()),
         pt.FUSED_CHUNK, int(lens.max()), n_touched,
         int((live & ~nz).sum())))
  return n_touched, int(live.sum()), err


def phase_kernel_din(torch):
  """K3 at the shape the DIN path gives it, for every block math: the pack
  of one synthetic batch of the full-width Taobao DIN (lengths uniform in
  1..50, so each of the two sequence features' padding id 0 collects ~100k
  slots), at the DIN's dim 16 and at dim 256 (the widest compact Adam the
  JAX package's fused kernel takes). Returns one result record a math at
  dim 16, the compact Adam's first."""
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.ops import packed_table as pt
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
  n = ids.shape[0]
  log('K3 DIN shape: table %s [%d, %d] f32, %d id slots, dim %d'
      % (key, meta.rows, meta.width, n, meta.dim))
  gen = torch.Generator(device=dev).manual_seed(4321)
  flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
  sids, order, starts = pt.sort_segments(ids)
  maths = sorted(block_maths(), key=lambda m: m[0] != 'compact_adam')
  results = []
  for dim in (meta.dim, 256):
    grads = torch.randn((n, dim), generator=gen, device=dev) * 1e-3
    grads[::97] = 0.0
    if dim == meta.dim:
      err1 = 0.0
      for mode in ('0', 'mix', '1'):
        uk, sk = pt.seg_sum(sids, order, starts, grads, meta.sentinel, mode)
        up, sp = pt.seg_sum_plain(sids, order, starts, grads, meta.sentinel,
                                  mode)
        torch.cuda.synchronize()
        if not (torch.equal(uk, up) and
                torch.equal(sk.view(torch.int32), sp.view(torch.int32))):
          fail('seg_sum mode %s at the DIN shape: differs from the plain '
               'version (max %g)' % (mode, float((sk - sp).abs().max())))
        err1 = max(err1, float((sk - sp).abs().max()))
      del uk, sk, up, sp
      log('seg_sum at the DIN shape: bit-exact against the plain version '
          'in modes 0, mix and 1 (tolerance 0)')
    for name, opt, compact, ops in maths:
      table = math_table(torch, trainer.layout if dim == meta.dim else None,
                         key, meta.rows, dim, opt, compact, gen)
      hypers = opt.hypers(torch.tensor(1e-3, device=dev),
                          torch.tensor(3, dtype=torch.int32, device=dev))
      what = '%s, DIN shape, dim %d' % (name, dim)
      n_touched, n_live, err = check_fused(torch, pt, table, sids, order,
                                           starts, grads, hypers, opt, what)
      ms = cuda_ms(torch, lambda: pt.rmw_fused(
          table, sids, order, starts, grads, hypers, opt), 20, flush)
      plain = cuda_ms(torch, lambda: pt.rmw_fused_plain(
          table, sids, order, starts, grads, hypers, opt), 2, flush)
      # library yardstick for the sum half: index_add_ (atomics, no fixed
      # order) into a zero [rows, dim] buffer, then K2 over every row
      acc = torch.zeros((meta.rows, dim), device=dev)
      every_row = torch.arange(meta.rows, device=dev)

      def library():
        acc.zero_()
        acc.index_add_(0, ids, grads)
        pt.rmw_rows(table, every_row, acc, hypers, opt)

      lib = cuda_ms(torch, library, 20, flush)
      del acc, every_row
      # gradients, order and starts read whole, the first sid of each live
      # segment, hypers, and each touched row read and written
      nbytes = n * dim * 4 + 2 * n * 8 + 8 + n_live * 8 + \
          opt.n_hypers * 4 + n_touched * table.shape[1] * 4 * 2
      bound, by = bound_ms(nbytes, n * dim + n_touched * dim * ops)
      log('rmw_fused (%s): %.4f ms, bound %.4f ms (%d bytes / 3.35 TB/s), '
          '%.2f x the bound, plain %.3f ms, index_add_ + K2 over all rows '
          '(closest library call for the sum half) %.4f ms (%s)'
          % (what, ms, bound, nbytes, ms / bound, plain, lib,
             'K3 faster' if ms < lib else 'K3 SLOWER'))
      if dim == meta.dim:
        inputs = dict(table=table, sids=sids, order=order, starts=starts,
                      grads=grads, hypers=hypers)
        queue_kernel_only(
            'rmw_fused (DIN, %s)' % name, ms, bound,
            lambda _o=opt, **t: pt.rmw_fused(
                t['table'], t['sids'], t['order'], t['starts'], t['grads'],
                t['hypers'], _o), **inputs)
      if dim == meta.dim and name == 'compact_adam':
        # the unfused path at the same shape, for comparison: K1 (mode 0)
        # by the same chunk tree, then K2
        sentinel = meta.sentinel

        def k1_k2(table, sids, order, starts, grads, hypers, _o=opt):
          uids, gsum = pt.seg_sum(sids, order, starts, grads, sentinel, '0')
          pt.rmw_rows(table, uids, gsum, hypers, _o)

        k12_ms = cuda_ms(torch, lambda: k1_k2(**inputs), 20, flush)
        log('K1 (mode 0) + K2 at the DIN shape: %.4f ms' % k12_ms)
        queue_kernel_only('K1 (mode 0) + K2 (DIN, compact_adam)', k12_ms,
                          bound, k1_k2, **inputs)
      if dim == meta.dim:
        del inputs
      del table
      torch.cuda.empty_cache()
      if dim == meta.dim:
        results.append(dict(
            name='rmw_fused/%s' % name, route='cuda',
            source='easyrec_torch/csrc/rmw_fused.cu',
            replaces='easyrec_tpu/ops/packed_table.py:1024',
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=by, library_ms=lib))
    del grads
  results[0]['seg_sum_din_err'] = err1
  del flush
  torch.cuda.empty_cache()
  return results


def group_gids(torch, meta, n_ids, seed):
  """Group slot ids as the packed-v2 update makes them: n_ids random
  logical ids, dedup_sum, group_prep; real groups first, then slots
  naming the scratch group. Returns (ugids int32, gg, n_real)."""
  from easyrec_torch.benchmarks import bench_packed_v2 as v2
  from easyrec_torch.optim.sparse import dedup_sum

  dev = torch.device('cuda')
  gen = torch.Generator(device=dev).manual_seed(seed)
  ids = torch.randint(0, meta.rows, (n_ids,), generator=gen, device=dev,
                      dtype=torch.int32)
  grads = torch.randn((n_ids, meta.dim), generator=gen, device=dev)
  ugids, gg, _ = v2.group_prep(*dedup_sum(ids, grads, meta.scratch), meta)
  real = ugids != meta.scratch_gid
  n_real = int(real.sum())
  if bool(real[n_real:].any()):
    fail('group ids: a real group slot follows a scratch slot')
  return ugids, gg.contiguous(), n_real


def phase_groups(torch):
  """K4 and K5 against their plain versions at the ported benchmarks'
  shapes, with times; then every ported benchmark's main() at its full
  shape, each correctness line required true, with K4 and K5 launch
  counts over those runs. Returns the two kernels' result records."""
  import numpy as np
  from easyrec_torch.benchmarks import (bench_dma_issue, bench_group_dma,
                                        bench_packed_stages,
                                        bench_packed_v2 as v2)
  from easyrec_torch.ops import group_dma, kernels

  dev = torch.device('cuda')
  flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
  results = []

  # -- K4 at the bench_packed_v2 deep shape: 106,496 slots, W 128
  meta = v2.PackMeta(26_000_000, 16)
  ugids, gg, n_real = group_gids(torch, meta, 4096 * 26, 21)
  n = ugids.shape[0]
  gen = torch.Generator(device=dev).manual_seed(22)
  table = torch.randn((meta.groups, 8, meta.width), generator=gen,
                      device=dev)
  rows = torch.randn((n, 8, meta.width), generator=gen, device=dev)
  rows[n_real:] = table[meta.scratch_gid]    # pads carry current bytes
  ref = table.clone()
  group_dma.group_push(table, ugids, rows)
  group_dma.group_push_plain(ref, ugids, rows)
  group_dma.check_ids(dev)
  if not torch.equal(table.view(torch.int32), ref.view(torch.int32)):
    fail('group_push: the table differs from the plain version')
  err4 = float((table - ref).abs().max())
  del ref
  log('group_push (push shape): %d slots (%d real groups, %d scratch pads) '
      'into [%d, 8, %d] f32; byte-equal to the plain version over the whole '
      'table, scratch group included (tolerance 0)'
      % (n, n_real, n - n_real, meta.groups, meta.width))
  k4_ms = cuda_ms(torch, lambda: group_dma.group_push(table, ugids, rows),
                  20, flush)
  k4_plain = cuda_ms(torch, lambda: group_dma.group_push_plain(
      table, ugids, rows), 20, flush)
  flat, ids64, rows2 = table.view(meta.groups, -1), ugids.long(), \
      rows.view(n, -1)
  k4_lib = cuda_ms(torch, lambda: flat.index_copy_(0, ids64, rows2), 20,
                   flush)
  k4_bytes = n * rows2.shape[1] * 4 * 2 + n * 4
  k4_bound, k4_by = bound_ms(k4_bytes, 0)
  log('group_push: %.4f ms, bound %.4f ms (%d bytes / 3.35 TB/s), plain '
      '%.4f ms, index_copy_ (int64 ids) %.4f ms'
      % (k4_ms, k4_bound, k4_bytes, k4_plain, k4_lib))
  results.append(dict(
      name='group_push', route='cuda',
      source='easyrec_torch/csrc/group_push.cu',
      replaces='benchmarks/bench_packed_v2.py:127', max_abs_err=err4,
      ms=k4_ms, plain_ms=k4_plain, bound_ms=k4_bound, bound_by=k4_by,
      library_ms=k4_lib))
  del rows, rows2, flat

  # -- K5 at the rmw_variant shape: the same slots with gg, W 128
  gg = gg.reshape(n, 8, meta.width)
  err5, t5 = check_group_rmw(torch, group_dma, table, ugids, gg,
                             meta.scratch_gid, 'rmw_variant shape', flush)
  del table, gg, ugids

  # -- K5 at the bench_pallas_group_dma shape: 98,304 groups, W 384, 5 GB
  groups = bench_group_dma.G
  sgids = np.sort(np.random.default_rng(0).choice(
      groups, bench_group_dma.SLOTS, replace=False)).astype(np.int32)
  table = torch.randn((groups, 8, bench_group_dma.W), generator=gen,
                      device=dev)
  e, t = check_group_rmw(torch, group_dma, table,
                         torch.from_numpy(sgids).to(dev), None, None,
                         'group-DMA shape', flush)
  del table
  results.append(dict(
      name='group_rmw', route='cuda',
      source='easyrec_torch/csrc/group_rmw.cu',
      replaces='benchmarks/bench_pallas_group_dma.py:22',
      max_abs_err=max(err5, e), ms=t['ms'], plain_ms=t['plain_ms'],
      bound_ms=t['bound_ms'], bound_by=t['bound_by'], library_ms=None))
  log('group_rmw in the kernels line: the group-DMA shape; at the '
      'rmw_variant shape %.4f ms, bound %.4f ms, plain %.4f ms'
      % (t5['ms'], t5['bound_ms'], t5['plain_ms']))
  del flush
  torch.cuda.empty_cache()

  # -- every ported benchmark at its full shape
  kernels.reset_launches()
  runs = [('bench_group_dma', bench_group_dma.main([])),
          ('bench_dma_issue', bench_dma_issue.main([])),
          ('bench_packed_stages', bench_packed_stages.main([])),
          ('bench_packed_v2', v2.main([]))]
  torch.cuda.empty_cache()
  runs.append(('experimental_packed_update', phase_experimental(torch)))
  counts = kernels.launch_counts()
  for name, out in runs:
    if not out['correct']:
      fail('%s: a correctness line is false: %s' % (name, out))
  log('ported benchmarks: every correctness line true; launches %s'
      % counts)
  for name in ('group_push', 'group_rmw'):
    if counts[name] == 0:
      fail('%s never launched in the ported benchmarks' % name)
  for name in ('seg_sum', 'rmw_rows', 'rmw_fused'):
    if counts[name] != 0:
      fail('%s launched in the ported benchmarks' % name)
  for r in results:
    r['launches'] = counts[r['name']]
  torch.cuda.empty_cache()
  return results


def check_group_rmw(torch, group_dma, table, gids, gg, scratch_gid, what,
                    flush):
  """K5 and its plain version from the same table, byte-equal on every
  group but the scratch group (whose pad slots race on the card); then
  times. Returns (max |difference|, timing record)."""
  a, b, c = (0.999, 0.0, -0.001) if gg is not None else (0.999, 0.001, 0.0)
  ref = table.clone()
  group_dma.group_rmw(table, gids, a, b, gg=gg, c=c)
  group_dma.group_rmw_plain(ref, gids, a, b, gg=gg, c=c)
  group_dma.check_ids(table.device)
  keep = torch.ones(table.shape[0], dtype=torch.bool, device=table.device)
  if scratch_gid is not None:
    keep[scratch_gid] = False
  diff = (table.view(torch.int32) != ref.view(torch.int32)).flatten(
      1).any(dim=1)
  if bool(diff[keep].any()):
    fail('group_rmw (%s): %d groups differ from the plain version'
         % (what, int(diff[keep].sum())))
  err = float((table[keep] - ref[keep]).abs().max()) if \
      scratch_gid is not None else float((table - ref).abs().max())
  del ref, diff
  n = gids.shape[0]
  elems = table[0].numel()
  n_scratch = 0 if scratch_gid is None else int((gids == scratch_gid).sum())
  log('group_rmw (%s): %d slots (%d naming the scratch group) of [%d, %d] '
      'f32 groups%s; byte-equal to the plain version on every other group '
      '(tolerance 0)' % (what, n, n_scratch, table.shape[0], elems,
                         ', with gg' if gg is not None else ''))
  ms = cuda_ms(torch, lambda: group_dma.group_rmw(table, gids, a, b, gg=gg,
                                                  c=c), 20, flush)
  plain = cuda_ms(torch, lambda: group_dma.group_rmw_plain(
      table, gids, a, b, gg=gg, c=c), 5, flush)
  nbytes = n * elems * 4 * (3 if gg is not None else 2) + n * 4
  bound, by = bound_ms(nbytes, n * elems * (3 if gg is not None else 2))
  log('group_rmw (%s): %.4f ms, bound %.4f ms (%d bytes / 3.35 TB/s), '
      'plain (index_select, the math, index_copy_: the closest PyTorch '
      'composite; no single call computes it) %.4f ms'
      % (what, ms, bound, nbytes, plain))
  return err, dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)


class LazySgd:
  """The `update_parts` that experimental_packed_update expects and the
  JAX package does not define: lazy SGD on the weights, the slots decayed
  toward the gradient."""

  def update_parts(self, w, slots, g, lr, step):
    return w - lr * g, [0.9 * s + 0.1 * g for s in slots]


class GroupMeta:
  """A small FusedTable-like geometry: dim 16, weight + 2 slots (48
  combined columns), 8 logical rows a physical row (W 384)."""

  def __init__(self, rows):
    self.rows, self.dim, self.pack, self.combined_cols = rows, 16, 8, 48
    self.width = self.pack * self.combined_cols
    self.group_rows = 8 * self.pack
    groups = rows // self.group_rows + 2
    self.scratch = (groups - 1) * self.group_rows


def phase_experimental(torch):
  """apply_group_updates at a small geometry on the card: the K4 path
  against the index_copy_ path from the same table, byte-equal."""
  from easyrec_torch.benchmarks import experimental_packed_update as xp
  from easyrec_torch.ops import group_dma
  from easyrec_torch.optim.sparse import dedup_sum

  dev = torch.device('cuda')
  meta = GroupMeta(200_000)
  groups = meta.rows // meta.group_rows + 2
  gen = torch.Generator(device=dev).manual_seed(31)
  table = torch.randn((groups, 8, meta.width), generator=gen, device=dev)
  ids = torch.randint(0, meta.rows, (20_000,), generator=gen, device=dev)
  grads = torch.randn((20_000, meta.dim), generator=gen, device=dev)
  grads[::7] = 0.0
  uids, ug = dedup_sum(ids, grads, meta.scratch)
  ref = table.clone()
  xp.apply_group_updates(table, uids, ug, LazySgd(), 0.1, 0, meta)
  xp._plain_apply(ref, *xp._group_prep(uids, ug, meta), LazySgd(), 0.1, 0,
                  meta)
  group_dma.check_ids(dev)
  ok = torch.equal(table.view(torch.int32), ref.view(torch.int32))
  log('experimental_packed_update.apply_group_updates: %d ids into [%d, 8, '
      '%d]; K4 write-back byte-equal to index_copy_: correct=%s'
      % (ids.shape[0], groups, meta.width, ok))
  return {'correct': ok}


def phase_agree(torch, what, cfg, fused, compact='1'):
  """A small model: 3 steps on the card and on the CPU from the same
  weights and batches. The CPU path runs the kernels' plain versions,
  whose agreement with the JAX package the CPU tests hold. On the card
  the update must go through K2 (or K3 under EASYREC_PACKED_FUSED=1) with
  the embedding optimizer's block math, once a step and table. Returns the
  card's launches by kernel and math."""
  from easyrec_torch.ops import kernels
  from easyrec_torch.optim.sparse import MATH_NAMES
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils.synthetic import synthetic_batch

  os.environ['EASYREC_PACKED_FUSED'] = fused
  os.environ['EASYREC_PACKED_COMPACT'] = compact
  bs = int(cfg.data_config.batch_size)
  runs = {}
  for name in ('cpu', 'cuda'):
    t = Trainer(cfg, device=name)
    t.init_state()
    runs[name] = t
  runs['cuda'].model.load_state_dict(runs['cpu'].model.state_dict())
  for key, table in runs['cpu'].tables.items():
    runs['cuda'].tables[key].copy_(table)
  kernels.reset_launches()
  losses = {}
  for name, t in runs.items():
    dev = torch.device(name)
    losses[name] = []
    for step in range(3):
      batch = synthetic_batch(t.specs, list(t.ctx.label_fields), bs,
                              seed=step)
      losses[name].append(float(t.train_step(to_device(batch,
                                                        dev))['total_loss']))
  tagged = kernels.tagged_counts()
  t = runs['cuda']
  math_ids = {MATH_NAMES[t.embed_pair.sparse.kernel_math(m.compact)[0]]
              for m in t.metas.values()}
  want = {'%s/%s' % ('rmw_fused' if fused == '1' else 'rmw_rows', m):
          3 * len(t.tables) for m in math_ids}
  if tagged != want:
    fail('small %s: the card launched %s, %s expected' % (what, tagged,
                                                          want))
  for a, b in zip(losses['cpu'], losses['cuda']):
    if not math.isfinite(b) or abs(a - b) > 1e-5 * max(1.0, abs(a)):
      fail('small %s: losses differ on the card %s and the CPU %s'
           % (what, losses['cuda'], losses['cpu']))
  # f32 reduction order differs between the card's dense model and the
  # CPU's, so the summed table gradients differ in their last bits; where a
  # sum cancels to rounding noise its sign may differ, and Adam turns
  # either sign into a step of about lr (AdamW measured 176 of 192,128
  # weights apart by more than 1e-5, all within 2 lr a step). So at most 1
  # in 100 weights may part by more than 1e-5, and none by more than 2 lr
  # a step; the kernels themselves are held bit-exact in phase 3
  emb = t.embed_pair
  lr_sum = sum(float(emb.schedule(torch.tensor(s))) for s in range(3)) * \
      emb.embedding_lr_multiplier
  far_all = 0
  for key, table in runs['cpu'].tables.items():
    dim = runs['cpu'].metas[key].dim
    diff = (runs['cuda'].tables[key][:, :dim].cpu() - table[:, :dim]).abs()
    far = int((diff > 1e-5).sum())
    err = float(diff.max())
    if far > diff.numel() // 100 or err > 2 * lr_sum:
      cols = sorted(set(torch.nonzero(diff > 1e-5)[:, 1].tolist()))
      fail('small %s: table %s weights differ by up to %g, %d of %d by more '
           'than 1e-5 (columns %s)' % (what, key, err, far, diff.numel(),
                                       cols))
    far_all += far
    if not bool(torch.isfinite(runs['cuda'].tables[key]).all()):
      fail('small %s: table %s holds a value that is not finite'
           % (what, key))
  log('agree: small %s, EASYREC_PACKED_FUSED=%s, 3 steps, card vs CPU '
      'losses %s vs %s; table weights within 1e-5 but %d (at most 1 in '
      '100, each within 2 lr a step); card launches %s'
      % (what, fused, losses['cuda'], losses['cpu'], far_all, tagged))
  return tagged


# the optimizer messages the agree phase trains a small DeepFM with, each
# driving the tables and the dense weights: (what, Optimizer message body
# without the learning rate, EASYREC_PACKED_COMPACT)
AGREE_OPTIMIZERS = [
    ('adam', 'adam_optimizer {%s}', '1'),
    ('adam, 3-part', 'adam_optimizer {%s}', '0'),
    ('adamw', 'adamw_optimizer {%s weight_decay: 0.01}', '1'),
    ('adagrad', 'adagrad_optimizer {%s}', '1'),
    ('momentum', 'momentum_optimizer {%s}', '1'),
    ('momentumw', 'momentumw_optimizer {%s weight_decay: 0.01}', '1'),
    ('rms_prop', 'rms_prop_optimizer {%s}', '1'),
    ('ftrl', 'ftrl_optimizer {%s l1_reg: 0.001 l2_reg: 0.01 '
             'l2_shrinkage_reg: 0.01}', '1'),
]


def phase_optimizers(torch):
  """The agree phase once per optimizer message, unfused (K1 + K2) and
  fused (K3): every sparse math that a config reaches, and every dense
  optimizer, on the card against the CPU."""
  from easyrec_torch.config.text_format import parse
  from easyrec_torch.utils import flagship

  launches = {}
  # the flagship's schedule (0.001, decaying): at larger rates Adam turns a
  # bf16 rounding of a gradient sum that differs between the card and the
  # CPU (their dense reductions add in other orders) into a full step
  lr = (' learning_rate { exponential_decay_learning_rate { '
        'initial_learning_rate: 0.001 decay_steps: 1000 decay_factor: 0.5 '
        'min_learning_rate: 0.00001 } }')
  for what, body, compact in AGREE_OPTIMIZERS:
    for fused in ('0', '1'):
      cfg = flagship.criteo_deepfm_config(
          batch_size=256, hash_bucket_size=1000, num_dense=3, num_cat=6)
      opt = parse('optimizer_config { %s }' % (body % lr), 'TrainConfig')
      cfg.train_config.optimizer_config = list(opt.optimizer_config)
      for k, c in phase_agree(torch, 'DeepFM, %s' % what, cfg, fused,
                              compact).items():
        launches[k] = launches.get(k, 0) + c
  os.environ['EASYREC_PACKED_COMPACT'] = '1'
  log('agree: launches by kernel and math over the optimizer runs: %s'
      % launches)


def phase_slice(torch, card, what, cfg, fused, path_kernels, path_math):
  """train_and_evaluate of `cfg` at full width, SLICE_STEPS steps, with
  every launch counter set to 0 just before and read just after: each
  kernel of `path_kernels` must launch once per step and table, every
  other kernel not at all, and K2 or K3 only with the block math
  `path_math`. Then the steady-state train-step rate over pre-built
  synthetic batches. Returns the launches by kernel and by kernel/math."""
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
  tagged = kernels.tagged_counts()
  losses = result['losses']
  log('%s: train_and_evaluate, EASYREC_PACKED_FUSED=%s, %d steps in %.1f s '
      '(set-up, input and eval included)'
      % (what, fused, result['global_step'], wall))
  log('%s losses: %s' % (what, ['%.6f' % x for x in losses]))
  log('%s eval: %s' % (what, result.get('eval_metrics')))
  log('%s launches: %s; by math: %s' % (what, counts, tagged))
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
  want = {'%s/%s' % (k, path_math): SLICE_STEPS * n_tables
          for k in path_kernels if k in ('rmw_rows', 'rmw_fused')}
  if tagged != want:
    fail('%s: K2/K3 launched with the block maths %s, %s expected'
         % (what, tagged, want))
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
  return dict(counts, **tagged)


SCRATCH = os.path.join(HERE, 'build', 'chip_smoke')

# the EV phase: samples/deepfm_ev_params.config at its published widths,
# cut in depth so that its sweeps fall inside the run. (field, published,
# here)
EV_STEPS = 40
EV_CUTS = (('train_config.num_steps', 10000, EV_STEPS),
           ('train_config.save_checkpoints_steps', 2000, 10),
           ('uid ev_params.steps_to_live', 4000, 10))
EV_BATCH = 1024
EV_COLS = ('label', 'uid', 'iid', 'cate', 'tags', 'age', 'price', 'seq_cate')


def write_ev_csv(path, seed=2026):
  """EV_STEPS batches of the sample's columns, made from `seed`: uid ids
  from 5,000 values and iid ids from 3,000, both moving to new ranges
  halfway, so ids are admitted (filter_freq 2 and 3), masked before, and
  the first half's rows go stale after (steps_to_live cut to 10)."""
  import numpy as np
  rng = np.random.default_rng(seed)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  half = EV_STEPS * EV_BATCH // 2
  lines = []
  for i in range(EV_STEPS * EV_BATCH):
    shift = 0 if i < half else 1
    lines.append('%d,u%d,i%d,c%d,t%d,%.4f,%.2f,c%d' % (
        rng.integers(0, 2), rng.integers(0, 5000) + 5000 * shift,
        rng.integers(0, 3000) + 3000 * shift, rng.integers(0, 1000),
        rng.integers(0, 50), rng.random(), rng.random() * 100,
        rng.integers(0, 1000)))
  with open(path, 'w') as f:
    f.write('\n'.join(lines) + '\n')


def ev_config(data, model_dir):
  """The EV sample as a user loads it, with EV_CUTS, the generated data
  and `model_dir`."""
  from easyrec_torch import main as main_lib
  cfg = main_lib.load_config(
      os.path.join(HERE, 'samples', 'deepfm_ev_params.config'),
      {'train_input_path': data, 'eval_input_path': data,
       'model_dir': model_dir, 'train_config.num_steps': EV_STEPS,
       'train_config.save_checkpoints_steps': 10,
       'train_config.log_step_count_steps': 10})
  cols = [f.input_name for f in cfg.data_config.input_fields]
  if tuple(cols) != EV_COLS or int(cfg.data_config.batch_size) != EV_BATCH:
    fail('samples/deepfm_ev_params.config: columns %s, batch %d; the EV '
         'phase writes %s at %d' % (cols, cfg.data_config.batch_size,
                                    EV_COLS, EV_BATCH))
  for fc in cfg.feature_config.features:
    if fc.input_names[0] == 'uid':
      ev = fc.ev_params
      if int(ev.steps_to_live) != 4000:
        fail('uid steps_to_live %d, 4000 expected' % ev.steps_to_live)
      ev.steps_to_live = 10
      fc.ev_params = ev
  return cfg


def ev_kernel_inputs(torch):
  """The EV phase's shape for K2 and K3: the id pack of the first batch of
  the EV data ([1024, 4] slots of the 210,002-row fused table: uid, iid,
  cate and the raw age row, 1,024 times) with a gradient of ones."""
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.train.trainer import Trainer, to_device
  data = os.path.join(SCRATCH, 'ev', 'train.csv')
  write_ev_csv(data)
  trainer = Trainer(ev_config(data, ''), device='cuda')
  batch = next(iter(trainer.train_input()))
  packs = emb_ops.pack_ids(trainer.layout, to_device(batch,
                                                      torch.device('cuda')))
  (key, meta), = trainer.metas.items()
  return packs[key].reshape(-1), meta.rows


def phase_kernels_ev(torch):
  """K2 and K3 with the EV maths (ev_add on the admission counts, ev_set on
  the last-seen steps) at the EV phase's shape, each bit-exact against its
  plain version over the whole [rows, 1] aux table, with times and byte
  bounds. Returns one result record a kernel and math."""
  from easyrec_torch.features import ev as ev_lib
  from easyrec_torch.ops import packed_table as pt

  dev = torch.device('cuda')
  ids, rows = ev_kernel_inputs(torch)
  n = ids.shape[0]
  ones = torch.ones((n, 1), device=dev)
  sids, order, starts = pt.sort_segments(ids)
  uids, gsum = pt.seg_sum(sids, order, starts, ones, rows, '1')
  n_seg = int((starts[:n] < n).sum())
  n_touched = int(((uids < rows) & (gsum[:, 0] != 0)).sum())
  flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
  gen = torch.Generator(device=dev).manual_seed(77)
  step = torch.tensor(17, dtype=torch.int32, device=dev)
  log('EV kernel shape: aux table [%d, 1] f32, %d id slots, %d segments '
      '(the raw age row %d slots), %d touched rows'
      % (rows, n, n_seg, int((starts[1:] - starts[:n]).max()), n_touched))
  results = []
  for name, opt in (('ev_add', ev_lib.EV_ADD), ('ev_set', ev_lib.EV_SET)):
    hypers = opt.hypers(None, step)
    table = torch.randint(0, 40, (rows, 1), generator=gen,
                          device=dev).to(torch.float32)
    # the function reads a row only to add to it; both write touched rows
    row_bytes = n_touched * 4 * (2 if name == 'ev_add' else 1)
    for kernel in ('rmw_rows', 'rmw_fused'):
      ref = table.clone()
      if kernel == 'rmw_rows':
        call = lambda: pt.rmw_rows(table, uids, gsum, hypers, opt)  # noqa
        plain = lambda: pt.rmw_rows_plain(table, uids, gsum, hypers,  # noqa
                                          opt)
        pt.rmw_rows_plain(ref, uids, gsum, hypers, opt)
        nbytes = n * 8 + 4 + n_seg * 4 + row_bytes
      else:
        call = lambda: pt.rmw_fused(table, sids, order, starts, ones,  # noqa
                                    hypers, opt)
        plain = lambda: pt.rmw_fused_plain(table, sids, order,  # noqa
                                           starts, ones, hypers, opt)
        pt.rmw_fused_plain(ref, sids, order, starts, ones, hypers, opt)
        nbytes = n * 4 + 2 * n * 8 + 8 + n_seg * 8 + 4 + row_bytes
      call()
      torch.cuda.synchronize()
      if not torch.equal(table.view(torch.int32), ref.view(torch.int32)):
        fail('%s (%s) at the EV shape: %d rows differ from the plain '
             'version' % (kernel, name, int((table != ref).sum())))
      err = float((table - ref).abs().max())
      ms = cuda_ms(torch, call, 20, flush)
      plain_ms = cuda_ms(torch, plain, 3, flush)
      bound, by = bound_ms(nbytes, n_touched + (n if kernel == 'rmw_fused'
                                                else 0))
      log('%s (%s, [%d, 1]): bit-exact against the plain version (tolerance '
          '0); %.4f ms, bound %.6f ms (%d bytes / 3.35 TB/s), plain %.3f ms; '
          'no single library call computes it'
          % (kernel, name, rows, ms, bound, nbytes, plain_ms))
      if kernel == 'rmw_rows':
        queue_kernel_only(
            'rmw_rows (EV shape, %s)' % name, ms, bound,
            lambda table, uids, gsum, hypers, _o=opt: pt.rmw_rows(
                table, uids, gsum, hypers, _o),
            table=table, uids=uids, gsum=gsum, hypers=hypers)
      else:
        queue_kernel_only(
            'rmw_fused (EV shape, %s)' % name, ms, bound,
            lambda _o=opt, **t: pt.rmw_fused(
                t['table'], t['sids'], t['order'], t['starts'], t['ones'],
                t['hypers'], _o),
            table=table, sids=sids, order=order, starts=starts, ones=ones,
            hypers=hypers)
      results.append(dict(
          name='%s/%s' % (kernel, name), route='cuda',
          source='easyrec_torch/csrc/%s.cu' % kernel,
          replaces='easyrec_tpu/ops/packed_table.py:%s' % (
              '701' if kernel == 'rmw_rows' else '1024'),
          max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
          bound_by=by, library_ms=None))
  del flush
  torch.cuda.empty_cache()
  return results


def ev_run_config(data, model_dir, use_bn):
  cfg = ev_config(data, model_dir)
  if not use_bn:
    cfg.model_config.deepfm.dnn.use_bn = False
    cfg.model_config.deepfm.final_dnn.use_bn = False
  return cfg


def ev_initial_state(torch, data, use_bn, nudge=False):
  """The EV model's initial state, drawn on the CPU: every run of the EV
  phase starts from it, restored from a step-0 checkpoint, since a
  trainer draws its tables on its own device (the card's generator and the
  CPU's give other weights). With `nudge`, every weight of the first dense
  layer moves by one ulp: the yardstick of how far the run itself parts
  under a change of rounding. Returns (state, layout stamp)."""
  from easyrec_torch.train.trainer import Trainer
  t = Trainer(ev_run_config(data, '', use_bn), device='cpu')
  t.init_state()
  if nudge:
    with torch.no_grad():
      w = t.model.get_parameter('dnn.dense_0.weight')
      w.copy_(torch.nextafter(w, torch.full_like(w, float('inf'))))
  return t.state_dict(), t.layout_stamp()


def run_ev(torch, data, fused, device, use_bn, init, tag=''):
  """One EV run (ev_config) through train_and_evaluate from `init`
  (ev_initial_state, saved as step 0 of the run's model_dir, which
  train_and_evaluate restores), with every launch counter set to 0 just
  before and read just after: on the card the table's Adam, ev_add and
  ev_set launch once a step each (K1 three times a step unfused), on the
  CPU nothing. Returns (trainer, launches by kernel/math)."""
  import shutil
  from easyrec_torch import main as main_lib
  from easyrec_torch.ops import kernels
  from easyrec_torch.train import checkpoints as ckpt_lib

  os.environ['EASYREC_PACKED_FUSED'] = fused
  tag = '%s_%s_%s%s' % (fused, device, 'bn' if use_bn else 'nobn', tag)
  model_dir = os.path.join(SCRATCH, 'ev', 'model_' + tag)
  shutil.rmtree(model_dir, ignore_errors=True)
  cfg = ev_run_config(data, model_dir, use_bn)
  state, stamp = init
  ckpt_lib.CheckpointManager(model_dir, layout_stamp=stamp).save(state, 0)
  kernels.reset_launches()
  t0 = time.time()
  result = main_lib.train_and_evaluate(cfg, device=device)
  if device == 'cuda':
    torch.cuda.synchronize()
  wall = time.time() - t0
  counts, tagged = kernels.launch_counts(), kernels.tagged_counts()
  what = 'ev (%s, %s, BatchNorm %s)' % ('K3' if fused == '1' else 'K1 + K2',
                                        device, 'on' if use_bn else 'off')
  log('%s: %d steps in %.1f s through train_and_evaluate (input, sweeps, '
      'saves and eval included); eval %s; launches %s, by math %s'
      % (what, result['global_step'], wall, result.get('eval_metrics'),
         counts, tagged))
  if result['global_step'] != EV_STEPS:
    fail('%s ran %d steps' % (what, result['global_step']))
  steps = sorted(int(d) for d in os.listdir(
      os.path.join(model_dir, 'checkpoints')) if d.isdigit())
  if steps != [0, 10, 20, 30, 40]:
    fail('%s: checkpoints %s, 0 (the initial state) 10 20 30 40 expected'
         % (what, steps))
  if device == 'cpu':
    if any(counts.values()):
      fail('%s: the CPU launched %s' % (what, counts))
    return result['trainer'], {}
  k = 'rmw_fused' if fused == '1' else 'rmw_rows'
  want = {'%s/%s' % (k, m): EV_STEPS
          for m in ('compact_adam', 'ev_add', 'ev_set')}
  want_k1 = 0 if fused == '1' else 3 * EV_STEPS
  if tagged != want or counts['seg_sum'] != want_k1:
    fail('%s: launches %s and K1 %d, %s and K1 %d expected'
         % (what, tagged, counts['seg_sum'], want, want_k1))
  return result['trainer'], tagged


def ev_table_diff(a, b):
  """(weights apart by more than 1e-5, of how many, the largest gap) of
  the EV table's weight columns in trainers a and b."""
  (key, _), = a.ev_plan.items()
  dim = a.metas[key].dim
  diff = (a.tables[key][:, :dim].cpu() - b.tables[key][:, :dim].cpu()).abs()
  return int((diff > 1e-5).sum()), diff.numel(), float(diff.max())


def phase_ev(torch):
  """samples/deepfm_ev_params.config through train_and_evaluate at its
  published widths (uid and iid 100,000 buckets, cate 10,000, dim 16,
  batch 1024, Adam), cut in depth (EV_CUTS), on write_ev_csv's data: once
  with K1 + K2 and once with K3, each on the card and on the CPU (run_ev)
  from one initial state. Rows admitted, id slots masked and trained rows
  evicted must each be above zero, and card and CPU must agree exactly on
  both counters, the masked slots and the sweeps. The table weights: the
  same runs with the sample's BatchNorm off (the one change) within the
  agree phase's tolerance; with it on, each within 2 lr a step, since the
  run itself is unsteady in its rounding there (a CPU run from a start one
  ulp away, measured here, parts as far). Returns the card's launches by
  kernel/math of the published runs."""
  data = os.path.join(SCRATCH, 'ev', 'train.csv')
  for field, was, now in EV_CUTS:
    log('ev: cut %s %d -> %d (depth; widths, filter_freq and the model as '
        'published)' % (field, was, now))
  launches = {}
  lr_sum = 0.001 * EV_STEPS            # the sample's constant rate
  inits = {bn: ev_initial_state(torch, data, bn) for bn in (True, False)}
  for fused in ('0', '1'):
    path = 'K3' if fused == '1' else 'K1 + K2'
    for use_bn in (True, False):
      card, tagged = run_ev(torch, data, fused, 'cuda', use_bn,
                            inits[use_bn])
      cpu, _ = run_ev(torch, data, fused, 'cpu', use_bn, inits[use_bn])
      if use_bn:
        for key, c in tagged.items():
          launches[key] = launches.get(key, 0) + c
      (key, ev), = card.ev_plan.items()
      count = card.ev_state[key]['ev_count'][:, 0].cpu()
      admitted = sum(int((count[a:b] >= ff).sum())
                     for a, b, ff, _ in ev.row_segments if ff > 0)
      masked = int(card.ev_masked)
      swept = [(step, by_table[key]) for step, by_table in card.ev_swept]
      evicted = sum(seen for _, (_, seen) in swept)
      what = 'ev (%s, BatchNorm %s)' % (path, 'on' if use_bn else 'off')
      log('%s: rows admitted %d (count >= filter_freq at the end), id slots '
          'masked %d, rows evicted %d (trained rows swept); (step, (rows '
          'swept, of them trained)) at each save %s'
          % (what, admitted, masked, evicted, swept))
      if admitted <= 0 or masked <= 0 or evicted <= 0:
        fail('%s: admitted %d, masked %d, evicted %d: each must be above '
             'zero' % (what, admitted, masked, evicted))
      if masked != int(cpu.ev_masked) or card.ev_swept != cpu.ev_swept:
        fail('%s: masked %d / %d or swept %s / %s differ card / CPU'
             % (what, masked, int(cpu.ev_masked), card.ev_swept,
                cpu.ev_swept))
      for aux_name, t in card.ev_state[key].items():
        if not torch.equal(t.cpu(), cpu.ev_state[key][aux_name]):
          fail('%s: %s differs between the card and the CPU (%d rows)'
               % (what, aux_name, int((t.cpu() != cpu.ev_state[key]
                                       [aux_name]).sum())))
      far, n, err = ev_table_diff(card, cpu)
      yardstick = ''
      if use_bn and fused == '0':
        nudged, _ = run_ev(torch, data, fused, 'cpu', use_bn,
                           ev_initial_state(torch, data, True, nudge=True),
                           tag='_nudged')
        n_far, _, n_err = ev_table_diff(nudged, cpu)
        yardstick = ('; a CPU run from dense weights one ulp away parts '
                     'from the CPU run on %d by more than 1e-5, the largest '
                     'by %g' % (n_far, n_err))
        del nudged
      # the agree phase's rule and reason: the dense reductions add in
      # other orders on the card and the CPU, and Adam turns a summed
      # gradient that cancels into a step of about lr of either sign. With
      # BatchNorm over mostly zero inputs (unadmitted ids read zero) the
      # run itself is that unsteady (the yardstick above), so only the
      # 2 lr bound holds there
      if err > 2 * lr_sum or (not use_bn and far > n // 100):
        fail('%s: table weights card vs CPU differ by up to %g, %d of %d '
             'by more than 1e-5' % (what, err, far, n))
      log('%s: card and CPU agree: ev_count, ev_last, masked slots and '
          'sweeps exactly; table weights: %d of %d apart by more than 1e-5 '
          '(%s), the largest by %g (at most 2 lr a step: %g)%s'
          % (what, far, n, 'at most 1 in 100' if not use_bn
             else 'not bounded with BatchNorm', err, 2 * lr_sum, yardstick))
      del card, cpu
  torch.cuda.empty_cache()
  log('ev: launches by kernel and math over the published card runs: %s'
      % launches)
  return launches


def phase_ckpt(torch):
  """The Taobao DIN at full width (K3), unshuffled DummyInput: a Trainer
  fits 20 steps on a model_dir with a save every 10; the step-20
  checkpoint is removed, and a fresh Trainer on the same model_dir
  restores step 10 and fits to 20. Its step, tables, model (dense
  parameters, BatchNorm statistics) and dense optimizer state must equal
  the uninterrupted run's bit for bit. Then a save and a restore of that
  state on their own, timed, with the checkpoint's size."""
  import shutil
  from easyrec_torch.train import checkpoints as ckpt_lib
  from easyrec_torch.train.trainer import Trainer
  from easyrec_torch.utils import flagship
  from easyrec_torch.ops import kernels

  os.environ['EASYREC_PACKED_FUSED'] = '1'
  model_dir = os.path.join(SCRATCH, 'din_ckpt')
  shutil.rmtree(model_dir, ignore_errors=True)
  cfg = flagship.taobao_din_config(model_dir=model_dir)
  cfg.data_config.shuffle = False
  cfg.train_config.num_steps = 20
  cfg.train_config.save_checkpoints_steps = 10
  kernels.reset_launches()
  a = Trainer(cfg, device='cuda')
  ra = a.fit(eval_at_end=False)
  torch.cuda.synchronize()
  counts = kernels.launch_counts()
  ckpts = os.path.join(model_dir, 'checkpoints')
  if sorted(os.listdir(ckpts)) != ['10', '20'] or counts['rmw_fused'] != 20:
    fail('ckpt: checkpoints %s, K3 launches %d' % (os.listdir(ckpts),
                                                   counts['rmw_fused']))
  shutil.rmtree(os.path.join(ckpts, '20'))
  kernels.reset_launches()
  b = Trainer(cfg, device='cuda')
  rb = b.fit(eval_at_end=False)
  torch.cuda.synchronize()
  if rb['global_step'] != 20 or len(rb['losses']) != 10 or \
      kernels.launch_counts()['rmw_fused'] != 10:
    fail('ckpt: the resumed run took %d steps to step %d'
         % (len(rb['losses']), rb['global_step']))

  def flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
      if isinstance(v, dict):
        out.update(flat(v, prefix + k + '/'))
      else:
        out[prefix + k] = v
    return out

  sa, sb = flat(a.state_dict()), flat(b.state_dict())
  differ = sorted(k for k in sa if not torch.equal(
      sa[k].view(torch.int32) if sa[k].dtype == torch.float32 else sa[k],
      sb[k].view(torch.int32) if sb[k].dtype == torch.float32 else sb[k]))
  log('ckpt: Taobao DIN, K3, 20 steps with saves at 10 and 20; a fresh '
      'Trainer restored step 10 and trained to 20: losses %s (resumed) vs '
      '%s; %d of %d state tensors differ from the uninterrupted run'
      % (['%.6f' % x for x in rb['losses']],
         ['%.6f' % x for x in ra['losses'][10:]], len(differ), len(sa)))
  if differ or rb['losses'] != ra['losses'][10:]:
    fail('ckpt: the resumed run differs from the uninterrupted one in %s'
         % differ[:20])
  timing_dir = os.path.join(SCRATCH, 'din_ckpt_timing')
  shutil.rmtree(timing_dir, ignore_errors=True)
  manager = ckpt_lib.CheckpointManager(timing_dir,
                                       layout_stamp=a.layout_stamp())
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  manager.save(a.state_dict(), 20)
  save_s = time.perf_counter() - t0
  nbytes = os.path.getsize(os.path.join(manager.step_dir(20), 'state.pt'))
  c = Trainer(cfg, device='cuda')
  c.init_state()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  c.load_state_dict(manager.restore(20))
  torch.cuda.synchronize()
  restore_s = time.perf_counter() - t0
  log('ckpt: save %.3f s, restore (read and copy to the card) %.3f s, '
      'checkpoint %d bytes (the [%d, %d] table %d bytes)'
      % (save_s, restore_s, nbytes, a.metas['emb16'].rows,
         a.metas['emb16'].width, a.tables['emb16'].numel() * 4))
  del a, b, c
  shutil.rmtree(timing_dir, ignore_errors=True)
  torch.cuda.empty_cache()


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

  # 3-7
  from easyrec_torch.utils import flagship
  results = phase_kernels(torch)
  results += phase_kernels_ev(torch)
  groups = phase_groups(torch)
  phase_optimizers(torch)
  phase_agree(torch, 'DIN', flagship.taobao_din_config(
      batch_size=256, seq_len=8), '1')
  din = phase_slice(torch, card, 'Taobao DIN', flagship.taobao_din_config(),
                    '1', ('rmw_fused',), 'compact_adam')
  deepfm = phase_slice(torch, card, 'flagship DeepFM',
                       flagship.criteo_deepfm_config(), '0',
                       ('seg_sum', 'rmw_rows'), 'compact_adam')
  adagrad = phase_slice(torch, card, 'flagship DeepFM, Adagrad tables',
                        flagship.criteo_deepfm_adagrad_config(), '0',
                        ('seg_sum', 'rmw_rows'), 'adagrad')
  phase_ckpt(torch)
  ev = phase_ev(torch)
  phase_kernel_only(torch)
  # launches on the paths: K1 on the Adagrad DeepFM's, each K2/K3 math on
  # the path that runs it (the EV maths on the EV phase's), 0 for a math
  # no path runs
  for r in results:
    r['launches'] = adagrad['seg_sum'] if r['name'] == 'seg_sum' else sum(
        path.get(r['name'], 0) for path in (din, deepfm, adagrad, ev))
  results += groups
  keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
          'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
  print(json.dumps({'kernels': [{k: r[k] for k in keys} for r in results]}))
  print(smi)
  print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                           'count': count}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
