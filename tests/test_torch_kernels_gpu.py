"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU (marker `gpu`) and skips where
torch.cuda.is_available() is False; run them on a machine with the card:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from easyrec_torch.ops import kernels
from easyrec_torch.ops import packed_table as pt
from easyrec_torch.optim import sparse
from easyrec_torch.optim.sparse import SparseAdam, pack_pair

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU: torch.cuda.is_available() is False')
  return torch.device('cuda')


def _segments(device, n=5000, rows=3000, dim=32, seed=0):
  gen = torch.Generator(device=device).manual_seed(seed)
  ids = torch.randint(0, rows // 10, (n,), generator=gen, device=device)
  ids[:700] = 11                          # a hot id
  grads = torch.randn((n, dim), generator=gen, device=device)
  grads[::13] = 0.0
  return (*pt.sort_segments(ids), grads)


@pytest.mark.parametrize('mode', ['0', 'mix', '1'])
@pytest.mark.parametrize('dim', [32, 16, 48])
def test_seg_sum_kernel_matches_plain(cuda, mode, dim):
  """Bit-exact: the kernel and its plain version add the same f32 values
  in the same order."""
  sids, order, starts, grads = _segments(cuda, dim=dim)
  before = kernels.launch_counts()['seg_sum']
  uk, sk = pt.seg_sum(sids, order, starts, grads, 3000, mode)
  torch.cuda.synchronize()
  assert kernels.launch_counts()['seg_sum'] == before + 1
  up, sp = pt.seg_sum_plain(sids, order, starts, grads, 3000, mode)
  assert torch.equal(uk, up)
  assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))


@pytest.mark.parametrize('mode', ['0', 'mix', '1'])
def test_seg_sum_kernel_matches_plain_on_hot_rows(cuda, mode):
  """The flagship's shape of hot segments: its 13 raw features are one
  row each, so 13 segments hold 4,096 slots apiece (batch 4096) beside
  26 x 4,096 mostly unique id slots. Bit-exact, as above."""
  bs, rows = 4096, 26_000_014
  gen = torch.Generator(device=cuda).manual_seed(3)
  hot = torch.arange(13, device=cuda).repeat(bs)
  cold = torch.randint(13, rows, (26 * bs,), generator=gen, device=cuda)
  ids = torch.cat([hot, cold])
  grads = torch.randn((ids.shape[0], 32), generator=gen, device=cuda)
  sids, order, starts = pt.sort_segments(ids)
  uk, sk = pt.seg_sum(sids, order, starts, grads, rows, mode)
  up, sp = pt.seg_sum_plain(sids, order, starts, grads, rows, mode)
  assert torch.equal(uk, up)
  assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))
  assert int((uk < 13).sum()) == 13


def _din_padding_ids(device, rows=50_000, seed=7):
  """A DIN batch's shape of long segments: a padding id of 100k slots, one
  of 3,001, beside 20k mostly unique ids and five ids outside the
  table."""
  gen = torch.Generator(device=device).manual_seed(seed)
  ids = torch.cat([torch.zeros(100_000, dtype=torch.int64, device=device),
                   torch.full((3001,), 1, dtype=torch.int64, device=device),
                   torch.randint(2, rows, (20_000,), generator=gen,
                                 device=device)])
  ids[-5:] = rows
  return ids


@pytest.mark.parametrize('mode', ['0', 'mix', '1'])
@pytest.mark.parametrize('dim', [16, 48])
def test_seg_sum_kernel_matches_plain_on_long_segments(cuda, mode, dim):
  """The DIN's padding shape, where K1 once walked 100k slots with one
  warp: 391 chunks of the one tree, bit-exact against the plain version
  in every mode, at one pass of 16 columns (dim 16) and three (dim 48),
  both with float4 loads. Scalar loads: test_kernels_take_unaligned_rows
  and test_seg_sum_kernel_matches_chunk_tree_at_any_dim."""
  ids = _din_padding_ids(cuda)
  gen = torch.Generator(device=cuda).manual_seed(8)
  grads = torch.randn((ids.shape[0], dim), generator=gen, device=cuda)
  grads[::11] = 0.0
  sids, order, starts = pt.sort_segments(ids)
  uk, sk = pt.seg_sum(sids, order, starts, grads, 50_000, mode)
  up, sp = pt.seg_sum_plain(sids, order, starts, grads, 50_000, mode)
  assert torch.equal(uk, up)
  assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))


def _mixed_segments(device, dim, rows, seed):
  """Tiny (1-8 slots), short (9-256) and long (257-3,000) segments, beside
  6,000 mostly unique ids; every 13th gradient row zero."""
  gen = torch.Generator(device=device).manual_seed(seed)
  lens = torch.tensor([1, 3, 8, 9, 100, 256, 257, 700, 3000, 2, 513],
                      device=device)
  ids = torch.repeat_interleave(torch.arange(lens.shape[0], device=device),
                                lens)
  ids = torch.cat([ids, torch.randint(lens.shape[0], rows, (6000,),
                                      generator=gen, device=device)])
  grads = torch.randn((ids.shape[0], dim), generator=gen, device=device)
  grads[::13] = 0.0
  return ids, grads


@pytest.mark.parametrize('mode', ['0', 'mix', '1'])
@pytest.mark.parametrize('dim', [3, 10, 130, 160])
def test_seg_sum_kernel_matches_chunk_tree_at_any_dim(cuda, mode, dim):
  """K1 at dims that are not a multiple of 4 (3, 10, 130: scalar loads,
  the last four columns of a row a partial float4) and above 128 (130,
  160: a tiny segment's lanes take a second float4 of columns), on tiny,
  short and long segments: bit-exact against segment_sums_by_chunk."""
  ids, grads = _mixed_segments(cuda, dim, 20_000, 20)
  sids, order, starts = pt.sort_segments(ids)
  uk, sk = pt.seg_sum(sids, order, starts, grads, 20_000, mode)
  want = pt.segment_sums_by_chunk(order, starts, grads, mode)
  assert torch.equal(sk.view(torch.int32), want.view(torch.int32))
  up, _ = pt.seg_sum_plain(sids, order, starts, grads, 20_000, mode)
  assert torch.equal(uk, up)


@pytest.mark.parametrize('dim', [10, 100])
def test_rmw_fused_adam_kernel_matches_plain_at_any_dim(cuda, dim):
  """K3 at a dim that is not a multiple of 4 (10: scalar loads) and at
  seven passes of which the last is partial (100), on tiny, short and
  long segments: w, m and v bit-equal to the plain version."""
  ids, grads = _mixed_segments(cuda, dim, 20_000, 21)
  _check_fused_against_plain(cuda, ids, grads, 20_000)


@pytest.mark.parametrize('fused', [False, True])
def test_kernels_take_unaligned_rows(cuda, fused):
  """Gradient rows that do not start 16-byte aligned take the kernels'
  scalar loads: the same sums, bit for bit."""
  ids = _din_padding_ids(cuda)
  n, dim = ids.shape[0], 16
  gen = torch.Generator(device=cuda).manual_seed(9)
  buf = torch.randn(n * dim + 1, generator=gen, device=cuda)
  grads = buf[1:].view(n, dim)
  assert grads.data_ptr() % 16 != 0
  sids, order, starts = pt.sort_segments(ids)
  if not fused:
    _, sk = pt.seg_sum(sids, order, starts, grads, 50_000, '0')
    _, sp = pt.seg_sum_plain(sids, order, starts, grads, 50_000, '0')
    assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))
    return
  _check_fused_against_plain(cuda, ids, grads, 50_000)


@pytest.mark.parametrize('fused', [False, True])
def test_kernels_find_every_long_chunk(cuda, fused):
  """Long segments of every length near a chunk's, starting anywhere in
  their windows of 256 slots, some on a window's first slot: the window
  search finds every chunk, so both kernels stay bit-exact."""
  gen = torch.Generator(device=cuda).manual_seed(12)
  lens = torch.tensor([256, 257, 1, 511, 512, 513, 3, 255, 767, 1024, 9,
                       2000, 300], device=cuda)
  ids = torch.repeat_interleave(torch.arange(13, device=cuda), lens)
  ids = torch.cat([ids, torch.randint(13, 5000, (3000,), generator=gen,
                                      device=cuda)])
  grads = torch.randn((ids.shape[0], 16), generator=gen, device=cuda)
  if fused:
    _check_fused_against_plain(cuda, ids, grads, 5000)
    return
  sids, order, starts = pt.sort_segments(ids)
  for mode in ('0', '1'):
    _, sk = pt.seg_sum(sids, order, starts, grads, 5000, mode)
    _, sp = pt.seg_sum_plain(sids, order, starts, grads, 5000, mode)
    assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))


@pytest.mark.parametrize('dim', [32, 16])
def test_rmw_adam_kernel_matches_plain(cuda, dim):
  """Compact Adam bit-exact (w, m and v); untouched and sentinel rows keep
  their bytes."""
  rows = 3000
  sids, order, starts, grads = _segments(cuda, rows=rows, dim=dim, seed=1)
  uids, gsum = pt.seg_sum(sids, order, starts, grads, rows, '1')
  gen = torch.Generator(device=cuda).manual_seed(2)
  table = torch.empty((rows, 2 * dim), device=cuda)
  table[:, :dim] = torch.randn((rows, dim), generator=gen, device=cuda)
  table[:, dim:] = pack_pair(
      torch.randn((rows, dim), generator=gen, device=cuda) * 1e-3,
      torch.rand((rows, dim), generator=gen, device=cuda) * 1e-4)
  opt = SparseAdam()
  hyp = opt.hypers(torch.tensor(1e-2, device=cuda),
                   torch.tensor(4, dtype=torch.int32, device=cuda))
  orig, ref = table.clone(), table.clone()
  before = kernels.launch_counts()['rmw_rows']
  pt.rmw_rows(table, uids, gsum, hyp, opt)
  torch.cuda.synchronize()
  assert kernels.launch_counts()['rmw_rows'] == before + 1
  pt.rmw_rows_plain(ref, uids, gsum, hyp, opt)
  assert torch.equal(table.view(torch.int32), ref.view(torch.int32))
  live = uids < rows
  touched = torch.zeros(rows, dtype=torch.bool, device=cuda)
  touched[uids[live & (gsum != 0).any(dim=1)]] = True
  changed = (table.view(torch.int32) != orig.view(torch.int32)).any(dim=1)
  assert not bool((changed & ~touched).any())
  assert bool(changed[touched].all())


def test_wrappers_check_cuda_inputs(cuda):
  sids, order, starts, grads = _segments(cuda, n=64, rows=100, dim=32)
  with pytest.raises(ValueError):
    pt.seg_sum(sids, order, starts.cpu(), grads, 100)
  with pytest.raises(TypeError):
    pt.seg_sum(sids, order, starts, grads.half(), 100)
  uids, gsum = pt.seg_sum(sids, order, starts, grads, 100)
  opt = SparseAdam()
  hyp = opt.hypers(torch.tensor(1e-2, device=cuda),
                   torch.tensor(0, dtype=torch.int32, device=cuda))
  with pytest.raises(ValueError):
    pt.rmw_rows(torch.zeros((64, 100), device=cuda).t(), uids, gsum, hyp,
                opt)


def _table(device, rows, dim, seed, opt=SparseAdam(), compact=True):
  """A random table of `opt`'s layout: weights N(0, 1), Adam moments small
  (v >= 0), accumulators at least 0.1, FTRL's z of either sign."""
  gen = torch.Generator(device=device).manual_seed(seed)

  def randn(scale):
    return torch.randn((rows, dim), generator=gen, device=device) * scale

  def rand(lo, scale):
    return lo + torch.rand((rows, dim), generator=gen,
                           device=device) * scale

  parts = [randn(1.0)]
  for name in opt.slot_names:
    parts.append(rand(0.0, 1e-4) if name == 'v' else
                 rand(0.1, 0.5) if name == 'accum' else
                 randn(0.05) if name == 'z' else randn(1e-3))
  if compact:
    parts = [parts[0], pack_pair(parts[1], parts[2])]
  return torch.cat(parts, dim=1).contiguous()


def _check_fused_against_plain(device, ids, grads, rows, opt=SparseAdam(),
                               compact=True):
  """K3 and its plain version from the same table: every part bit-equal
  (the same f32 additions in the same order, the same IEEE block math);
  rows that are untouched, zero-sum or outside the table keep their
  bytes."""
  dim = grads.shape[1]
  sids, order, starts = pt.sort_segments(ids)
  table = _table(device, rows, dim, 5, opt, compact)
  hyp = opt.hypers(torch.tensor(1e-2, device=device),
                   torch.tensor(2, dtype=torch.int32, device=device))
  orig, ref = table.clone(), table.clone()
  before = kernels.launch_counts()['rmw_fused']
  pt.rmw_fused(table, sids, order, starts, grads, hyp, opt)
  torch.cuda.synchronize()
  assert kernels.launch_counts()['rmw_fused'] == before + 1
  pt.rmw_fused_plain(ref, sids, order, starts, grads, hyp, opt)
  assert torch.equal(table.view(torch.int32), ref.view(torch.int32))
  uids, gsum = pt.seg_sum_plain(sids, order, starts, grads, rows, '0')
  live = uids < rows
  touched = torch.zeros(rows, dtype=torch.bool, device=device)
  touched[uids[live & (gsum != 0).any(dim=1)]] = True
  changed = (table.view(torch.int32) != orig.view(torch.int32)).any(dim=1)
  assert not bool((changed & ~touched).any())
  assert bool(changed[touched].all())


@pytest.mark.parametrize('dim', [16, 32])
def test_rmw_fused_adam_kernel_matches_plain_on_one_long_segment(cuda, dim):
  """A 100k-slot segment (a padding id of a DIN batch) beside short ones:
  391 chunks summed at once, then their sums by the same tree."""
  rows = 50_000
  gen = torch.Generator(device=cuda).manual_seed(7)
  ids = torch.cat([torch.zeros(100_000, dtype=torch.int64, device=cuda),
                   torch.randint(1, rows, (20_000,), generator=gen,
                                 device=cuda)])
  ids[-5:] = rows                         # ids outside the table
  grads = torch.randn((ids.shape[0], dim), generator=gen, device=cuda)
  grads[::11] = 0.0
  _check_fused_against_plain(cuda, ids, grads, rows)


def test_rmw_fused_adam_kernel_matches_plain_on_hot_rows(cuda):
  """The flagship's shape: 13 rows of 4,096 slots each beside 26 x 4,096
  mostly unique ids, dim 32, a 26M-row table."""
  bs, rows = 4096, 26_000_014
  gen = torch.Generator(device=cuda).manual_seed(3)
  hot = torch.arange(13, device=cuda).repeat(bs)
  cold = torch.randint(13, rows, (26 * bs,), generator=gen, device=cuda)
  ids = torch.cat([hot, cold])
  grads = torch.randn((ids.shape[0], 32), generator=gen, device=cuda) * 1e-2
  grads[::97] = 0.0
  _check_fused_against_plain(cuda, ids, grads, rows)


def test_rmw_fused_adam_kernel_short_segments_equal_k1_k2(cuda):
  """Where no segment is longer than the chunk, K3 adds in K1's order:
  bit-equal to K1 (mode 0) followed by K2."""
  rows, dim = 3000, 16
  gen = torch.Generator(device=cuda).manual_seed(9)
  ids = torch.randint(0, rows, (8000,), generator=gen, device=cuda)
  grads = torch.randn((8000, dim), generator=gen, device=cuda)
  sids, order, starts = pt.sort_segments(ids)
  assert int((starts[1:] - starts[:-1]).max()) <= pt.FUSED_CHUNK
  opt = SparseAdam()
  hyp = opt.hypers(torch.tensor(1e-2, device=cuda),
                   torch.tensor(0, dtype=torch.int32, device=cuda))
  a = _table(cuda, rows, dim, 1)
  b = a.clone()
  pt.rmw_fused(a, sids, order, starts, grads, hyp, opt)
  uids, gsum = pt.seg_sum(sids, order, starts, grads, rows, '0')
  pt.rmw_rows(b, uids, gsum, hyp, opt)
  torch.cuda.synchronize()
  assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize('hot', [pt.FUSED_CHUNK + 1, 100_000])
def test_rmw_fused_adam_kernel_long_segments_equal_k1_k2(cuda, hot):
  """K1 and K3 sum by the one chunk tree: bit-equal to K1 (mode 0)
  followed by K2 where a segment spans several chunks, too."""
  rows, dim = 3000, 16
  gen = torch.Generator(device=cuda).manual_seed(10)
  ids = torch.randint(0, rows, (8000,), generator=gen, device=cuda)
  ids = torch.cat([torch.full((hot,), 5, dtype=torch.int64, device=cuda),
                   ids])
  grads = torch.randn((ids.shape[0], dim), generator=gen, device=cuda)
  sids, order, starts = pt.sort_segments(ids)
  opt = SparseAdam()
  hyp = opt.hypers(torch.tensor(1e-2, device=cuda),
                   torch.tensor(0, dtype=torch.int32, device=cuda))
  a = _table(cuda, rows, dim, 1)
  b = a.clone()
  pt.rmw_fused(a, sids, order, starts, grads, hyp, opt)
  uids, gsum = pt.seg_sum(sids, order, starts, grads, rows, '0')
  pt.rmw_rows(b, uids, gsum, hyp, opt)
  torch.cuda.synchronize()
  assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize('fused', ['0', '1'])
def test_train_step_launches_each_kernel_once(cuda, fused, monkeypatch):
  """A small DeepFM step on the card goes through K1 and K2 once per fused
  table, or through K3 alone under EASYREC_PACKED_FUSED=1."""
  monkeypatch.setenv('EASYREC_PACKED_FUSED', fused)
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils import flagship
  from easyrec_torch.utils.synthetic import synthetic_batch
  cfg = flagship.criteo_deepfm_config(batch_size=128, hash_bucket_size=500,
                                      num_dense=2, num_cat=3)
  trainer = Trainer(cfg, device='cuda')
  trainer.init_state()
  batch = to_device(synthetic_batch(trainer.specs, ['label'], 128), cuda)
  kernels.reset_launches()
  out = trainer.train_step(batch)
  assert np.isfinite(float(out['total_loss']))
  n = len(trainer.tables)
  want = {'seg_sum': 0, 'rmw_rows': 0, 'rmw_fused': n} if fused == '1' \
      else {'seg_sum': n, 'rmw_rows': n, 'rmw_fused': 0}
  want.update(group_push=0, group_rmw=0)
  assert kernels.launch_counts() == want


def _groups(device, groups, width, n_real, n_pad, idx_dtype, seed):
  """A random [groups, 8, width] table and slot ids: n_real unique
  sorted groups below the scratch group (the last), then n_pad slots
  naming the scratch group."""
  gen = torch.Generator(device=device).manual_seed(seed)
  table = torch.randn((groups, 8, width), generator=gen, device=device)
  real = torch.randperm(groups - 1, generator=gen, device=device)[:n_real]
  gids = torch.cat([real.sort().values,
                    torch.full((n_pad,), groups - 1, device=device,
                               dtype=torch.int64)]).to(idx_dtype)
  return table, gids


@pytest.mark.parametrize('idx_dtype', [torch.int32, torch.int64])
@pytest.mark.parametrize('width', [128, 384])
def test_group_push_kernel_matches_plain(cuda, width, idx_dtype):
  """K4 byte-equal to its plain version (index_copy_) over the whole
  table, scratch group included: pad slots carry its current bytes."""
  from easyrec_torch.ops import group_dma
  table, gids = _groups(cuda, 3000, width, 1700, 300, idx_dtype, 11)
  n = gids.shape[0]
  gen = torch.Generator(device=cuda).manual_seed(12)
  rows = torch.randn((n, 8, width), generator=gen, device=cuda)
  rows[1700:] = table[-1]
  ref = table.clone()
  before = kernels.launch_counts()['group_push']
  group_dma.group_push(table, gids, rows)
  torch.cuda.synchronize()
  assert kernels.launch_counts()['group_push'] == before + 1
  group_dma.group_push_plain(ref, gids, rows)
  assert torch.equal(table.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize('shape', [(64, 4), (256, 1), (32, 8), (1024, 1)])
@pytest.mark.parametrize('grad', [False, True])
@pytest.mark.parametrize('width', [128, 384])
def test_group_rmw_kernel_matches_plain(cuda, width, grad, shape):
  """K5 byte-equal to its plain version (the same f32 roundings in the
  same order, no FMA on either side), the scratch group excluded: its pad
  slots race on the card. Every other group keeps its bytes."""
  from easyrec_torch.ops import group_dma
  table, gids = _groups(cuda, 3000, width, 1700, 300, torch.int32, 13)
  n = gids.shape[0]
  gen = torch.Generator(device=cuda).manual_seed(14)
  gg = torch.randn((n, 8, width), generator=gen, device=cuda) if grad \
      else None
  a, b, c = (0.999, 0.0, -0.001) if grad else (0.999, 0.001, 0.0)
  orig, ref = table.clone(), table.clone()
  threads, per_block = shape
  before = kernels.launch_counts()['group_rmw']
  group_dma.group_rmw(table, gids, a, b, gg=gg, c=c, threads=threads,
                      per_block=per_block)
  torch.cuda.synchronize()
  assert kernels.launch_counts()['group_rmw'] == before + 1
  group_dma.group_rmw_plain(ref, gids, a, b, gg=gg, c=c)
  assert torch.equal(table[:-1].view(torch.int32), ref[:-1].view(torch.int32))
  listed = torch.zeros(3000, dtype=torch.bool, device=cuda)
  listed[gids.long()] = True
  changed = (table.view(torch.int32) != orig.view(torch.int32)).flatten(
      1).any(dim=1)
  assert not bool((changed & ~listed).any())


def test_group_wrappers_check_cuda_inputs(cuda):
  from easyrec_torch.ops import group_dma
  table, gids = _groups(cuda, 100, 128, 10, 0, torch.int32, 1)
  rows = torch.zeros((10, 8, 128), device=cuda)
  with pytest.raises(ValueError):
    group_dma.group_push(table, gids.cpu(), rows)
  buf = torch.zeros(100 * 8 * 128 + 1, device=cuda)
  with pytest.raises(ValueError):                 # not 16-byte aligned
    group_dma.group_push(buf[1:].view(100, 8, 128), gids, rows)
  with pytest.raises(ValueError):
    group_dma.group_rmw(table, gids, 0.5, 0.0, threads=48)


@pytest.mark.parametrize('bad_id', [-1, 3000, 1 << 40])
@pytest.mark.parametrize('kernel', ['push', 'rmw'])
def test_group_kernels_flag_ids_outside_the_table(cuda, kernel, bad_id):
  """An id outside [0, G) in one slot: the kernel leaves that slot out
  (the table equals the plain version run on the other slots), sets its
  flag, and check_ids raises IndexError as the plain version does at the
  call; the flag is then clear. (The plain version is not run on the bad
  id here: index_copy_ on a CUDA tensor asserts on the device.)"""
  from easyrec_torch.ops import group_dma
  table, gids = _groups(cuda, 3000, 128, 500, 0, torch.int64, 15)
  group_dma.check_ids(cuda)
  bad = gids.clone()
  bad[200] = bad_id
  keep = torch.ones(500, dtype=torch.bool, device=cuda)
  keep[200] = False
  gen = torch.Generator(device=cuda).manual_seed(16)
  rows = torch.randn((500, 8, 128), generator=gen, device=cuda)
  ref = table.clone()
  if kernel == 'push':
    group_dma.group_push(table, bad, rows)
    group_dma.group_push_plain(ref, gids[keep], rows[keep].contiguous())
  else:
    group_dma.group_rmw(table, bad, 0.999, 0.0, gg=rows, c=-0.001)
    group_dma.group_rmw_plain(ref, gids[keep], 0.999, 0.0,
                              gg=rows[keep].contiguous(), c=-0.001)
  with pytest.raises(IndexError, match='group_' + kernel):
    group_dma.check_ids(cuda)
  group_dma.check_ids(cuda)
  assert torch.equal(table.view(torch.int32), ref.view(torch.int32))


# every block math of K2 and K3, with its layout (compact for the compact
# Adam); the constants are off their defaults so every term runs
MATHS = {
    'sgd': (sparse.SparseSGD(), False),
    'momentum': (sparse.SparseMomentum(0.8), False),
    'adagrad': (sparse.SparseAdagrad(), False),
    'adam': (SparseAdam(weight_decay=0.01), False),
    'compact_adam': (SparseAdam(weight_decay=0.01), True),
    'ftrl': (sparse.SparseFtrl(l1=0.01, l2=0.02, l2_shrinkage=0.05), False),
}
MATH_DIMS = [3, 16, 32, 100, 160, 256]


@pytest.mark.parametrize('dim', MATH_DIMS)
@pytest.mark.parametrize('which', sorted(MATHS))
def test_rmw_rows_kernel_matches_plain_for_every_math(cuda, which, dim):
  """K2 with each block math against rmw_rows_plain, bit-exact over the
  whole table: hot rows (the summed gradients of K1's long segments), a
  sentinel tail, zero-sum rows and ids outside the table; at dims not a
  multiple of 4 (scalar loads), one float4 a lane (up to 128) and above
  (each slot by a whole warp, its gradient read twice)."""
  opt, compact = MATHS[which]
  rows = 20_000
  ids, grads = _mixed_segments(cuda, dim, rows, 30)
  ids[-5:] = rows                          # ids outside the table
  sids, order, starts = pt.sort_segments(ids)
  uids, gsum = pt.seg_sum(sids, order, starts, grads, rows, '0')
  assert int((uids == rows).sum()) > 0     # a sentinel tail
  table = _table(cuda, rows, dim, 31, opt, compact)
  hyp = opt.hypers(torch.tensor(2e-2, device=cuda),
                   torch.tensor(3, dtype=torch.int32, device=cuda))
  orig, ref = table.clone(), table.clone()
  before = dict(kernels.tagged_counts())
  pt.rmw_rows(table, uids, gsum, hyp, opt)
  torch.cuda.synchronize()
  tag = 'rmw_rows/%s' % sparse.MATH_NAMES[opt.kernel_math(compact)[0]]
  assert kernels.tagged_counts()[tag] == before.get(tag, 0) + 1
  pt.rmw_rows_plain(ref, uids, gsum, hyp, opt)
  assert torch.equal(table.view(torch.int32), ref.view(torch.int32))
  live = uids < rows
  touched = torch.zeros(rows, dtype=torch.bool, device=cuda)
  touched[uids[live & (gsum != 0).any(dim=1)]] = True
  changed = (table.view(torch.int32) != orig.view(torch.int32)).any(dim=1)
  assert not bool((changed & ~touched).any())
  assert bool(changed[touched].all())


@pytest.mark.parametrize('dim', MATH_DIMS)
@pytest.mark.parametrize('which', sorted(MATHS))
def test_rmw_fused_kernel_matches_plain_for_every_math(cuda, which, dim):
  """K3 with each block math against rmw_fused_plain, bit-exact, on tiny,
  short and long segments beside ids outside the table; at dims 160 and
  256 (the JAX package's fused kernel takes compact Adam to 256) the sums
  past the first 128 columns are taken twice, by the same tree."""
  opt, compact = MATHS[which]
  ids, grads = _mixed_segments(cuda, dim, 20_000, 32)
  ids[-5:] = 20_000
  _check_fused_against_plain(cuda, ids, grads, 20_000, opt, compact)


EV_MATHS = {'ev_add': sparse.EvAdd(), 'ev_set': sparse.EvSet()}


def _ev_inputs(device, rows, seed):
  """The EV aux tables' update: a [rows, 1] table of counts or steps, the
  ids of _mixed_segments (hot ids up to 3,000 slots, ids outside the
  table) with a gradient of ones, every 13th slot zero (a zero-sum row
  keeps its bytes)."""
  ids, _ = _mixed_segments(device, 1, rows, seed)
  ids[-5:] = rows
  ones = torch.ones((ids.shape[0], 1), device=device)
  ones[::13] = 0.0
  gen = torch.Generator(device=device).manual_seed(seed)
  table = torch.randint(0, 50, (rows, 1), generator=gen,
                        device=device).to(torch.float32)
  return ids, ones, table


@pytest.mark.parametrize('mode', ['0', '1'])
@pytest.mark.parametrize('which', sorted(EV_MATHS))
def test_rmw_rows_kernel_ev_maths_at_dim_1(cuda, which, mode):
  """K2 with ev_add and ev_set on a [rows, 1] aux table (a lane group of
  one lane, scalar loads) after K1 in modes 0 and 1: bit-exact against
  rmw_rows_plain over the whole table, hot ids, a sentinel tail and ids
  outside the table included; only touched rows change."""
  opt, rows = EV_MATHS[which], 20_000
  ids, ones, table = _ev_inputs(cuda, rows, 40)
  sids, order, starts = pt.sort_segments(ids)
  uids, gsum = pt.seg_sum(sids, order, starts, ones, rows, mode)
  assert int((uids == rows).sum()) > 0
  hyp = opt.hypers(None, torch.tensor(37, dtype=torch.int32, device=cuda))
  orig, ref = table.clone(), table.clone()
  before = dict(kernels.tagged_counts())
  pt.rmw_rows(table, uids, gsum, hyp, opt)
  torch.cuda.synchronize()
  tag = 'rmw_rows/' + which
  assert kernels.tagged_counts()[tag] == before.get(tag, 0) + 1
  pt.rmw_rows_plain(ref, uids, gsum, hyp, opt)
  assert torch.equal(table.view(torch.int32), ref.view(torch.int32))
  live = uids < rows
  touched = torch.zeros(rows, dtype=torch.bool, device=cuda)
  touched[uids[live & (gsum[:, 0] != 0)]] = True
  changed = table[:, 0] != orig[:, 0]
  assert not bool((changed & ~touched).any())
  if which == 'ev_set':
    assert bool((table[touched, 0] == 37.0).all())


@pytest.mark.parametrize('which', sorted(EV_MATHS))
def test_rmw_fused_kernel_ev_maths_at_dim_1(cuda, which):
  """K3 with ev_add and ev_set at dim 1 against rmw_fused_plain, bit-exact,
  on the same segments (f32 sums: a count up to 3,000 stays exact)."""
  opt, rows = EV_MATHS[which], 20_000
  ids, ones, table = _ev_inputs(cuda, rows, 41)
  sids, order, starts = pt.sort_segments(ids)
  hyp = opt.hypers(None, torch.tensor(37, dtype=torch.int32, device=cuda))
  ref = table.clone()
  before = dict(kernels.tagged_counts())
  pt.rmw_fused(table, sids, order, starts, ones, hyp, opt)
  torch.cuda.synchronize()
  tag = 'rmw_fused/' + which
  assert kernels.tagged_counts()[tag] == before.get(tag, 0) + 1
  pt.rmw_fused_plain(ref, sids, order, starts, ones, hyp, opt)
  assert torch.equal(table.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize('fused', ['0', '1'])
def test_ev_train_step_launches_the_ev_maths(cuda, fused, monkeypatch):
  """A DeepFM step with ev_params (filter_freq and steps_to_live on its id
  features) updates its count and last-seen tables through K2 (or K3)
  with ev_add and ev_set, once each a step, beside the table's Adam."""
  monkeypatch.setenv('EASYREC_PACKED_FUSED', fused)
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils import flagship
  from easyrec_torch.utils.synthetic import synthetic_batch
  cfg = flagship.criteo_deepfm_config(batch_size=128, hash_bucket_size=500,
                                      num_dense=2, num_cat=3)
  for fc in cfg.feature_config.features:
    if fc.feature_type == 'IdFeature':
      ev = fc.ev_params
      ev.filter_freq, ev.steps_to_live = 2, 10
      fc.ev_params = ev
  trainer = Trainer(cfg, device='cuda')
  trainer.init_state()
  batch = to_device(synthetic_batch(trainer.specs, ['label'], 128), cuda)
  kernels.reset_launches()
  for _ in range(2):
    trainer.train_step(batch)
  k = 'rmw_fused' if fused == '1' else 'rmw_rows'
  assert kernels.tagged_counts() == {k + '/compact_adam': 2,
                                     k + '/ev_add': 2, k + '/ev_set': 2}
  (key, aux), = trainer.ev_state.items()
  assert float(aux['ev_count'].max()) >= 2
  assert float(aux['ev_last'].max()) == 1.0


def test_predictor_on_the_card_matches_the_cpu(cuda, tmp_path):
  """A bundle of the fixture DeepFM with BatchNorm and an EMA, trained 3
  steps on the CPU and exported: the Predictor on the card answers the
  CPU Predictor's rows within 1e-5 (f32, the card's matmul and reduction
  orders differ from the CPU's), with no launch of K1-K5 (its gather is
  index_select)."""
  from easyrec_torch.export.predictor import Predictor
  from easyrec_torch.export.saved_model import export_saved_model
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils import flagship
  from easyrec_torch.utils.synthetic import synthetic_batch
  cfg = flagship.criteo_deepfm_config(batch_size=128, hash_bucket_size=500,
                                      num_dense=3, num_cat=4)
  opt = cfg.train_config.optimizer_config[0]
  opt.use_moving_average = True
  opt.moving_average_decay = 0.99
  trainer = Trainer(cfg, device='cpu')
  trainer.init_state()
  for s in range(3):
    trainer.train_step(to_device(synthetic_batch(trainer.specs, ['label'],
                                                 128, seed=s),
                                 torch.device('cpu')))
  export_dir = export_saved_model(trainer, str(tmp_path))
  rng = np.random.default_rng(0)
  rows = [dict({'F%d' % i: str(rng.random() * 1000) for i in (1, 2, 3)},
               **{'C%d' % i: 'id%d' % rng.integers(0, 900)
                  for i in (1, 2, 3, 4)}) for _ in range(300)]
  want = Predictor(export_dir, batch_size=128, device='cpu').predict(rows)
  kernels.reset_launches()
  card = Predictor(export_dir, batch_size=128, device='cuda')
  assert all(t.is_cuda for t in card.tables.values())
  got = card.predict(rows)
  torch.cuda.synchronize()
  assert sum(kernels.launch_counts().values()) == 0
  for key in ('probs', 'logits'):
    np.testing.assert_allclose([float(r[key]) for r in got],
                               [float(r[key]) for r in want],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('fused', ['0', '1'])
def test_bst_trains_on_the_card_as_on_the_cpu(cuda, fused, monkeypatch):
  """A small Taobao BST (two dim-16 histories of length 8, hidden 32, 4
  heads) trained 3 steps on the card and on the CPU from one state, under
  EASYREC_ATTN_IMPL=stock: losses within 1e-5 relative, table weights
  within 1e-5 but 1 in 100 (each within 2 lr a step: chip_smoke.py's
  agree rule, for gradient sums that cancel to rounding noise), K1 + K2
  or K3 once a step."""
  monkeypatch.setenv('EASYREC_PACKED_FUSED', fused)
  monkeypatch.setenv('EASYREC_ATTN_IMPL', 'stock')
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils import flagship
  from easyrec_torch.utils.synthetic import synthetic_batch
  cfg = flagship.taobao_bst_config(batch_size=256, seq_len=8)
  runs = {}
  for name in ('cpu', 'cuda'):
    runs[name] = Trainer(cfg, device=name)
    runs[name].init_state()
  runs['cuda'].model.load_state_dict(runs['cpu'].model.state_dict())
  for key, table in runs['cpu'].tables.items():
    runs['cuda'].tables[key].copy_(table)
  kernels.reset_launches()
  losses = {}
  for name, t in runs.items():
    losses[name] = [float(t.train_step(to_device(
        synthetic_batch(t.specs, ['clk'], 256, seed=s),
        torch.device(name)))['total_loss']) for s in range(3)]
  np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=1e-5)
  n = len(runs['cuda'].tables)
  want = {'seg_sum': 0, 'rmw_rows': 0, 'rmw_fused': 3 * n} if fused == '1' \
      else {'seg_sum': 3 * n, 'rmw_rows': 3 * n, 'rmw_fused': 0}
  want.update(group_push=0, group_rmw=0)
  assert kernels.launch_counts() == want
  lr_sum = sum(float(runs['cpu'].embed_pair.schedule(torch.tensor(s)))
               for s in range(3))
  for key, table in runs['cpu'].tables.items():
    dim = runs['cpu'].metas[key].dim
    diff = (runs['cuda'].tables[key][:, :dim].cpu() - table[:, :dim]).abs()
    assert int((diff > 1e-5).sum()) <= diff.numel() // 100
    assert float(diff.max()) <= 2 * lr_sum
