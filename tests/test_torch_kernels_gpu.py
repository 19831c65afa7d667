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


@pytest.mark.parametrize('dim', [32, 16])
def test_rmw_adam_kernel_matches_plain(cuda, dim):
  """m/v bit-exact, w within 1 ulp; untouched and sentinel rows keep their
  bytes."""
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
  before = kernels.launch_counts()['rmw_adam']
  pt.rmw_adam(table, uids, gsum, hyp, opt)
  torch.cuda.synchronize()
  assert kernels.launch_counts()['rmw_adam'] == before + 1
  pt.rmw_adam_plain(ref, uids, gsum, hyp, opt)
  assert torch.equal(table[:, dim:].contiguous().view(torch.int32),
                     ref[:, dim:].contiguous().view(torch.int32))
  ulp = (table[:, :dim].contiguous().view(torch.int32).long() -
         ref[:, :dim].contiguous().view(torch.int32).long()).abs().max()
  assert int(ulp) <= 1
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
    pt.rmw_adam(torch.zeros((64, 100), device=cuda).t(), uids, gsum, hyp,
                opt)


def _table(device, rows, dim, seed):
  gen = torch.Generator(device=device).manual_seed(seed)
  table = torch.empty((rows, 2 * dim), device=device)
  table[:, :dim] = torch.randn((rows, dim), generator=gen, device=device)
  table[:, dim:] = pack_pair(
      torch.randn((rows, dim), generator=gen, device=device) * 1e-3,
      torch.rand((rows, dim), generator=gen, device=device) * 1e-4)
  return table


def _check_fused_against_plain(device, ids, grads, rows):
  """K3 and its plain version from the same table: w, m and v bit-equal
  (the same f32 additions in the same order, the same IEEE Adam); rows
  that are untouched, zero-sum or outside the table keep their bytes."""
  dim = grads.shape[1]
  sids, order, starts = pt.sort_segments(ids)
  table = _table(device, rows, dim, 5)
  opt = SparseAdam()
  hyp = opt.hypers(torch.tensor(1e-2, device=device),
                   torch.tensor(2, dtype=torch.int32, device=device))
  orig, ref = table.clone(), table.clone()
  before = kernels.launch_counts()['rmw_fused_adam']
  pt.rmw_fused_adam(table, sids, order, starts, grads, hyp, opt)
  torch.cuda.synchronize()
  assert kernels.launch_counts()['rmw_fused_adam'] == before + 1
  pt.rmw_fused_adam_plain(ref, sids, order, starts, grads, hyp, opt)
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
  the two-level path, 391 chunks summed in parallel then in order."""
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
  pt.rmw_fused_adam(a, sids, order, starts, grads, hyp, opt)
  uids, gsum = pt.seg_sum(sids, order, starts, grads, rows, '0')
  pt.rmw_adam(b, uids, gsum, hyp, opt)
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
  want = {'seg_sum': 0, 'rmw_adam': 0, 'rmw_fused_adam': n} if fused == '1' \
      else {'seg_sum': n, 'rmw_adam': n, 'rmw_fused_adam': 0}
  assert kernels.launch_counts() == want
