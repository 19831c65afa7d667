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


def test_train_step_launches_each_kernel_once(cuda):
  """A small DeepFM step on the card goes through both kernels once per
  fused table."""
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
  assert kernels.launch_counts() == {'seg_sum': len(trainer.tables),
                                     'rmw_adam': len(trainer.tables)}
