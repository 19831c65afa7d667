"""K7's plain version and its engagement in the train step on the CPU
(ops/embedding.py pool_bags_plain, pool_bags_grad_plain, PoolBags,
StepPulls.pooled): the pack's pooling against per-feature `combine`, the
pack's leaf gradient against the split path's on MLPerf DLRM-DCNv2's 26
bags (recbench/tests/small.py's size), which packs are pooled, the span
easyrec.embed.pool and the attribution of its backward, and the step's
lifetime. The kernel itself is held bit-equal to the plain version on the
card (tests/test_torch_kernels_gpu.py)."""

import json
import os
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from easyrec_torch.ops import embedding as emb_ops
from easyrec_torch.ops import packed_table as pt
from easyrec_torch.train.trainer import Trainer
from recbench import harness, trace, traffic
from recbench.cell import load_cell
from recbench.tests.small import SMALL
from tests.test_torch_embed_split import (_batch, _deepfm, _keep_pulled,
                                          _step, _ulp)

CELL = 'dlrm_dcnv2.multihot_b16384'
SEED = 2 ** 31 + 4099
# MLPerf DLRM-DCNv2's multi-hot bag sizes
DLRM_BAGS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1)


def _bags(sizes, means):
  out, at = [], 0
  for k, m in zip(sizes, means):
    out.append((at, k, int(m)))
    at += k
  return tuple(out)


def _reorder_bound(terms, k):
  """What two orders of a bag's sum may differ by: each rounds its k
  products and k - 1 sums at most half an ulp of the sum of the terms'
  magnitudes S, so they lie within (2k - 1) ulp(S) of each other."""
  return (2 * k - 1) * _ulp(terms.abs().sum(dim=1))


@pytest.mark.parametrize('dim', [16, 128])
def test_plain_pooling_is_combine_within_its_rounding(dim):
  """(a) Bags of 1, 2, 7 and 100 slots, sum and mean, each example's bag
  cut at a random length with weight-0 padding behind it (positive random
  weights in the sum bags, 1 in the mean bags): every bag of
  pool_bags_plain within the reordering bound of combine's, and equal to
  it where the bag has a single term."""
  gen = torch.Generator().manual_seed(dim)
  sizes = (1, 2, 7, 100) * 2
  means = (0,) * 4 + (1,) * 4
  bags = _bags(sizes, means)
  n, tot = 48, sum(sizes)
  rows = torch.randn((n, tot, dim), generator=gen)
  w = torch.ones((n, tot))
  for start, k, mean in bags:
    if not mean:
      w[:, start:start + k] = 0.25 + torch.rand((n, k), generator=gen)
    keep = torch.randint(0, k + 1, (n, 1), generator=gen)
    w[:, start:start + k] *= (torch.arange(k) < keep).float()
  out = emb_ops.pool_bags_plain(rows, w, bags)
  assert out.shape == (n, len(bags), dim)
  for j, (start, k, mean) in enumerate(bags):
    r, ww = rows[:, start:start + k], w[:, start:start + k]
    want = emb_ops.combine(r, ww, 'mean' if mean else 'sum')
    terms = ww[:, :, None] * r
    gap = (out[:, j] - want).abs()
    if mean:
      # the weights are 0 and 1: both denominators are the same whole
      # number, and each side's division rounds once more
      den = torch.clamp(ww.sum(dim=1, keepdim=True), min=1e-9)
      bound = _reorder_bound(terms, k) / den + _ulp(want)
    else:
      bound = _reorder_bound(terms, k)
    assert bool((gap <= bound).all()), (k, mean, float(gap.max()))
    single = (ww > 0).sum(dim=1) <= 1
    assert torch.equal(out[single, j], want[single]), (k, mean)
  # the padding's rows do not count: a bag of weight 0 pools to zero
  empty = w[:, bags[3][0]:bags[3][0] + 100].sum(dim=1) == 0
  assert torch.equal(out[empty, 3], torch.zeros_like(out[empty, 3]))


def test_plain_backward_is_each_weight_times_its_bags_gradient():
  """(a) pool_bags_grad_plain writes every slot once: a sum bag's slot
  gets w * g bit for bit (combine's backward product), a mean bag's
  w * (g / denominator); PoolBags' backward is it."""
  gen = torch.Generator().manual_seed(5)
  bags = _bags((2, 7, 1), (0, 1, 0))
  rows = torch.randn((8, 10, 16), generator=gen)
  w = torch.rand((8, 10), generator=gen)
  w[:, 3:5] = 0.0
  g = torch.randn((8, 3, 16), generator=gen)
  got = emb_ops.pool_bags_grad_plain(g, w, bags)
  den = torch.clamp(w[:, 2:9].sum(dim=1), min=1e-9)
  assert torch.equal(got[:, 0:2], w[:, 0:2, None] * g[:, 0:1])
  assert torch.equal(got[:, 9:10], w[:, 9:10, None] * g[:, 2:3])
  assert torch.allclose(got[:, 2:9], w[:, 2:9, None] *
                        (g[:, 1:2] / den[:, None, None]), rtol=1e-6,
                        atol=0)
  assert torch.equal(got[:, 3:5], torch.zeros_like(got[:, 3:5]))
  leaf = rows.clone().requires_grad_()
  emb_ops.PoolBags.apply(leaf, w, bags).backward(g)
  assert torch.equal(leaf.grad, got)


def test_the_wrappers_check_their_arguments():
  """pool_bags and pool_bags_grad refuse, before any launch, weights of
  another shape, bags that hold other than the weights' slots, a pack
  that is not f32, and a gradient of another number of bags."""
  rows, w = torch.zeros((4, 5, 8)), torch.ones((4, 5))
  bags = _bags((2, 3), (0, 1))
  assert emb_ops.pool_bags(rows, w, bags).shape == (4, 2, 8)
  for args in ((rows, w[:, :4], bags), (rows, w, ((0, 2, 0), (3, 2, 0))),
               (rows, w, ((0, 2, 0),)), (rows.double(), w, bags)):
    with pytest.raises(ValueError):
      emb_ops.pool_bags(*args)
  with pytest.raises(ValueError):
    emb_ops.pool_bags_grad(torch.zeros((4, 3, 8)), w, bags)
  assert emb_ops.pool_bags_grad(torch.zeros((4, 2, 8)), w, bags).shape == \
      (4, 5, 8)


def _dlrm():
  cell = load_cell(CELL, shrink=SMALL)
  trainer = Trainer(cell.pipeline_config(), device='cpu')
  trainer.init_state()
  feats = harness.model_description(cell)['features']
  batch = traffic.make_batch(feats, cell.traffic, SEED, 0,
                             torch.device('cpu'))
  return trainer, batch


def _split_only(monkeypatch):
  """No layout pooled: every pack takes the split and combine."""
  monkeypatch.setattr(emb_ops, 'pool_layout', lambda layout, key: None)


def _bag_outputs(trainer, batch, upstream):
  """The 26 bags of the DLRM's pack read through a StepPulls, and the
  pack's leaf gradient for the fixed `upstream` gradient of the bags."""
  names = [u.feature for u in trainer.layout.tables['emb128'].uses]
  packs = emb_ops.pack_all_views(trainer.layout, batch)
  pulled = {k: v.detach().clone().requires_grad_()
            for k, v in trainer.pull(packs).items()}
  layer = trainer.ctx.input_layer
  steps = emb_ops.StepPulls(pulled, trainer.layout)
  out = torch.stack([layer.feature_embedding(steps, batch, f)
                     for f in names], dim=1)
  out.backward(upstream)
  return out.detach(), pulled['emb128'].grad


def test_dlrm_leaf_gradient_against_the_split_path(monkeypatch):
  """(b) The DLRM-DCNv2's pack (26 bags of the published sizes, 214 slots,
  every weight 1): the bags within the reordering bound of the split
  path's and, for one upstream gradient, the pack's leaf gradient bit for
  bit (w * g, one product a slot on both paths). Through whole train
  steps the leaf gradient stays within 1e-5 of the split path's in norm
  (the dense model carries the bags' last-bit differences), the losses
  within 1e-6."""
  trainer, batch = _dlrm()
  uses = trainer.layout.tables['emb128'].uses
  assert tuple(u.k for u in uses) == DLRM_BAGS
  assert emb_ops.pool_layout(trainer.layout, 'emb128') == \
      _bags(DLRM_BAGS, (0,) * 26)
  upstream = torch.randn((64, 26, 128),
                         generator=torch.Generator().manual_seed(3))
  new, g_new = _bag_outputs(trainer, batch, upstream)
  with monkeypatch.context() as m:
    _split_only(m)
    old, g_old = _bag_outputs(trainer, batch, upstream)
  pack = trainer.pull(emb_ops.pack_all_views(trainer.layout, batch))
  for j, u in enumerate(uses):
    terms = pack['emb128'][:, u.start:u.start + u.k]
    assert bool(((new[:, j] - old[:, j]).abs() <=
                 _reorder_bound(terms, u.k)).all()), u.feature
  assert torch.equal(g_new, g_old)
  # whole train steps, from one state
  split, _ = _dlrm()
  split.model.load_state_dict(trainer.model.state_dict())
  for key, table in trainer.tables.items():
    split.tables[key].copy_(table)
  o_new, l_new, _, _ = _step(trainer, batch)
  with monkeypatch.context() as m:
    _split_only(m)
    o_old, l_old, _, _ = _step(split, batch)
  assert abs(float(o_new['total_loss']) - float(o_old['total_loss'])) <= \
      1e-6 * abs(float(o_old['total_loss']))
  a, b = l_new['emb128'], l_old['emb128']
  assert float(torch.linalg.vector_norm(a - b)) <= \
      1e-5 * float(torch.linalg.vector_norm(b))
  assert float(torch.linalg.vector_norm(b)) > 0


def test_the_dlrm_pools_its_pack_and_splits_nothing(tmp_path):
  """(c) The DLRM-DCNv2's step: all 26 uses served from the pooled pack,
  none from a piece or a slice, and no easyrec.embed.split span."""
  trainer, batch = _dlrm()
  emb_ops.reset_use_counts()
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    trainer.train_step(batch)
  assert emb_ops.use_counts() == {'piece': 0, 'slice': 0, 'pooled': 26}
  names = [n for _, _, n in _spans(_events(prof, tmp_path))]
  assert 'easyrec.embed.split' not in names
  assert names.count('easyrec.embed.pool') == 1


def test_the_deepfm_keeps_the_split_bit_for_bit(tmp_path, monkeypatch):
  """(c) The DeepFM's table merges its wide column into the deep rows, so
  its pack is not pooled: no use counted `pooled`, and its losses, leaf
  gradient and updated table are the split path's bits."""
  trainer = _deepfm(tmp_path / 'new', 1e-5)
  assert emb_ops.pool_layout(trainer.layout, 'emb8') is None
  batch = _batch(trainer)
  emb_ops.reset_use_counts()
  o_new, g_new, t_new, _ = _step(trainer, batch)
  assert emb_ops.use_counts()['pooled'] == 0
  old = _deepfm(tmp_path / 'old', 1e-5)
  with monkeypatch.context() as m:
    _split_only(m)
    o_old, g_old, t_old, _ = _step(old, batch)
  for k in o_new:
    assert torch.equal(o_new[k], o_old[k]), k
  assert torch.equal(g_new['emb8'], g_old['emb8'])
  for k in t_new:
    assert torch.equal(t_new[k], t_old[k]), k


def test_eval_reads_the_dlrm_bags_through_combine():
  """Eval hands the model a plain dict: nothing is pooled, every use is a
  slice, and the outputs agree with a pooled forward to rounding."""
  trainer, batch = _dlrm()
  with torch.no_grad():
    pulled = trainer.pull(emb_ops.pack_all_views(trainer.layout, batch))
    emb_ops.reset_use_counts()
    plain = trainer.eval_forward(batch, pulled)
    assert emb_ops.use_counts() == {'piece': 0, 'slice': 26, 'pooled': 0}
    pooled = trainer.eval_forward(batch, emb_ops.StepPulls(pulled,
                                                           trainer.layout))
  assert emb_ops.use_counts()['pooled'] == 26
  torch.testing.assert_close(pooled['logits'], plain['logits'], rtol=1e-5,
                             atol=1e-6)


def _events(prof, tmp_path):
  path = os.path.join(str(tmp_path), 'trace.json')
  prof.export_chrome_trace(path)
  with open(path) as f:
    return json.load(f)['traceEvents']


def _spans(events):
  return [(float(e['ts']), float(e['ts']) + float(e['dur']), e['name'])
          for e in events if e.get('ph') == 'X' and
          e.get('cat') == 'user_annotation' and
          e['name'].startswith('easyrec.')]


def _with_kernels(events):
  """The CPU trace with a canned kernel launched inside each of the
  pooling's forward operations (PoolBags, the unbind) and inside the
  autograd engine's evaluation of each of their nodes, as the card's
  trace would have them: (events, {kernel name: the span it belongs
  to})."""
  ops = [e for e in events if e.get('ph') == 'X' and
         e.get('cat') == 'cpu_op']
  picks = [('pool_fwd', 'PoolBags'), ('unbind_fwd', 'aten::unbind'),
           ('pool_bwd', 'autograd::engine::evaluate_function: '
                        'PoolBagsBackward'),
           ('unbind_bwd', 'autograd::engine::evaluate_function: '
                          'UnbindBackward0')]
  out, want = list(events), {}
  for i, (kname, opname) in enumerate(picks):
    found = [e for e in ops if e['name'] == opname]
    assert len(found) == 2, opname             # once a step, two steps
    for s, e in enumerate(found):
      t = float(e['ts']) + 0.01
      corr = 900000 + 10 * i + s
      out.append({'ph': 'X', 'cat': 'cuda_runtime',
                  'name': 'cudaLaunchKernel', 'ts': t, 'dur': 0.001,
                  'pid': e['pid'], 'tid': e['tid'],
                  'args': {'correlation': corr}})
      out.append({'ph': 'X', 'cat': 'kernel', 'name': kname, 'ts': t + 5,
                  'dur': 100.0 * (i + 1), 'pid': 0, 'tid': 7,
                  'args': {'correlation': corr}})
    want[kname] = ('backward:easyrec.embed.pool' if kname.endswith('bwd')
                   else 'easyrec.embed.pool')
  return out, want


def test_the_pool_span_holds_both_directions(tmp_path):
  """(d) Under a CPU profiler, easyrec.embed.pool shows once a pooled
  pack a step, inside easyrec.embed; the trace's parse
  (recbench/trace.py parse_spans, which bag_pool_ms reads) gives a kernel
  launched by the pooling forward to the span and one launched by the
  autograd engine for the pooling's nodes to its backward, so the
  metric's span reader counts both directions."""
  trainer, batch = _dlrm()
  trainer.train_step(batch)                  # the first step, untraced
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    trainer.train_step(batch)
    trainer.train_step(batch)
  events = _events(prof, tmp_path)
  got = _spans(events)
  by = {}
  for s in got:
    by.setdefault(s[2], []).append(s)
  assert len(by['easyrec.step']) == 2
  assert len(by['easyrec.embed.pool']) == 2
  for lo, hi, _ in by['easyrec.step']:
    assert sum(lo <= s[0] and s[1] <= hi
               for s in by['easyrec.embed.pool']) == 1
  for s in by['easyrec.embed.pool']:
    assert any(lo <= s[0] and s[1] <= hi
               for lo, hi, _ in by['easyrec.embed']), s
  canned, want = _with_kernels(events)
  parsed = trace.parse_spans(canned, steps=2)
  ranges = {op.name: op.range for op in parsed.ops}
  assert ranges == want
  # 100 + 200 us forward, 300 + 400 us backward, a step
  assert trace.span_ms(parsed, ['easyrec.embed.pool']) == \
      pytest.approx(1.0)


def test_nothing_of_a_pooled_step_outlives_it(monkeypatch):
  """(e) The pooled bags die with the step's graph, before the sparse
  update (they would hold their [rows, nbags, dim] through it); once
  train_step returns and its outputs are dropped, its pulled pack is
  gone, its gradient written by the pooling's backward alone."""
  trainer, batch = _dlrm()
  steps = _keep_pulled(trainer)
  made, alive_at_update = [], []
  pooled = emb_ops.StepPulls.pooled

  def keeping(self, key, batch):
    new = key not in self._pooled
    got = pooled(self, key, batch)
    if new:
      made.extend(weakref.ref(b) for b in got)
    return got

  update = pt.apply_packed_update

  def updating(*args, **kwargs):
    alive_at_update.append(sum(r() is not None for r in made))
    return update(*args, **kwargs)

  monkeypatch.setattr(emb_ops.StepPulls, 'pooled', keeping)
  monkeypatch.setattr(pt, 'apply_packed_update', updating)
  out = trainer.train_step(batch)
  assert len(made) == 26 and alive_at_update == [0]
  pack = steps.pop()['emb128']
  assert pack.grad is not None and bool(pack.grad.abs().sum() > 0)
  ref = weakref.ref(pack)
  del out, pack
  assert ref() is None
  assert made and all(r() is None for r in made)
  layer = trainer.ctx.input_layer
  assert not any(isinstance(v, (torch.Tensor, tuple, emb_ops.StepPulls))
                 for v in vars(layer).values())


def test_the_rule_reads_the_layout_alone(tmp_path):
  """Which tables pool: the DLRM's (26 sum bags), not the DeepFM's merged
  table. The rows' width and memory layout do not decide it: a pack of
  126 floats a row and a pack that is not contiguous pool too, to the
  bags of the same values contiguous (K7 takes scalar lanes where a row is
  not a whole number of float4, and refuses a pack that is not contiguous
  on the card)."""
  trainer, batch = _dlrm()
  packs = emb_ops.pack_all_views(trainer.layout, batch)
  pulled = trainer.pull(packs)
  strided = pulled['emb128'].transpose(0, 1).contiguous().transpose(0, 1)
  for rows in (pulled['emb128'], pulled['emb128'][..., :126].contiguous(),
               strided):
    steps = emb_ops.StepPulls({'emb128': rows}, trainer.layout)
    got = steps.pooled('emb128', batch)
    assert got is not None
    want = emb_ops.StepPulls({'emb128': rows.contiguous()},
                             trainer.layout).pooled('emb128', batch)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
  # a use's weights missing from the batch (a sampled view without the
  # feature) keeps the pack split
  part = {k: v for k, v in batch.items() if k != 'feat.C3.weights'}
  assert emb_ops.StepPulls(pulled, trainer.layout).pooled(
      'emb128', part) is None
  deepfm = _deepfm(tmp_path, 0.0)
  assert emb_ops.pool_layout(deepfm.layout, 'emb8') is None
