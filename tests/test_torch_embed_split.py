"""The input layer's one split a pulled pack a step (ops/embedding.py
StepPulls): Trainer.train_step cuts each pack once into its uses' pieces,
every categorical and id-sequence use reads its piece, and the backward of
the split writes the pack's gradient once. Held against the per-use slices
of the whole pack that a plain dict of pulled rows still takes: the leaf
gradients, the losses and the updated tables, the autograd graph around
each pack, the step's lifetime, the use counters and the span."""

import copy
import dataclasses
import json
import os
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from easyrec_torch.config import config_util
from easyrec_torch.ops import embedding as emb_ops
from easyrec_torch.train.trainer import Trainer, to_device
from easyrec_torch.utils.synthetic import synthetic_batch
from tests import fixtures


def _deepfm(tmp_path, emb_reg):
  body = fixtures.DEEPFM_BODY.replace(
      'embedding_regularization: 1e-6',
      'embedding_regularization: %r' % emb_reg)
  assert ('embedding_regularization: %r' % emb_reg) in body
  os.makedirs(str(tmp_path), exist_ok=True)
  cfg = config_util.get_configs_from_pipeline_file(
      fixtures.write_pipeline(tmp_path, model_body=body, n_train=64,
                              n_eval=64, batch_size=256))
  trainer = Trainer(cfg, device='cpu')
  trainer.init_state()
  return trainer


def _din():
  from tests.test_torch_din import CONFIG
  trainer = Trainer(config_util.get_configs_from_pipeline_str(
      CONFIG % {'bn': 'false'}), device='cpu')
  trainer.init_state()
  return trainer


def _dssm(tmp_path):
  from tests.test_torch_match import sample_configs
  t_cfg, _ = sample_configs('dssm_neg_sampler', str(tmp_path))
  trainer = Trainer(t_cfg, device='cpu')
  trainer.init_state()
  return trainer


def _batch(trainer, seed=3):
  bs = int(trainer.data_config.batch_size)
  return to_device(synthetic_batch(trainer.specs,
                                   list(trainer.ctx.label_fields), bs,
                                   seed=seed), trainer.device)


def _sampled_batch(trainer):
  """The first batch of the trainer's input, with its sampler's views."""
  batch = next(iter(trainer.train_input()))
  assert any(k.startswith('neg.feat.') for k in batch)
  return to_device(batch, trainer.device)


def _plain_forward(trainer):
  """The model called with a plain dict of the pulled rows: every use
  reads a slice of the whole pack, as before the split."""
  forward = trainer.model.forward
  trainer.model.forward = lambda batch, pulled: forward(batch, dict(pulled))


def _keep_pulled(trainer):
  """The pulled leaves of the trainer's steps, appended per step."""
  steps = []
  pull = trainer.pull

  def keeping(packs):
    out = pull(packs)
    steps.append(out)
    return out

  trainer.pull = keeping
  return steps


def _step(trainer, batch, plain=False, hook=None):
  """One train step: (outputs, {pack: leaf gradient}, tables after, the
  pulled leaves)."""
  steps = _keep_pulled(trainer)
  if plain:
    _plain_forward(trainer)
  if hook is not None:
    hook(trainer)
  out = trainer.train_step(batch)
  pulled = steps[-1]
  return (out, {k: v.grad for k, v in pulled.items()},
          {k: v.clone() for k, v in trainer.tables.items()}, pulled)


def _ulps(a, b):
  """Elementwise distance of two f32 tensors in units in the last place,
  along the ordered integers of their bit patterns."""
  def ordered(x):
    i = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7fffffff), i)
  return (ordered(a) - ordered(b)).abs()


def _ulp(x):
  """The f32 unit in the last place of |x|."""
  x = x.abs()
  return torch.nextafter(x, torch.full_like(x, float('inf'))) - x


def test_leaf_gradient_is_bit_equal_to_the_slices_without_the_regulariser(
    tmp_path):
  """(a) DeepFM with its wide weights merged into the deep table (16
  columns: 8 deep, 1 wide, 7 alignment lanes) and no embedding
  regulariser: at most two terms meet on an element (the FM's and the
  DNN's deep uses), so the split gives the slices' bits."""
  new, old = (_deepfm(tmp_path / d, 0.0) for d in ('new', 'old'))
  table = new.layout.tables['emb8']
  assert [u.col_dim for u in table.uses if u.feature.startswith('c')] == \
      [8, 8, 8]
  assert table.dim == 16 and table.used_dim == 9
  batch = _batch(new)
  o_new, g_new, t_new, _ = _step(new, batch)
  o_old, g_old, t_old, _ = _step(old, batch, plain=True)
  assert sorted(o_new) == sorted(o_old)
  for k in o_new:
    assert torch.equal(o_new[k], o_old[k]), k
  assert sorted(g_new) == ['emb8']
  assert torch.equal(g_new['emb8'], g_old['emb8'])
  assert g_new['emb8'].abs().sum() > 0
  for k in t_new:
    assert torch.equal(t_new[k], t_old[k]), k


def _term_sizes(trainer):
  """Hook for _step: records, per pack, the summed magnitudes of every
  use's gradient on each element (its column slice's), so that the
  regulariser's term can be added to give each element's sum of the
  magnitudes of its terms."""
  sizes = {}
  use_rows = trainer.ctx.input_layer.use_rows

  def recording(pulled, fname, role, prefix=''):
    rows = use_rows(pulled, fname, role, prefix)
    key, use = trainer.layout.feature_use[(fname, role)]
    pack = pulled[prefix + key]

    def add(grad):
      into = sizes.setdefault(prefix + key, torch.zeros_like(pack))
      cols = slice(use.col_start, use.col_start + use.col_dim) \
          if use.col_dim else slice(None)
      into[:, use.start:use.start + use.k, cols] += grad.abs()

    rows.register_hook(add)
    return rows

  trainer.ctx.input_layer.use_rows = recording
  return sizes


def test_leaf_gradient_with_the_regulariser_is_within_its_rounding(tmp_path):
  """(b) With the embedding regulariser three terms meet on a deep
  element: the regulariser's, the FM's and the DNN's. The slices added
  them to the leaf one by one; the split adds the two uses' in its piece
  first. Each order rounds twice, so the two differ by at most 2 ulp of
  the sum of the terms' magnitudes (where the terms cancel, that is many
  ulp of the gradient itself). The updated table rows are within 2 ulp
  of the slices'."""
  emb_reg = 1e-3
  new, old = (_deepfm(tmp_path / d, emb_reg) for d in ('new', 'old'))
  batch = _batch(new)
  kept = []
  o_new, g_new, t_new, pulled = _step(
      new, batch, hook=lambda t: kept.append(_term_sizes(t)))
  sizes = kept[0]['emb8']
  o_old, g_old, t_old, _ = _step(old, batch, plain=True)
  for k in o_new:
    assert torch.equal(o_new[k], o_old[k]), k
  a, b = g_new['emb8'], g_old['emb8']
  assert not torch.equal(a, b)              # the order did change
  p = pulled['emb8'].detach()
  valid = (batch['sample_weight'] > 0).to(torch.float32)[:, None, None]
  reg = (2 * emb_reg * valid * p).abs()     # the regulariser's term
  assert bool(((a - b).abs() <= 2 * _ulp(sizes + reg)).all())
  # where the uses' terms or the regulariser's are zero, nothing was
  # reassociated
  alone = (sizes == 0) | (reg == 0)
  assert torch.equal(a[alone], b[alone])
  for k in t_new:
    assert int(_ulps(t_new[k], t_old[k]).max()) <= 2, k


def _walk(fn):
  """Every node of an autograd graph from `fn`."""
  seen, todo = {}, [fn]
  while todo:
    node = todo.pop()
    if node is None or id(node) in seen:
      continue
    seen[id(node)] = node
    todo.extend(n for n, _ in node.next_functions)
  return list(seen.values())


def _graph_at_the_loss(trainer):
  """Hook for _step: keeps the step's loss graph, taken before backward."""
  nodes = []
  loss = trainer._regularised_loss

  def keeping(outputs, batch, pulled):
    total, loss_dict = loss(outputs, batch, pulled)
    nodes.extend(_walk(total.grad_fn))
    return total, loss_dict

  trainer._regularised_loss = keeping
  return nodes


@pytest.mark.parametrize('emb_reg', [0.0, 1e-5])
def test_one_split_node_a_pack_feeds_its_leaf(tmp_path, emb_reg):
  """(c) The pack's leaf is read by one split node, and, with the
  regulariser on, by the regulariser's square; no slice takes the whole
  pack as its input."""
  trainer = _deepfm(tmp_path, emb_reg)
  nodes = []
  _, _, _, pulled = _step(trainer, _batch(trainer),
                          hook=lambda t: nodes.append(_graph_at_the_loss(t)))
  nodes = nodes[0]
  leaf = pulled['emb8']
  acc = [n for n in nodes if type(n).__name__ == 'AccumulateGrad' and
         n.variable is leaf]
  assert len(acc) == 1
  feeding = [type(n).__name__ for n in nodes
             if any(m is acc[0] for m, _ in n.next_functions)]
  want = ['SplitWithSizesBackward0'] + (['MulBackward0'] if emb_reg else [])
  assert sorted(feeding) == sorted(want)
  split = [n for n in nodes if type(n).__name__ == 'SplitWithSizesBackward0']
  assert len(split) == 1
  # every slice reads a piece: its input is the split, never the leaf
  slices = [n for n in nodes if type(n).__name__ == 'SliceBackward0']
  assert slices
  for n in slices:
    assert all(m is not acc[0] for m, _ in n.next_functions)


def test_nothing_of_a_step_outlives_it(tmp_path):
  """(d) The pieces die with the step: once train_step returns and its
  outputs are dropped, its pulled pack is gone. Without the regulariser,
  the pack's gradient comes through its pieces alone."""
  trainer = _deepfm(tmp_path, 0.0)
  steps = _keep_pulled(trainer)
  out = trainer.train_step(_batch(trainer))
  pack = steps.pop()['emb8']
  assert pack.grad is not None and bool(pack.grad.abs().sum() > 0)
  ref = weakref.ref(pack)
  del out, pack
  assert ref() is None
  # and the input layer keeps no pieces of its own
  layer = trainer.ctx.input_layer
  assert not any(isinstance(v, (torch.Tensor, tuple, emb_ops.StepPulls))
                 for v in vars(layer).values())


def _counted_step(trainer, batch):
  emb_ops.reset_use_counts()
  trainer.train_step(batch)
  return emb_ops.use_counts()


@pytest.mark.parametrize('which', ['deepfm', 'din', 'dssm'])
def test_every_use_of_a_train_step_reads_its_piece(tmp_path, which):
  """(e) Every categorical and id-sequence use of a train step, the DSSM's
  sampled 'neg.' view's too, is served from a piece, with no fallback;
  the pieces are those of every pack the model read."""
  if which == 'deepfm':
    trainer = _deepfm(tmp_path, 1e-5)
    batch = _batch(trainer)
  elif which == 'din':
    trainer = _din()
    batch = _batch(trainer)
  else:
    trainer = _dssm(tmp_path)
    batch = _sampled_batch(trainer)
  made = []
  pieces = emb_ops.StepPulls.pieces

  def counting(self, key):
    if key not in self._pieces:
      made.append(key)
    return pieces(self, key)

  emb_ops.StepPulls.pieces = counting
  try:
    counts = _counted_step(trainer, batch)
  finally:
    emb_ops.StepPulls.pieces = pieces
  assert counts['slice'] == 0
  assert counts['piece'] > 0
  assert len(made) == len(set(made))         # one split a pack
  if which == 'dssm':
    assert any(k.startswith('neg.') for k in made)
  if which == 'din':
    # the id sequences' tables were split too
    seq = [f for f, spec in trainer.specs.items()
           if spec.kind == 'sequence' and not spec.seq_is_dense]
    assert seq
    assert {trainer.layout.feature_use[(f, 'deep')][0] for f in seq} <= \
        set(made)


@pytest.mark.parametrize('which', ['deepfm', 'din'])
def test_eval_through_a_plain_dict_takes_the_slices(tmp_path, which):
  """(e) Eval reads the pulled rows through a plain dict: every use falls
  back to a slice of the whole pack, and its outputs are those of the
  pieces exactly."""
  trainer = _deepfm(tmp_path, 1e-5) if which == 'deepfm' else _din()
  batch = _batch(trainer)
  emb_ops.reset_use_counts()
  with torch.no_grad():
    pulled = trainer.pull(emb_ops.pack_all_views(trainer.layout, batch))
    plain = trainer.eval_forward(batch, pulled)
    counts = emb_ops.use_counts()
    assert counts['piece'] == 0 and counts['slice'] > 0
    split = trainer.eval_forward(batch, emb_ops.StepPulls(pulled,
                                                          trainer.layout))
  assert emb_ops.use_counts() == {'piece': counts['slice'],
                                  'slice': counts['slice']}
  assert sorted(plain) == sorted(split)
  for k, v in plain.items():
    if isinstance(v, torch.Tensor):
      assert torch.equal(v, split[k]), k
  emb_ops.reset_use_counts()
  trainer.eval_step(batch, trainer.metrics.init_states(trainer.device))
  assert emb_ops.use_counts() == {'piece': 0, 'slice': counts['slice']}


def test_a_use_that_is_not_one_piece_falls_back_to_its_slice(tmp_path):
  """A layout whose pieces do not match a use (here d1 and d2 in one
  piece of two slots) reads that use by a slice of the whole pack and
  the others from their pieces: the outputs and the pack's gradient are
  the slices' bits."""
  trainer = _deepfm(tmp_path, 0.0)
  layout = copy.deepcopy(trainer.layout)
  uses = layout.tables['emb8'].uses
  assert [(u.feature, u.start, u.k) for u in uses[:2]] == \
      [('d1', 0, 1), ('d2', 1, 1)]
  layout.tables['emb8'].uses = [dataclasses.replace(uses[0], k=2)] + uses[2:]
  layer = emb_ops.InputLayer(layout, trainer.specs)
  assert ('d1', 'deep') not in layer.piece_of
  assert layer.piece_of[('c1', 'wide')] == layer.piece_of[('c1', 'deep')]
  batch = _batch(trainer)
  packs = emb_ops.pack_all_views(trainer.layout, batch)
  names = ['d1', 'd2', 'c1', 'c2', 'c3']
  got = {}
  for how in ('plain', 'split'):
    pulled = {k: v.detach().clone().requires_grad_()
              for k, v in trainer.pull(packs).items()}
    rows = pulled if how == 'plain' else emb_ops.StepPulls(pulled, layout)
    emb_ops.reset_use_counts()
    deep = layer.group_concat(rows, batch, names)
    wide = layer.wide_logits(rows, batch, ['c1', 'c2', 'c3'])
    stack = layer.group_stack(rows, batch, ['c1', 'c2', 'c3'])
    (deep.pow(2).sum() + wide.sum() + stack.sum()).backward()
    got[how] = (deep, wide, stack, pulled['emb8'].grad,
                emb_ops.use_counts())
  for a, b in zip(got['plain'][:4], got['split'][:4]):
    assert torch.equal(a, b)
  assert got['plain'][4] == {'piece': 0, 'slice': 11}
  assert got['split'][4] == {'piece': 9, 'slice': 2}


def _split_spans(events):
  return [(float(e['ts']), float(e['ts']) + float(e['dur']), e['name'])
          for e in events if e.get('ph') == 'X' and
          e.get('cat') == 'user_annotation' and
          e['name'] in ('easyrec.embed', 'easyrec.embed.split',
                        'easyrec.step')]


@pytest.mark.parametrize('which', ['deepfm', 'dssm'])
def test_the_split_span_shows_once_a_pack_a_step(tmp_path, which):
  """(f) Under a CPU profiler, easyrec.embed.split appears once a pack
  the model read a step, each inside an easyrec.embed of that step."""
  if which == 'deepfm':
    trainer = _deepfm(tmp_path, 1e-5)
    batch = _batch(trainer)
  else:
    trainer = _dssm(tmp_path)
    batch = _sampled_batch(trainer)
  trainer.train_step(batch)                  # the first step, untraced
  steps = _keep_pulled(trainer)
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    trainer.train_step(batch)
    trainer.train_step(batch)
  read = [k for k, v in steps[0].items() if v.grad is not None]
  path = os.path.join(str(tmp_path), 'trace.json')
  prof.export_chrome_trace(path)
  with open(path) as f:
    got = _split_spans(json.load(f)['traceEvents'])
  by = {n: [s for s in got if s[2] == n] for n in
        ('easyrec.embed', 'easyrec.embed.split', 'easyrec.step')}
  assert len(by['easyrec.step']) == 2
  assert len(by['easyrec.embed.split']) == 2 * len(read)
  for lo, hi, _ in by['easyrec.step']:
    assert sum(lo <= s[0] and s[1] <= hi
               for s in by['easyrec.embed.split']) == len(read)
  for s in by['easyrec.embed.split']:
    assert any(lo <= s[0] and s[1] <= hi
               for lo, hi, _ in by['easyrec.embed']), s
  if which == 'dssm':
    assert any(k.startswith('neg.') for k in read)


def test_the_use_counters_count_from_their_reset(tmp_path):
  trainer = _deepfm(tmp_path, 0.0)
  batch = _batch(trainer)
  first = _counted_step(trainer, batch)
  # DeepFM: the wide use of c1-c3, and the FM's and the DNN's deep use of
  # c1-c3 and of the embedded d1 and d2
  assert first == {'piece': 3 + 5 + 5, 'slice': 0}
  trainer.train_step(batch)
  assert emb_ops.use_counts() == {'piece': 26, 'slice': 0}
  emb_ops.reset_use_counts()
  assert emb_ops.use_counts() == {'piece': 0, 'slice': 0}
