"""The JAX package's sequence and MIND learnability gates, run on the port.

From `tests/test_learnability.py`, at its sizes, seeds, steps, learning
rates and bars: MultiTowerDIN and MultiTowerBST on the `lseq` label,
Bern(0.85 if cate in seq_cate else 0.15), learnable only by attending over
the history (BST at the reference's lr 0.001 for 600 steps); the BST's
pre-LN layout at lr 0.02 for 400 steps; MIND's in-batch recall@5 against
its simulated Bayes ceiling; and MIND's interest differentiation, on the
port's eval forward: the label-guided pick of an interest capsule beats
mean pooling, and the active capsules have not collapsed into one
direction. Data and configs: `tests/test_torch_learnability_data.py`; the
Trainer on the CPU, one torch thread.
"""

import numpy as np
import pytest
import torch

from easyrec_torch.ops import embedding as emb_ops
from tests import test_torch_learnability_data as d

BAR = d.BAYES['lseq'] - d.MARGIN['seq']


one_thread = pytest.fixture(autouse=True, scope='module')(d.one_thread)


@pytest.mark.parametrize('name', sorted(d.SEQ_BODIES),
                         ids=sorted(d.SEQ_BODIES))
def test_sequence_attention_learned(name, tmp_path):
  # BST (post-LN, the reference's layout) at the reference's own lr 0.001
  lr = 0.001 if name == 'MultiTowerBST' else None
  m = d.run_gate(d.gate_config(tmp_path, d.SEQ_BODIES[name], ['lseq'],
                               num_steps=600 if lr else 250, lr=lr))[0]
  assert m['auc'] > BAR, \
      '%s sequence gate: auc=%.4f < bayes %.4f - %.2f' % (
          name, m['auc'], d.BAYES['lseq'], d.MARGIN['seq'])


def test_bst_pre_ln_high_lr(tmp_path):
  """bst_towers { pre_ln: true }: the pre-norm layout clears the sequence
  bar at the shared lr 0.02."""
  body = d.SEQ_BODIES['MultiTowerBST'].replace(
      'bst_towers {', 'bst_towers {\n      pre_ln: true')
  assert 'pre_ln' in body
  m = d.run_gate(d.gate_config(tmp_path, body, ['lseq'], num_steps=400))[0]
  assert m['auc'] > BAR, \
      'BST pre_ln lr-0.02 gate: auc=%.4f < %.4f' % (m['auc'], BAR)


@pytest.fixture(scope='module')
def mind_run(tmp_path_factory):
  """One MIND training (the JAX gates' _mind_train: 300 steps), read by
  both MIND gates."""
  path, evalp = d.mind_config(tmp_path_factory.mktemp('mind'))
  m, trainer, _, _ = d.run_gate(path)
  return m, trainer, evalp


def test_mind_recall_learned(mind_run):
  """MIND's recall@5 within 0.035 of the Bayes ceiling (~0.13; random
  floor ~0.05): broken capsule routing or label-guided attention falls to
  the floor."""
  m, _, evalp = mind_run
  bayes = d._mind_bayes_recall5(evalp)
  gate = d.mind_gate(evalp)
  assert m['recall@5'] > gate, \
      'MIND recall gate: %.4f <= %.4f (bayes %.4f): %s' % (
          m['recall@5'], gate, bayes, m)


def _norm(x):
  return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def mind_interest_readings(trainer):
  """In-batch recall@5 of the label-guided capsule pick and of mean
  pooling, and the mean cosine of active capsule pairs, over the eval set
  on the port's eval forward (the JAX gate's computation)."""
  att_hits, mean_hits, tot = 0, 0, 0
  sims = []
  with torch.no_grad():
    for batch in trainer.eval_input():
      iid_col = np.asarray(batch['feat.iid.ids'])[:, 0]
      dev = trainer.device_batch(batch)
      pulled = trainer.pull(emb_ops.pack_all_views(trainer.layout, dev))
      outputs = trainer.eval_forward(dev, pulled)
      ui = outputs['user_interests'].float().cpu().numpy()      # [B, K, D]
      kmask = outputs['interests_mask'].float().cpu().numpy()   # [B, K]
      ie = _norm(outputs['item_tower_emb'].float().cpu().numpy())
      un = _norm(ui)
      # label-guided pick (hard; simi_pow 10 is near an argmax)
      simi = np.einsum('bkd,bd->bk', un, ie)
      simi = np.where(kmask > 0, simi, -1e9)
      att_emb = ui[np.arange(ui.shape[0]), simi.argmax(axis=1)]
      mean_emb = (ui * kmask[:, :, None]).sum(axis=1) / \
          np.maximum(kmask.sum(axis=1), 1)[:, None]
      for emb, acc in ((att_emb, 'att'), (mean_emb, 'mean')):
        logits = _norm(emb) @ ie.T
        b = logits.shape[0]
        same = iid_col[None, :] == iid_col[:, None]
        logits = np.where(same & ~np.eye(b, dtype=bool), -1e9, logits)
        pos = np.diagonal(logits)
        hits = ((logits > pos[:, None]).sum(axis=1) < 5).sum()
        if acc == 'att':
          att_hits += hits
        else:
          mean_hits += hits
      tot += ui.shape[0]
      # mean off-diagonal cosine of the active capsule pairs
      pair = (kmask[:, :, None] * kmask[:, None, :]) * \
          (1 - np.eye(ui.shape[1]))[None]
      cs = np.einsum('bkd,bjd->bkj', un, un)
      if pair.sum() > 0:
        sims.append((cs * pair).sum() / pair.sum())
  return att_hits / tot, mean_hits / tot, float(np.mean(sims))


def test_mind_interest_differentiation(mind_run):
  """The multi-interest property itself: the label-guided attention pick
  beats mean pooling of the capsules by 0.015 of recall@5, and active
  capsules keep a mean cosine under 0.95."""
  att_r, mean_r, sim = mind_interest_readings(mind_run[1])
  assert att_r > mean_r + 0.015, \
      'label-guided attention (%.4f) must beat mean-pooling (%.4f)' % (
          att_r, mean_r)
  assert sim < 0.95, \
      'interest capsules collapsed: mean active cosine %.4f' % sim
