"""Streaming evaluation metrics.

Counterpart of easyrec_tpu/metrics/metrics.py for AUC and max-F1: a
histogram of AUC_BINS score buckets per class accumulated on the device
(:16-53), read on the host as a rank-sum with tie correction (AUC) or as
the best F1 over the bins' thresholds (max_f1_result, :53-66); the error
moments of mean_absolute_error, mean_squared_error and
root_mean_squared_error (update_error, :68-73); and recall@k and
precision@k of a match model's candidate columns (update_topk_recall,
:83-97), under the part of MetricsCollection (:273-390) that they need.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

AUC_BINS = 8192


def init_auc_state(device) -> Dict[str, torch.Tensor]:
  return {'pos': torch.zeros(AUC_BINS, dtype=torch.float32, device=device),
          'neg': torch.zeros(AUC_BINS, dtype=torch.float32, device=device)}


def update_auc(state, labels, probs, weights) -> Dict[str, torch.Tensor]:
  idx = torch.clamp((probs * AUC_BINS).to(torch.int64), 0, AUC_BINS - 1)
  w = weights.to(torch.float32)
  lbl = labels.to(torch.float32)
  state['pos'].index_add_(0, idx, w * lbl)
  state['neg'].index_add_(0, idx, w * (1.0 - lbl))
  return state


def auc_result(state) -> float:
  pos = state['pos'].detach().cpu().numpy().astype(np.float64)
  neg = state['neg'].detach().cpu().numpy().astype(np.float64)
  total_pos, total_neg = pos.sum(), neg.sum()
  if total_pos == 0 or total_neg == 0:
    return 0.5
  # rank-sum (Mann-Whitney U) over histogram bins with tie correction
  neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
  u = np.sum(pos * (neg_below + 0.5 * neg))
  return float(u / (total_pos * total_neg))


def max_f1_result(state) -> float:
  """The largest F1 over the thresholds at the bins' lower edges (a score
  in a bin at or above the threshold's predicts positive)."""
  pos = state['pos'].detach().cpu().numpy().astype(np.float64)
  neg = state['neg'].detach().cpu().numpy().astype(np.float64)
  total_pos = pos.sum()
  if total_pos == 0:
    return 0.0
  tp = np.cumsum(pos[::-1])[::-1]
  fp = np.cumsum(neg[::-1])[::-1]
  fn = total_pos - tp
  f1 = 2 * tp / np.maximum(2 * tp + fp + fn, 1e-9)
  return float(f1.max())


def init_moment_state(device) -> Dict[str, torch.Tensor]:
  """sum, sum_sq and count accumulators (the error and top-k states)."""
  return {k: torch.zeros((), dtype=torch.float32, device=device)
          for k in ('sum', 'sum_sq', 'count')}


def update_error(state, labels, preds, weights) -> Dict[str, torch.Tensor]:
  """Weighted |err| and err^2 sums and the weight's."""
  err = (preds - labels).to(torch.float32)
  w = weights.to(torch.float32)
  state['sum'] += torch.sum(torch.abs(err) * w)
  state['sum_sq'] += torch.sum(torch.square(err) * w)
  state['count'] += torch.sum(w)
  return state


def update_topk_recall(state, logits, k: int, labels, weights
                       ) -> Dict[str, torch.Tensor]:
  """Recall@k over candidate columns, column 0 the positive: a hit where
  fewer than k other columns score strictly above it; rows weighted by
  weight x label."""
  pos = logits[:, 0]
  rank = torch.sum((logits[:, 1:] > pos[:, None]).to(torch.float32), dim=1)
  hit = (rank < k).to(torch.float32)
  w = weights.to(torch.float32) * labels.to(torch.float32)
  state['sum'] += torch.sum(hit * w)
  state['count'] += torch.sum(w)
  return state


_HIST = ('auc', 'max_f1')
_ERRORS = ('mean_absolute_error', 'mean_squared_error',
           'root_mean_squared_error')
_TOPK = ('recall_at_topk', 'precision_at_topk')


class MetricsCollection:
  """Streaming metrics from EvalConfig.metrics_set: AUC and max-F1, both
  read from one histogram; the errors from one moment state; recall@k
  and precision@k from one state per k."""

  def __init__(self, metrics_configs):
    self.configs = []
    self.topk = {}
    for m in metrics_configs:
      which = m.WhichOneof('metric')
      if which not in _HIST + _ERRORS + _TOPK:
        raise NotImplementedError('eval metric %s is not ported' % which)
      self.configs.append(which)
      if which in _TOPK:
        self.topk[len(self.configs) - 1] = int(getattr(m, which).topk)

  def result_names(self) -> List[str]:
    """The names results() reports, in config order (`recall@5` for a
    recall_at_topk of topk 5)."""
    out = []
    for i, which in enumerate(self.configs):
      if which == 'recall_at_topk':
        out.append('recall@%d' % self.topk[i])
      elif which == 'precision_at_topk':
        out.append('precision@%d' % self.topk[i])
      else:
        out.append(which)
    return out

  def init_states(self, device):
    states = {}
    for i, which in enumerate(self.configs):
      if which in _HIST:
        states.setdefault('auc_hist', init_auc_state(device))
      elif which in _ERRORS:
        states.setdefault('error', init_moment_state(device))
      else:
        states.setdefault('topk_%d' % self.topk[i],
                          init_moment_state(device))
    return states

  def update_states(self, states, labels, probs, weights, preds=None,
                    extra: Optional[dict] = None):
    """`preds` feed the errors; `extra`'s `neg_sam_logits` (a match
    model's [positive | sampled negatives]) or else its `in_batch_logits`
    (the diagonal prepended) feed recall@k."""
    extra = extra or {}
    cand = extra.get('neg_sam_logits')
    if cand is None and 'in_batch_logits' in extra:
      ib = extra['in_batch_logits']
      cand = torch.cat([torch.diagonal(ib)[:, None], ib], dim=1)
    for key, state in states.items():
      if key.startswith('topk_') and cand is not None:
        update_topk_recall(state, cand, int(key.split('_')[1]), labels,
                           weights)
    if 'auc_hist' in states:
      update_auc(states['auc_hist'], labels, probs, weights)
    if 'error' in states:
      update_error(states['error'], labels, preds, weights)
    return states

  def results(self, states) -> Dict[str, float]:
    res = {}
    for i, which in enumerate(self.configs):
      if which == 'auc':
        res['auc'] = auc_result(states['auc_hist'])
      elif which == 'max_f1':
        res['max_f1'] = max_f1_result(states['auc_hist'])
      elif which in _ERRORS:
        s = {k: float(v) for k, v in states['error'].items()}
        count = max(s['count'], 1e-9)
        res[which] = {'mean_absolute_error': s['sum'] / count,
                      'mean_squared_error': s['sum_sq'] / count,
                      'root_mean_squared_error':
                      float(np.sqrt(s['sum_sq'] / count))}[which]
      else:
        k = self.topk[i]
        s = states['topk_%d' % k]
        hits, cnt = float(s['sum']), float(s['count'])
        if which == 'recall_at_topk':
          res['recall@%d' % k] = hits / max(cnt, 1e-9)
        else:
          # one relevant item a row: a hit counts 1/k
          res['precision@%d' % k] = hits / max(cnt * k, 1e-9)
    return res
