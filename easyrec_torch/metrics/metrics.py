"""Streaming evaluation metrics.

Counterpart of easyrec_tpu/metrics/metrics.py for AUC and max-F1: a
histogram of AUC_BINS score buckets per class accumulated on the device
(:16-53), read on the host as a rank-sum with tie correction (AUC) or as
the best F1 over the bins' thresholds (max_f1_result, :53-66), under the
part of MetricsCollection (:273-352) that they need.
"""

from __future__ import annotations

from typing import Dict

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


_RESULTS = {'auc': auc_result, 'max_f1': max_f1_result}


class MetricsCollection:
  """Streaming metrics from EvalConfig.metrics_set (AUC and max-F1, both
  read from one histogram)."""

  def __init__(self, metrics_configs):
    self.configs = []
    for m in metrics_configs:
      which = m.WhichOneof('metric')
      if which not in _RESULTS:
        raise NotImplementedError('eval metric %s is not ported' % which)
      self.configs.append(which)

  def init_states(self, device):
    return {'auc_hist': init_auc_state(device)} if self.configs else {}

  def update_states(self, states, labels, probs, weights):
    if 'auc_hist' in states:
      update_auc(states['auc_hist'], labels, probs, weights)
    return states

  def results(self, states) -> Dict[str, float]:
    return {which: _RESULTS[which](states['auc_hist'])
            for which in self.configs}
