"""Streaming evaluation metrics.

Counterpart of easyrec_tpu/metrics/metrics.py for AUC: a histogram of
AUC_BINS score buckets per class accumulated on the device (:16-53) and a
rank-sum with tie correction on the host, under the part of
MetricsCollection (:273) that AUC needs.
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


class MetricsCollection:
  """Streaming metrics from EvalConfig.metrics_set (AUC only)."""

  def __init__(self, metrics_configs):
    self.configs = []
    for m in metrics_configs:
      which = m.WhichOneof('metric')
      if which != 'auc':
        raise NotImplementedError('eval metric %s is not ported' % which)
      self.configs.append(which)

  def init_states(self, device):
    return {'auc_hist': init_auc_state(device)} if self.configs else {}

  def update_states(self, states, labels, probs, weights):
    if 'auc_hist' in states:
      update_auc(states['auc_hist'], labels, probs, weights)
    return states

  def results(self, states) -> Dict[str, float]:
    return {'auc': auc_result(states['auc_hist'])} if self.configs else {}
