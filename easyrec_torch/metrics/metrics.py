"""Streaming evaluation metrics.

Counterpart of easyrec_tpu/metrics/metrics.py: AUC and max-F1 from a
histogram of AUC_BINS score buckets per class accumulated on the device
(:16-53), read on the host as a rank-sum with tie correction (AUC) or as
the best F1 over the bins' thresholds (max_f1_result, :53-66); the error
moments of mean_absolute_error, mean_squared_error and
root_mean_squared_error (update_error, :68-73); accuracy (update_accuracy,
:75), precision and recall at 0.5 (update_binary_counts, :98); recall@k
and precision@k of a match model's candidate columns (update_topk_recall,
:83-97); the grouped AUCs of gauc and session_auc on the host
(numpy_auc, grouped_auc, grouped_auc_from_hists and GroupedMetricBuffer,
:110-270, copied); and MetricsCollection (:273-397).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import logging
import os

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


def update_accuracy(state, labels, cls, weights) -> Dict[str, torch.Tensor]:
  """Weighted count of rows whose class `cls` equals the label."""
  w = weights.to(torch.float32)
  state['sum'] += torch.sum((cls == labels).to(torch.float32) * w)
  state['count'] += torch.sum(w)
  return state


def update_binary_counts(state, labels, probs, weights
                         ) -> Dict[str, torch.Tensor]:
  """Precision and recall at threshold 0.5: sum = true positives, sum_sq
  = false positives, count = positives (weighted)."""
  w = weights.to(torch.float32)
  pred_pos = (probs >= 0.5).to(torch.float32)
  lbl = labels.to(torch.float32)
  state['sum'] += torch.sum(pred_pos * lbl * w)
  state['sum_sq'] += torch.sum(pred_pos * (1 - lbl) * w)
  state['count'] += torch.sum(lbl * w)
  return state


# -- host-side grouped AUC (copied from the JAX package, numpy only) ---------


def numpy_auc(labels: np.ndarray, probs: np.ndarray) -> float:
  order = np.argsort(probs, kind='mergesort')
  sorted_labels = labels[order]
  sorted_probs = probs[order]
  n = len(labels)
  # average ranks with ties
  ranks = np.empty(n, np.float64)
  i = 0
  while i < n:
    j = i
    while j + 1 < n and sorted_probs[j + 1] == sorted_probs[i]:
      j += 1
    ranks[i:j + 1] = 0.5 * (i + j) + 1.0
    i = j + 1
  n_pos = sorted_labels.sum()
  n_neg = n - n_pos
  if n_pos == 0 or n_neg == 0:
    return float('nan')
  return float((ranks[sorted_labels > 0].sum() -
                n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def grouped_auc(uids: np.ndarray, labels: np.ndarray, probs: np.ndarray,
                reduction: str = 'mean') -> float:
  """Per-group AUC over the groups with both classes, reduced by mean,
  mean_by_sample_num or mean_by_positive_num; 0.5 where there is none."""
  order = np.argsort(uids, kind='mergesort')
  uids, labels, probs = uids[order], labels[order], probs[order]
  boundaries = np.nonzero(np.concatenate(
      [[True], uids[1:] != uids[:-1], [True]]))[0]
  aucs, wts = [], []
  for lo, hi in zip(boundaries[:-1], boundaries[1:]):
    lbl = labels[lo:hi]
    n_pos = lbl.sum()
    if n_pos == 0 or n_pos == len(lbl):
      continue
    aucs.append(numpy_auc(lbl, probs[lo:hi]))
    if reduction == 'mean_by_sample_num':
      wts.append(hi - lo)
    elif reduction == 'mean_by_positive_num':
      wts.append(n_pos)
    else:
      wts.append(1.0)
  if not aucs:
    return 0.5
  return float(np.average(aucs, weights=wts))


def grouped_auc_from_hists(pos: np.ndarray, neg: np.ndarray,
                           reduction: str = 'mean') -> float:
  """Per-group AUC from score histograms ([G, bins] positive and
  negative counts): a rank-sum over buckets with tie correction, within
  about 1/bins of exact."""
  n_pos = pos.sum(axis=1)
  n_neg = neg.sum(axis=1)
  ok = (n_pos > 0) & (n_neg > 0)
  if not ok.any():
    return 0.5
  pos, neg = pos[ok].astype(np.float64), neg[ok].astype(np.float64)
  n_pos, n_neg = n_pos[ok].astype(np.float64), n_neg[ok].astype(np.float64)
  cum_neg = np.cumsum(neg, axis=1) - neg          # negatives strictly below
  wins = (pos * (cum_neg + 0.5 * neg)).sum(axis=1)
  aucs = wins / (n_pos * n_neg)
  if reduction == 'mean_by_sample_num':
    wts = n_pos + n_neg
  elif reduction == 'mean_by_positive_num':
    wts = n_pos
  else:
    wts = np.ones_like(aucs)
  return float(np.average(aucs, weights=wts))


class GroupedMetricBuffer:
  """A bounded host buffer of one grouped metric's (group id, label,
  prob) rows: exact up to `max_rows` (EASYREC_EVAL_HOST_BUFFER_ROWS,
  default 20M), past it compacted into per-group score histograms of
  `bins` buckets that keep streaming (AUC within about 1/bins)."""

  def __init__(self, max_rows: int = None, bins: int = 128):
    self.max_rows = max_rows if max_rows is not None else int(
        os.environ.get('EASYREC_EVAL_HOST_BUFFER_ROWS', 20_000_000))
    self.bins = bins
    self.raw = {'uids': [], 'labels': [], 'probs': []}
    self.n = 0
    self._uid_index = None     # uid -> row in the hist arrays
    self._pos = None           # [G_alloc, bins] int64
    self._neg = None

  @property
  def histogram_mode(self) -> bool:
    return self._uid_index is not None

  def add(self, uids, labels, probs):
    uids = np.asarray(uids)
    labels = np.asarray(labels)
    probs = np.asarray(probs)
    if not self.histogram_mode:
      self.raw['uids'].append(uids)
      self.raw['labels'].append(labels)
      self.raw['probs'].append(probs)
      self.n += len(uids)
      if self.n > self.max_rows:
        self._compact()
      return
    self._hist_add(uids, labels, probs)

  def _compact(self):
    logging.warning(
        'grouped-metric host buffer exceeded %d rows: switching to '
        'bucketized per-group AUC (%d bins, ~%.1e absolute error); '
        'set EASYREC_EVAL_HOST_BUFFER_ROWS or eval_config.num_examples '
        'for exact values', self.max_rows, self.bins, 1.0 / self.bins)
    self._uid_index = {}
    self._pos = np.zeros((0, self.bins), np.int64)
    self._neg = np.zeros((0, self.bins), np.int64)
    raw = self.raw
    self.raw = {'uids': [], 'labels': [], 'probs': []}
    if raw['uids']:
      self._hist_add(np.concatenate(raw['uids']),
                     np.concatenate(raw['labels']),
                     np.concatenate(raw['probs']))

  def _hist_add(self, uids, labels, probs):
    uniq, codes = np.unique(uids, return_inverse=True)
    rows = np.empty(len(uniq), np.int64)
    grow = [u for u in uniq if u not in self._uid_index]
    if grow:
      base = len(self._uid_index)
      for i, u in enumerate(grow):
        self._uid_index[u] = base + i
      extra = np.zeros((len(grow), self.bins), np.int64)
      self._pos = np.concatenate([self._pos, extra])
      self._neg = np.concatenate([self._neg, extra.copy()])
    for i, u in enumerate(uniq):
      rows[i] = self._uid_index[u]
    b = np.clip((np.asarray(probs, np.float64) * self.bins).astype(
        np.int64), 0, self.bins - 1)
    r = rows[codes]
    lbl = np.asarray(labels) > 0
    np.add.at(self._pos, (r[lbl], b[lbl]), 1)
    np.add.at(self._neg, (r[~lbl], b[~lbl]), 1)

  def result(self, reduction: str = 'mean') -> float:
    if self.histogram_mode:
      return grouped_auc_from_hists(self._pos, self._neg, reduction)
    if not self.raw['uids']:
      return 0.5
    return grouped_auc(np.concatenate(self.raw['uids']),
                       np.concatenate(self.raw['labels']),
                       np.concatenate(self.raw['probs']), reduction)


_HIST = ('auc', 'max_f1')
_ERRORS = ('mean_absolute_error', 'mean_squared_error',
           'root_mean_squared_error')
_TOPK = ('recall_at_topk', 'precision_at_topk')
_BINARY = ('precision', 'recall')
_GROUPED = ('gauc', 'session_auc')


class MetricsCollection:
  """Streaming metrics from EvalConfig.metrics_set: AUC and max-F1, both
  read from one histogram; the errors from one moment state; accuracy
  from one, precision and recall from one; recall@k and precision@k from
  one state per k; gauc and session_auc from a GroupedMetricBuffer per
  grouping field on the host (`host_fields`, fed by the trainer's eval
  with the batch's field.<name> ids of the valid rows)."""

  def __init__(self, metrics_configs):
    self.configs = []
    self.topk = {}
    self.grouped = {}
    for m in metrics_configs:
      which = m.WhichOneof('metric')
      if which not in (_HIST + _ERRORS + _TOPK + _BINARY + _GROUPED +
                       ('accuracy',)):
        raise NotImplementedError('eval metric %s is not ported' % which)
      self.configs.append(which)
      i = len(self.configs) - 1
      if which in _TOPK:
        self.topk[i] = int(getattr(m, which).topk)
      elif which == 'gauc':
        self.grouped[i] = (m.gauc.uid_field, m.gauc.reduction or 'mean')
      elif which == 'session_auc':
        self.grouped[i] = (m.session_auc.session_id_field,
                           m.session_auc.reduction or 'mean')
    self.host_fields = sorted({f for f, _ in self.grouped.values()})

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
      elif which == 'accuracy':
        states.setdefault('accuracy', init_moment_state(device))
      elif which in _BINARY:
        states.setdefault('binary', init_moment_state(device))
      elif which in _TOPK:
        states.setdefault('topk_%d' % self.topk[i],
                          init_moment_state(device))
    return states

  def init_host_buffers(self) -> Dict[str, GroupedMetricBuffer]:
    return {f: GroupedMetricBuffer() for f in self.host_fields}

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
    if 'accuracy' in states:
      # integer preds are class ids (a multi-class argmax); float ones are
      # scores, a class at 0.5
      if preds is not None and not preds.is_floating_point():
        cls = preds.to(torch.float32)
      else:
        score = preds if preds is not None else probs
        cls = (score >= 0.5).to(torch.float32)
      update_accuracy(states['accuracy'], labels.to(torch.float32), cls,
                      weights)
    if 'binary' in states:
      update_binary_counts(states['binary'], labels, probs, weights)
    return states

  def results(self, states, host_buffers=None) -> Dict[str, float]:
    """The metrics by name; gauc and session_auc only where the
    `host_buffers` of init_host_buffers are given."""
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
      elif which == 'accuracy':
        s = {k: float(v) for k, v in states['accuracy'].items()}
        res['accuracy'] = s['sum'] / max(s['count'], 1e-9)
      elif which == 'precision':
        s = {k: float(v) for k, v in states['binary'].items()}
        res['precision'] = s['sum'] / max(s['sum'] + s['sum_sq'], 1e-9)
      elif which == 'recall':
        s = {k: float(v) for k, v in states['binary'].items()}
        res['recall'] = s['sum'] / max(s['count'], 1e-9)
      elif which in _GROUPED:
        if host_buffers is not None:
          field, reduction = self.grouped[i]
          res[which] = host_buffers[field].result(reduction)
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
