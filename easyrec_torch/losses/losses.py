"""Losses. Counterpart of easyrec_tpu/losses/losses.py for the losses the
port runs: the rank models' sigmoid_cross_entropy (:24) and the task
towers' softmax_cross_entropy (:34), l2_loss (:42), sigmoid_l2_loss (:47),
binary_focal_loss (:51) with _ohem_mean (:84) and f1_reweighted_loss
(:72), and loss_by_type, which picks one of them by a config's LossType;
and the match family's _log1p_sum_exp (:315), circle_loss (:325),
multi_similarity_loss (:345) and softmax_loss_with_negative_mining
(:361). Per-sample weights (0 marks padded rows) reduce to a weighted
mean."""

from __future__ import annotations

import math
from typing import Optional

import torch


def weighted_mean(values: torch.Tensor, weights: torch.Tensor):
  weights = weights.to(values.dtype)
  return (values * weights).sum() / torch.clamp(weights.sum(), min=1e-9)


def _smooth(labels: torch.Tensor, label_smoothing: float) -> torch.Tensor:
  if label_smoothing > 0:
    return labels * (1 - label_smoothing) + 0.5 * label_smoothing
  return labels


def _sigmoid_ce(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
  return torch.clamp(logits, min=0) - logits * labels + \
      torch.log1p(torch.exp(-torch.abs(logits)))


def sigmoid_cross_entropy(labels: torch.Tensor, logits: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
  return weighted_mean(_sigmoid_ce(labels.to(logits.dtype), logits), weights)


def softmax_cross_entropy(labels: torch.Tensor, logits: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
  """labels: class ids [B] (a float label is truncated); logits [B, C]."""
  logp = torch.log_softmax(logits, dim=-1)
  per = -torch.gather(logp, -1, labels.to(torch.int64)[:, None])[:, 0]
  return weighted_mean(per, weights)


def l2_loss(labels: torch.Tensor, preds: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
  per = 0.5 * torch.square(preds - labels.to(preds.dtype))
  return weighted_mean(per, weights)


def sigmoid_l2_loss(labels: torch.Tensor, logits: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
  return l2_loss(labels, torch.sigmoid(logits), weights)


def binary_focal_loss(labels: torch.Tensor, logits: torch.Tensor,
                      weights: torch.Tensor, gamma: float = 2.0,
                      alpha: Optional[float] = None,
                      label_smoothing: float = 0.0,
                      ohem_ratio: float = 1.0) -> torch.Tensor:
  labels = _smooth(labels.to(logits.dtype), label_smoothing)
  p = torch.sigmoid(logits)
  ce = _sigmoid_ce(labels, logits)
  p_t = p * labels + (1 - p) * (1 - labels)
  mod = torch.pow(1.0 - p_t, gamma)
  if alpha is not None:
    mod = mod * (alpha * labels + (1 - alpha) * (1 - labels))
  if ohem_ratio < 1.0:
    return _ohem_mean(mod * ce, weights.to(logits.dtype).expand_as(logits),
                      ohem_ratio)
  return weighted_mean(mod * ce, weights)


def f1_reweighted_loss(labels: torch.Tensor, logits: torch.Tensor,
                       weights: torch.Tensor, f1_beta_square: float = 1.0,
                       label_smoothing: float = 0.0) -> torch.Tensor:
  labels = _smooth(labels.to(logits.dtype), label_smoothing)
  p = torch.sigmoid(logits)
  per = -(f1_beta_square * labels * torch.log(p + 1e-9) +
          (1 - labels) * torch.log(1 - p + 1e-9) * (1 - p))
  return weighted_mean(per, weights)


def loss_by_type(loss_type: str, params, labels: torch.Tensor,
                 logits: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
  """A binary task's loss term by its LossType name and loss_param message
  (None for the defaults), as the JAX package's RankModel._single_loss
  (models/base.py:214-248) and MultiTaskModel._tower_loss compute these
  types: L2 on the logits, binary focal, F1-reweighted, else the sigmoid
  cross entropy."""
  if loss_type == 'L2_LOSS':
    return l2_loss(labels, logits, weights)
  if loss_type == 'BINARY_FOCAL_LOSS':
    kw = {}
    if params is not None:
      kw = dict(gamma=params.gamma,
                alpha=params.alpha if params.HasField('alpha') else None,
                label_smoothing=params.label_smoothing,
                ohem_ratio=params.ohem_ratio)
    return binary_focal_loss(labels, logits, weights, **kw)
  if loss_type == 'F1_REWEIGHTED_LOSS':
    kw = {}
    if params is not None:
      kw = dict(f1_beta_square=params.f1_beta_square,
                label_smoothing=params.label_smoothing)
    return f1_reweighted_loss(labels, logits, weights, **kw)
  return sigmoid_cross_entropy(labels, logits, weights)


def _ohem_mean(per: torch.Tensor, weights: torch.Tensor,
               ohem_ratio: float) -> torch.Tensor:
  """Online hard example mining: the mean of the largest ceil(ratio *
  n_valid) weighted losses among the valid ones (weight > 0, loss > 0),
  by a stable sort of the whole array as the JAX package's static-shape
  form does."""
  flat = (per * weights).reshape(-1)
  valid = ((weights > 0) & (per > 0)).reshape(-1).to(flat.dtype)
  order = torch.sort(-flat, stable=True).indices
  sorted_loss, sorted_valid = flat[order], valid[order]
  n_keep = torch.ceil(valid.sum() * ohem_ratio)
  keep = sorted_valid * (torch.cumsum(sorted_valid, 0) <= n_keep)
  return (sorted_loss * keep).sum() / torch.clamp(keep.sum(), min=1.0)


def _log1p_sum_exp(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
  """log(1 + sum_i mask_i exp(logits_i)) per row, shifted by the row's
  largest live logit (or 0) against overflow: gamma * ap reaches +126 at
  gamma 32."""
  live = mask > 0
  masked = torch.where(live, logits, torch.full_like(logits, -math.inf))
  m = torch.clamp(masked.amax(dim=1), min=0.0)
  s = torch.exp(-m) + torch.where(live, torch.exp(masked - m[:, None]),
                                  torch.zeros_like(logits)).sum(dim=1)
  return m + torch.log(s)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
  return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                         min=1e-9)


def _pair_masks(labels: torch.Tensor, dtype):
  """(same group off the diagonal, other group) as [B, B] floats."""
  same = labels[:, None] == labels[None, :]
  eye = torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
  return (same & ~eye).to(dtype), (~same).to(dtype)


def circle_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor, margin: float = 0.25,
                gamma: float = 32.0) -> torch.Tensor:
  """Circle loss over L2-normalised embeddings; labels are group ids."""
  emb = _unit_rows(embeddings)
  sim = emb @ emb.T
  pos_mask, neg_mask = _pair_masks(labels, sim.dtype)
  ap = torch.clamp(1 + margin - sim, min=0.0)
  an = torch.clamp(sim + margin, min=0.0)
  logit_p = -gamma * ap * (sim - (1 - margin))
  logit_n = gamma * an * (sim - margin)
  return weighted_mean(_log1p_sum_exp(logit_p, pos_mask) +
                       _log1p_sum_exp(logit_n, neg_mask), weights)


def multi_similarity_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor, alpha: float = 2.0,
                          beta: float = 50.0, lamb: float = 1.0,
                          eps: float = 0.1) -> torch.Tensor:
  """The multi-similarity loss (eps is read by neither package)."""
  emb = _unit_rows(embeddings)
  sim = emb @ emb.T
  pos_mask, neg_mask = _pair_masks(labels, sim.dtype)
  pos_term = _log1p_sum_exp(-alpha * (sim - lamb), pos_mask) / alpha
  neg_term = _log1p_sum_exp(beta * (sim - lamb), neg_mask) / beta
  return weighted_mean(pos_term + neg_term, weights)


def softmax_loss_with_negative_mining(user_emb: torch.Tensor,
                                      item_emb: torch.Tensor,
                                      labels: torch.Tensor,
                                      weights: torch.Tensor,
                                      num_negative_samples: int = 4,
                                      margin: float = 0.0,
                                      gamma: float = 1.0,
                                      coef: float = 1.0) -> torch.Tensor:
  """Support-vector softmax over in-batch negatives: row i's k-th
  negative is the item of row i - k - 1 (a roll, no draw); the positive
  column is shifted by -margin, every column scaled by gamma."""
  u, v = _unit_rows(user_emb), _unit_rows(item_emb)
  pos = torch.sum(u * v, dim=1, keepdim=True)
  negs = [torch.sum(u * torch.roll(v, k + 1, dims=0), dim=1, keepdim=True)
          for k in range(num_negative_samples)]
  logits = torch.cat([pos - margin] + negs, dim=1) * gamma
  lbl = labels.to(logits.dtype)
  per = -torch.log_softmax(logits, dim=-1)[:, 0] * lbl
  w = weights.to(logits.dtype) * lbl
  return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1e-9) * coef
