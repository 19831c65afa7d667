"""Losses. Counterpart of easyrec_tpu/losses/losses.py for the losses the
port runs: the rank models' sigmoid_cross_entropy (:24) and the task
towers' softmax_cross_entropy (:34), l2_loss (:42), sigmoid_l2_loss (:47),
binary_focal_loss (:51) with _ohem_mean (:84) and f1_reweighted_loss
(:72), and loss_by_type, which picks one of them by a config's LossType;
the ranking losses: _pairwise_diffs (:101) and the four pairwise losses
(:117-199) with session ids, jrc_loss (:202), ziln_loss (:243),
listwise_rank_loss (:289) and listwise_distill_loss (:312); and the match
family's _log1p_sum_exp (:315), circle_loss (:325), multi_similarity_loss
(:345) and softmax_loss_with_negative_mining (:361). Per-sample weights
(0 marks padded rows) reduce to a weighted mean."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


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


def _pairwise_diffs(scores, labels, weights, session_ids=None):
  """[B, B] score differences (row minus column) and the pair weights:
  pairs whose row label is the larger, of one session where sessions are
  given, weighted by the row's weight where the column's is positive."""
  diff = scores[:, None] - scores[None, :]
  label_diff = labels[:, None] - labels[None, :]
  pair_mask = (label_diff > 0).to(scores.dtype)
  if session_ids is not None:
    same = session_ids[:, None] == session_ids[None, :]
    pair_mask = pair_mask * same.to(scores.dtype)
  w = weights.to(scores.dtype)
  pair_w = pair_mask * w[:, None] * (w[None, :] > 0)
  return diff, pair_w


def _pair_mean(per, pair_w, ohem_ratio: float):
  if ohem_ratio < 1.0:
    return _ohem_mean(per, pair_w, ohem_ratio)
  return torch.sum(per * pair_w) / torch.clamp(torch.sum(pair_w), min=1e-9)


def pairwise_loss(labels, logits, weights, margin: float = 0.0,
                  session_ids=None, temperature: float = 1.0,
                  ohem_ratio: float = 1.0):
  diff, pair_w = _pairwise_diffs(logits / temperature, labels, weights,
                                 session_ids)
  return _pair_mean(torch.log1p(torch.exp(-(diff - margin))), pair_w,
                    ohem_ratio)


def pairwise_logistic_loss(labels, logits, weights,
                           temperature: float = 1.0, hinge_margin=None,
                           session_ids=None, ohem_ratio: float = 1.0):
  diff, pair_w = _pairwise_diffs(logits / temperature, labels, weights,
                                 session_ids)
  if hinge_margin is not None:
    pair_w = pair_w * (diff < hinge_margin).to(diff.dtype)
  return _pair_mean(torch.log1p(torch.exp(-diff)), pair_w, ohem_ratio)


def pairwise_focal_loss(labels, logits, weights, gamma: float = 2.0,
                        alpha=None, hinge_margin: float = 1.0,
                        temperature: float = 1.0, session_ids=None,
                        ohem_ratio: float = 1.0):
  diff, pair_w = _pairwise_diffs(logits / temperature, labels, weights,
                                 session_ids)
  pair_w = pair_w * (diff < hinge_margin).to(diff.dtype)
  p = torch.sigmoid(diff)
  per = -torch.pow(1 - p, gamma) * torch.log(p + 1e-9)
  if alpha is not None:
    per = per * alpha
  return _pair_mean(per, pair_w, ohem_ratio)


def pairwise_hinge_loss(labels, logits, weights, margin: float = 1.0,
                        temperature: float = 1.0, session_ids=None,
                        label_is_logits: bool = True,
                        use_label_margin: bool = True,
                        use_exponent: bool = False,
                        ohem_ratio: float = 1.0):
  """The margin is the label difference by default (use_label_margin);
  labels scale with the temperature when they are logits; use_exponent
  takes relu(exp(hinge) - 1)."""
  labels = labels.to(logits.dtype)
  scores = logits / temperature
  lbl = labels / temperature if label_is_logits else labels
  if use_exponent:
    lbl, scores = torch.sigmoid(lbl), torch.sigmoid(scores)
  diff, pair_w = _pairwise_diffs(scores, lbl, weights, session_ids)
  if use_label_margin:
    hinge_in = (lbl[:, None] - lbl[None, :]) - diff
  else:
    hinge_in = margin - diff
  if use_exponent:
    per = torch.relu(torch.exp(torch.clamp(hinge_in, -88.0, 88.0)) - 1.0)
  else:
    per = torch.relu(hinge_in)
  return _pair_mean(per, pair_w, ohem_ratio)


PAIRWISE_LOSSES = {
    'PAIR_WISE_LOSS': pairwise_loss,
    'PAIRWISE_LOGISTIC_LOSS': pairwise_logistic_loss,
    'PAIRWISE_FOCAL_LOSS': pairwise_focal_loss,
    'PAIRWISE_HINGE_LOSS': pairwise_hinge_loss,
}


def pairwise_kwargs(loss_type: str, params) -> dict:
  """The keyword arguments a pairwise loss takes from its loss_param
  message (JAX RankModel._single_loss, base.py:248-286); none for the
  defaults."""
  if params is None:
    return {}
  if loss_type == 'PAIR_WISE_LOSS':
    return dict(margin=params.margin, temperature=params.temperature)
  if loss_type == 'PAIRWISE_LOGISTIC_LOSS':
    return dict(temperature=params.temperature,
                hinge_margin=params.hinge_margin
                if params.HasField('hinge_margin') else None,
                ohem_ratio=params.ohem_ratio)
  if loss_type == 'PAIRWISE_FOCAL_LOSS':
    return dict(gamma=params.gamma,
                alpha=params.alpha if params.HasField('alpha') else None,
                hinge_margin=params.hinge_margin,
                temperature=params.temperature, ohem_ratio=params.ohem_ratio)
  return dict(temperature=params.temperature, margin=params.margin,
              label_is_logits=params.label_is_logits,
              use_label_margin=params.use_label_margin,
              use_exponent=params.use_exponent, ohem_ratio=params.ohem_ratio)


def jrc_loss(labels, logits2, session_ids, weights, alpha: float = 0.5,
             same_label_loss: bool = True):
  """Joint ranking and calibration over logits2 [B, 2]: alpha x the
  softmax cross entropy plus (1 - alpha) x each row's class logit in a
  softmax over its session's rows (same-label competitors left out
  without same_label_loss)."""
  labels = labels.to(torch.int64)
  ce = softmax_cross_entropy(labels, logits2, weights)
  mask = (session_ids[:, None] == session_ids[None, :]).to(logits2.dtype)
  if not same_label_loss:
    eye = torch.eye(logits2.shape[0], dtype=torch.bool,
                    device=logits2.device)
    same_lbl = (labels[:, None] == labels[None, :]) & ~eye
    mask = mask * (1.0 - same_lbl.to(logits2.dtype))

  def session_ce(vec, target):
    scores = torch.where(mask > 0, vec[None, :],
                         torch.full_like(mask, -1e9))
    return -(torch.diagonal(torch.log_softmax(scores, dim=1)) * target)

  w = weights.to(logits2.dtype)
  pos_t = (labels == 1).to(logits2.dtype) * w
  neg_t = (labels == 0).to(logits2.dtype) * w
  ge_loss = (torch.sum(session_ce(logits2[:, 1], pos_t)) +
             torch.sum(session_ce(logits2[:, 0], neg_t))) / \
      torch.clamp(torch.sum(w), min=1e-9)
  return alpha * ce + (1 - alpha) * ge_loss


def ziln_loss(labels, logits3, weights, max_sigma: float = 5.0,
              max_log_clip_value: float = 20.0,
              classification_weight: float = 1.0,
              regression_weight: float = 1.0,
              mu_regularization: float = 0.0,
              sigma_regularization: float = 0.0):
  """Zero-inflated lognormal over logits3 [B, 3] = (class logit, mu,
  sigma): the positive's cross entropy and, on positive labels, the
  lognormal's negative log-likelihood, with mu and sigma regularisers."""
  labels = labels.to(logits3.dtype)
  positive = (labels > 0).to(logits3.dtype)
  class_loss = _sigmoid_ce(positive, logits3[..., 0])
  mu = logits3[..., 1]
  sigma = torch.clamp(torch.clamp(F.softplus(logits3[..., 2]),
                                  max=max_sigma), min=1e-6)
  safe = positive * labels + (1 - positive)
  log_l = torch.clamp(torch.log(safe), -max_log_clip_value,
                      max_log_clip_value)
  reg_loss = -positive * (-0.5 * torch.square((log_l - mu) / sigma) -
                          torch.log(sigma * safe * 2.5066282746))
  total = weighted_mean(classification_weight * class_loss +
                        regression_weight * reg_loss, weights)
  if mu_regularization:
    total = total + mu_regularization * torch.mean(torch.square(mu))
  if sigma_regularization:
    total = total + sigma_regularization * torch.mean(torch.square(sigma))
  return total


# the transform_fn names the JAX package maps onto numpy (utils/registry.py
# load_by_path), here onto the torch functions of the same math
_TRANSFORMS = {
    'tf.math.log1p': torch.log1p, 'log1p': torch.log1p,
    'numpy.log1p': torch.log1p, 'tf.math.log': torch.log,
    'numpy.log': torch.log, 'tf.math.exp': torch.exp,
    'numpy.exp': torch.exp, 'tf.math.sigmoid': torch.sigmoid,
    'scipy.special.expit': torch.sigmoid, 'tf.math.abs': torch.abs,
    'numpy.abs': torch.abs, 'tf.math.sqrt': torch.sqrt,
    'numpy.sqrt': torch.sqrt,
}


def _transform(path: str):
  if path in _TRANSFORMS:
    return _TRANSFORMS[path]
  from easyrec_torch.utils.registry import load_by_path
  return load_by_path(path)


def listwise_rank_loss(labels, logits, session_ids, weights,
                       temperature: float = 1.0,
                       label_is_logits: bool = False,
                       transform_fn: str = ''):
  """Each row's cross entropy between its session's label distribution
  (the labels normalised, or their softmax when they are logits) and the
  softmax of the session's scores over the temperature."""
  if transform_fn:
    labels = _transform(transform_fn)(labels)
  labels = labels.to(logits.dtype)
  same = session_ids[:, None] == session_ids[None, :]
  neg = torch.full(same.shape, -1e9, dtype=logits.dtype,
                   device=logits.device)
  logp = torch.log_softmax(torch.where(same, (logits / temperature)[None, :],
                                       neg), dim=1)
  if label_is_logits:
    target = torch.softmax(torch.where(same, labels[None, :], neg), dim=1)
  else:
    lbl = torch.where(same, labels[None, :], torch.zeros_like(neg))
    target = lbl / torch.clamp(lbl.sum(dim=1, keepdim=True), min=1e-9)
  return weighted_mean(-torch.sum(target * logp, dim=1), weights)


def listwise_distill_loss(labels, logits, session_ids, weights,
                          temperature: float = 1.0,
                          label_clip_max_value: float = 512.0,
                          transform_fn: str = ''):
  """A teacher's ranking positions (1 best), clipped to [1, max] and made
  relevances by transform_fn or log1p(max) - log(position), through the
  listwise rank loss."""
  lbl = torch.clamp(labels.to(logits.dtype), 1.0, label_clip_max_value)
  if transform_fn:
    lbl = _transform(transform_fn)(lbl)
  else:
    lbl = math.log1p(label_clip_max_value) - torch.log(lbl)
  return listwise_rank_loss(lbl, logits, session_ids, weights,
                            temperature=temperature, label_is_logits=False)


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
