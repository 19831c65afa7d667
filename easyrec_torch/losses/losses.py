"""Losses. Counterpart of easyrec_tpu/losses/losses.py for the
classification loss the port runs (sigmoid_cross_entropy, :24). Per-sample
weights (0 marks padded rows) reduce to a weighted mean."""

from __future__ import annotations

import torch


def weighted_mean(values: torch.Tensor, weights: torch.Tensor):
  weights = weights.to(values.dtype)
  return (values * weights).sum() / torch.clamp(weights.sum(), min=1e-9)


def sigmoid_cross_entropy(labels: torch.Tensor, logits: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
  labels = labels.to(logits.dtype)
  per = torch.clamp(logits, min=0) - logits * labels + \
      torch.log1p(torch.exp(-torch.abs(logits)))
  return weighted_mean(per, weights)
