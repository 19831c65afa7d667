"""Variational dropout for feature importance.

Counterpart of easyrec_tpu/layers/variational_dropout.py (whole): a
learned per-feature (or, embedding-wise, per-dimension) drop probability
p = sigmoid(logit_p), logit_p starting at -2. In training each feature of
each row is scaled by 1 - sigmoid((logit_p + logistic noise) / 0.1), a
concrete relaxation whose noise comes from the layer's generator (torch
cannot draw flax's); in eval by 1 - p. Its regularisation loss,
regularization_lambda * mean(1 - p), is appended to `sink` as the JAX
layer sows it into flax's `losses` collection, whose path it carries.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from easyrec_torch.layers.dnn import Stochastic


class VariationalDropout(Stochastic):
  """feature_list [B, d_f]... -> the same list, each feature scaled by its
  keep factor."""

  def __init__(self, sizes: Sequence[int], sink: List, path: str,
               regularization_lambda: float = 0.01,
               embedding_wise: bool = False, temperature: float = 0.1,
               device=None):
    super().__init__()
    self.sizes = [int(s) for s in sizes]
    self.embedding_wise = embedding_wise
    self.regularization_lambda = regularization_lambda
    self.temperature = temperature
    self.sink = sink
    self.path = path
    n = sum(self.sizes) if embedding_wise else len(self.sizes)
    self.logit_p = nn.Parameter(torch.full((n,), -2.0, device=device))

  def forward(self, feature_list: List[torch.Tensor]) -> List[torch.Tensor]:
    logit_p = self.logit_p
    if self.embedding_wise:
      per_feat = list(torch.split(logit_p, self.sizes))
    else:
      per_feat = [logit_p[i] for i in range(len(self.sizes))]
    p = torch.sigmoid(logit_p)
    self.sink.append((self.path,
                      self.regularization_lambda * torch.mean(1.0 - p)))
    out = []
    for lp, feat in zip(per_feat, feature_list):
      if self.training:
        u = torch.rand((feat.shape[0],) + tuple(lp.shape),
                       generator=self.rng(), device=feat.device)
        u = u * (1.0 - 2e-6) + 1e-6
        noise = torch.log(u) - torch.log(1.0 - u)
        keep = 1.0 - torch.sigmoid((lp + noise) / self.temperature)
      else:
        keep = 1.0 - torch.sigmoid(lp)
      if keep.ndim == 0:
        keep = keep[None]
      # the JAX layer's broadcast, quirks included: a [B] or [D] factor
      # gains a trailing axis where its length equals the batch's
      while keep.ndim < feat.ndim:
        if keep.shape[0] == feat.shape[0]:
          keep = keep[..., None]
        else:
          keep = keep[None]
      out.append(feat * keep)
    return out
