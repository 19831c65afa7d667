"""Numeric-feature embeddings: Periodic, AutoDis, NaryDis.

Counterpart of easyrec_tpu/layers/numeric_embedding.py (whole):
_shape_output (:22-29), PeriodicEmbedding (:32-66), AutoDisEmbedding
(:69-98) and NaryDisEmbedding (:101-150). Each turns a dense [B, N] matrix
of raw numeric features into learned embeddings; its parameters keep
flax's names and layouts (coef, linear_w, linear_b; meta_embedding,
proj_w, proj_mat; emb_carry<i>), so convert.py carries them as they are.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from easyrec_torch.layers.dnn import flax_init, get_activation


def _shape_output(emb: torch.Tensor, output_3d: bool, output_list: bool):
  """emb [B, N, D] -> a list of [B, D], the 3-D tensor, or [B, N * D]."""
  if output_list:
    return [emb[:, i, :] for i in range(emb.shape[1])]
  if output_3d:
    return emb
  b, n, d = emb.shape
  return emb.reshape(b, n * d)


def _param(tensor: torch.Tensor, device) -> nn.Parameter:
  return nn.Parameter(tensor.to(device))


class PeriodicEmbedding(nn.Module):
  """[sin(2 pi c x), cos(2 pi c x)] with c ~ N(0, sigma^2) [N, D/2], then
  a per-feature linear layer and its activation where add_linear_layer."""

  def __init__(self, num_features: int, embedding_dim: int,
               sigma: float = 1.0, add_linear_layer: bool = True,
               linear_activation: str = 'relu',
               output_3d_tensor: bool = False,
               output_tensor_list: bool = False,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    half = max(embedding_dim // 2, 1)
    self.coef = _param(torch.randn((num_features, half),
                                   generator=generator) * sigma, device)
    self.add_linear_layer = add_linear_layer
    if add_linear_layer:
      self.linear_w = _param(flax_init(
          (num_features, 2 * half, embedding_dim), 'glorot_uniform',
          generator), device)
      self.linear_b = _param(torch.zeros(num_features, embedding_dim),
                             device)
      self.act = get_activation(linear_activation)
    self.shape = (output_3d_tensor, output_tensor_list)

  def forward(self, x: torch.Tensor):
    if x.ndim == 1:
      x = x[:, None]
    v = 2.0 * math.pi * self.coef[None, :, :] * x[:, :, None]
    emb = torch.cat([torch.sin(v), torch.cos(v)], dim=-1)
    if self.add_linear_layer:
      emb = torch.einsum('bnk,nkd->bnd', emb, self.linear_w) + \
          self.linear_b[None]
      if self.act is not None:
        emb = self.act(emb)
    return _shape_output(emb, *self.shape)


class AutoDisEmbedding(nn.Module):
  """AutoDis soft discretisation: per feature, leaky_relu(proj_w * x)
  [bins], a skip-connected second projection by proj_mat (alpha =
  keep_prob), a softmax at `temperature` over the bins, weighting
  meta_embedding [N, bins, D]."""

  def __init__(self, num_features: int, embedding_dim: int, num_bins: int,
               temperature: float = 1.0, keep_prob: float = 0.8,
               output_3d_tensor: bool = False,
               output_tensor_list: bool = False,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    n = num_features
    self.meta_embedding = _param(flax_init(
        (n, num_bins, embedding_dim), 'glorot_uniform', generator), device)
    self.proj_w = _param(flax_init((n, num_bins), 'glorot_uniform',
                                   generator), device)
    self.proj_mat = _param(flax_init((n, num_bins, num_bins),
                                     'glorot_uniform', generator), device)
    self.temperature = temperature
    self.keep_prob = keep_prob
    self.shape = (output_3d_tensor, output_tensor_list)

  def forward(self, x: torch.Tensor):
    if x.ndim == 1:
      x = x[:, None]
    hidden = F.leaky_relu(self.proj_w[None, :, :] * x[:, :, None], 0.01)
    logits = torch.einsum('nkj,bnj->bnk', self.proj_mat, hidden) + \
        self.keep_prob * hidden
    weights = torch.softmax(logits / self.temperature, dim=-1)
    emb = torch.einsum('bnk,nkd->bnd', weights, self.meta_embedding)
    return _shape_output(emb, *self.shape)


_INT32_MAX = 2 ** 31 - 1


class NaryDisEmbedding(nn.Module):
  """N-ary discretisation: the integer part of max(x * multiplier, 0)
  (saturating at the int32 range, as XLA converts) written in each radix
  of `carries`, every digit embedded by position (emb_carry<i>
  [digits * carry, D], N(0, 0.01^2)), pooled within a radix (sum or mean)
  and across them (concat, sum or mean)."""

  def __init__(self, num_features: int, embedding_dim: int,
               carries: Sequence[int] = (2, 9), multiplier: float = 1.0,
               intra_ary_pooling: str = 'sum',
               inter_ary_pooling: str = 'concat',
               output_3d_tensor: bool = False,
               output_tensor_list: bool = False,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    self.carries = [int(c) for c in carries]
    self.digits = []
    for ci, carry in enumerate(self.carries):
      digits = max(int(np.ceil(31 / np.log2(max(carry, 2)))), 1)
      self.digits.append(digits)
      self.register_parameter('emb_carry%d' % ci, _param(
          torch.randn((digits * carry, embedding_dim),
                      generator=generator) * 0.01, device))
    self.multiplier = multiplier
    self.intra = intra_ary_pooling
    self.inter = inter_ary_pooling
    self.shape = (output_3d_tensor, output_tensor_list)

  def forward(self, x: torch.Tensor):
    if x.ndim == 1:
      x = x[:, None]
    vals = torch.clamp(x * self.multiplier, min=0.0).to(torch.int64) \
        .clamp(max=_INT32_MAX)
    per_carry = []
    for ci, carry in enumerate(self.carries):
      v = vals
      ids = []
      for p in range(self.digits[ci]):
        ids.append(v % carry + p * carry)
        v = v // carry
      emb = getattr(self, 'emb_carry%d' % ci)[torch.stack(ids, dim=-1)]
      per_carry.append(emb.mean(dim=2) if self.intra == 'mean'
                       else emb.sum(dim=2))
    if len(per_carry) == 1:
      out = per_carry[0]
    elif self.inter in ('sum', 'mean'):
      out = per_carry[0]
      for t in per_carry[1:]:
        out = out + t
      if self.inter == 'mean':
        out = out / len(per_carry)
    else:
      out = torch.cat(per_carry, dim=-1)
    return _shape_output(out, *self.shape)
