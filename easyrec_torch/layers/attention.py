"""Attention layers: DIN target attention, multi-head self-attention
(AutoInt, the multi_head_attention sequence combiner) and the BST
transformer encoder.

Counterpart of easyrec_tpu/layers/attention.py: DinAttention (:21-60),
MultiHeadSelfAttention (:63-93), PackedMHA (:101-170), TransformerBlock
(:173-213) and BSTEncoder (:216-285), with the flax defaults they rely on:
  - LayerNorm is flax's: epsilon 1e-6 and the fast variance E[x^2] - E[x]^2
    clipped at 0 (torch's nn.LayerNorm has 1e-5 and the two-pass variance);
  - DenseGeneral keeps flax's kernel, [in, H, Dh] for a projection into
    heads and [H, Dh, out] for one out of them, stored with its axes
    reversed as `weight` ([Dh, H, in], [out, Dh, H]): the transpose that
    carries a Dense kernel to nn.Linear's weight carries these too
    (convert.py), and its bias keeps flax's shape ([H, Dh] or [out]);
  - padded steps are masked to -1e9 before a softmax, not -inf.
Dropout sits where the JAX layers put it: on the attention
probabilities (attention_dropout), after the attention and the feed-
forward of a block and after emb_ln (hidden_dropout), flax's inverted
dropout from the layers' generator (layers/dnn.py Dropout). The
MultiTowerBST tower sets every rate to 0 (the reference's MultiTowerBST
has none); the backbone's BST takes the rates its config gives.
PackedMHA's EASYREC_ATTN_IMPL (stock | vpu | vpu_bf16, default vpu_bf16)
is read as the JAX package reads it. The three are one math: scores and
context are batched matmuls on f32 tensors, which under vpu_bf16 hold the
bf16-rounded q, k, probabilities and v (a product of two bf16 values is
exact in f32, so only the order of the f32 sums differs from JAX's
broadcast-multiply-reduce, whose [B, L, M, H, Dh] product this never
builds). Submodule and parameter names follow the flax tree.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from easyrec_torch.layers.dnn import (DNN, Dense, Dropout, get_activation,
                                      lecun_normal_)

_NEG_INF = -1e9
ATTN_IMPLS = ('stock', 'vpu', 'vpu_bf16')


def attn_impl() -> str:
  impl = os.environ.get('EASYREC_ATTN_IMPL', 'vpu_bf16')
  if impl not in ATTN_IMPLS:
    raise ValueError('EASYREC_ATTN_IMPL=%r: one of %s' % (impl, ATTN_IMPLS))
  return impl


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
  return x.to(torch.bfloat16).to(x.dtype)


class LayerNorm(nn.Module):
  """flax.linen.LayerNorm over the last axis (see the module docstring)."""

  def __init__(self, features: int, eps: float = 1e-6, device=None):
    super().__init__()
    self.eps = eps
    self.weight = nn.Parameter(torch.ones(features, device=device))
    self.bias = nn.Parameter(torch.zeros(features, device=device))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + self.eps) * self.weight
    return (x - mean) * mul + self.bias


class DenseGeneral(nn.Module):
  """flax DenseGeneral into heads ([..., in] -> [..., H, Dh], `heads` =
  (H, Dh)) or out of them ([..., H, Dh] -> [..., out], `heads_in` =
  (H, Dh)); the weight is flax's kernel with its axes reversed."""

  def __init__(self, in_features: int = 0, out_features: int = 0,
               heads: Optional[Sequence[int]] = None,
               heads_in: Optional[Sequence[int]] = None,
               use_bias: bool = True,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    if heads is not None:
      h, dh = heads
      shape, fan_in, bias = (dh, h, in_features), in_features, (h, dh)
    else:
      h, dh = heads_in
      shape, fan_in, bias = (out_features, dh, h), h * dh, (out_features,)
    self.into_heads = heads is not None
    self.weight = nn.Parameter(torch.empty(shape, device=device))
    flat = self.weight.data.reshape(-1, fan_in) if self.into_heads else \
        self.weight.data.reshape(out_features, fan_in)
    lecun_normal_(flat, generator)
    self.bias = nn.Parameter(torch.zeros(bias, device=device)) \
        if use_bias else None

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.into_heads:
      dh, h, d = self.weight.shape
      w = self.weight.permute(2, 1, 0).reshape(d, h * dh)
      y = (x @ w).reshape(*x.shape[:-1], h, dh)
    else:
      d, dh, h = self.weight.shape
      w = self.weight.permute(2, 1, 0).reshape(h * dh, d)
      y = x.reshape(*x.shape[:-2], h * dh) @ w
    return y if self.bias is None else y + self.bias


class DinAttention(nn.Module):
  """query [..., D], keys [..., L, D], mask [..., L] -> [..., D] (+ each
  aux [..., L, Da] attended with the same weights, concatenated after
  it). The
  score MLP over [q, h, q-h, q*h] is a plain DNN (no BatchNorm) whose last
  layer is linear, named att_dnn as in the flax tree; the normaliser is a
  softmax over the valid steps (zero weights where a row's mask is empty)
  or a sigmoid times the mask."""

  def __init__(self, dim: int, attention_dims: Sequence[int] = (32, 16),
               activation: str = 'relu',
               attention_normalizer: str = 'softmax',
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    if attention_normalizer not in ('softmax', 'sigmoid'):
      raise ValueError('attention_normalizer %r' % attention_normalizer)
    self.attention_normalizer = attention_normalizer
    self.att_dnn = DNN(4 * dim, tuple(attention_dims) + (1,),
                       activation=activation, use_bn=False,
                       use_final_activation=False, generator=generator,
                       device=device)

  def forward(self, query: torch.Tensor, keys: torch.Tensor,
              mask: torch.Tensor, aux=()) -> torch.Tensor:
    # extra leading dims ([B, N] of per-negative queries) broadcast
    q = query[..., None, :].expand_as(keys)
    att_in = torch.cat([q, keys, q - keys, q * keys], dim=-1)
    scores = self.att_dnn(att_in)[..., 0]                      # [..., L]
    if self.attention_normalizer == 'softmax':
      scores = torch.where(mask > 0, scores,
                           torch.full_like(scores, _NEG_INF))
      weights = torch.softmax(scores, dim=-1)
      weights = weights * (mask.sum(dim=-1, keepdim=True) > 0)
    else:
      weights = torch.sigmoid(scores) * mask
    out = torch.einsum('...l,...ld->...d', weights, keys)
    if aux:
      out = torch.cat([out] + [torch.einsum('...l,...ld->...d', weights, a)
                               for a in aux], dim=-1)
    return out


class MultiHeadSelfAttention(nn.Module):
  """AutoInt's interacting layer: [B, F, D] -> [B, F, H * E], softmax over
  the fields (masked ones at -1e9), a residual (projected by `res` when
  D != H * E) and a relu."""

  def __init__(self, in_features: int, num_heads: int, head_size: int,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.head_size = head_size
    for name in ('q', 'k', 'v'):
      self.add_module(name, DenseGeneral(in_features,
                                         heads=(num_heads, head_size),
                                         use_bias=False, **kw))
    d_out = num_heads * head_size
    if in_features != d_out:
      self.res = nn.Linear(in_features, d_out, bias=False, device=device)
      lecun_normal_(self.res.weight, generator)

  def forward(self, x: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    q = self.q(x).transpose(1, 2)                    # [B, H, F, E]
    k = self.k(x).transpose(1, 2)
    v = self.v(x).transpose(1, 2)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(float(self.head_size))
    if mask is not None:
      scores = torch.where(mask[:, None, None, :] > 0, scores,
                           torch.full_like(scores, _NEG_INF))
    out = torch.softmax(scores, dim=-1) @ v          # [B, H, F, E]
    out = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
    return F.relu(out + (self.res(x) if hasattr(self, 'res') else x))


class PackedMHA(nn.Module):
  """Multi-head dot-product attention, the parameter tree of flax's
  MultiHeadDotProductAttention (query/key/value/out DenseGeneral):
  x_q [B, L, D], x_kv [B, M, D], mask [B, M] -> [B, L, out]."""

  def __init__(self, in_features: int, num_heads: int, qkv_features: int,
               out_features: int, dropout_rate: float = 0.0,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.drop = Dropout(dropout_rate)
    self.head_dim = qkv_features // num_heads
    heads = (num_heads, self.head_dim)
    self.query = DenseGeneral(in_features, heads=heads, **kw)
    self.key = DenseGeneral(in_features, heads=heads, **kw)
    self.value = DenseGeneral(in_features, heads=heads, **kw)
    self.out = DenseGeneral(out_features=out_features, heads_in=heads, **kw)

  def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    q = self.query(x_q) / math.sqrt(self.head_dim)
    k, v = self.key(x_kv), self.value(x_kv)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))     # [B, H, L, Dh]
    bf16 = attn_impl() == 'vpu_bf16'
    if bf16:
      q, k = _bf16_round(q), _bf16_round(k)
    scores = q @ k.transpose(-1, -2)                     # [B, H, L, M]
    if mask is not None:
      scores = torch.where(mask[:, None, None, :] > 0, scores,
                           torch.full_like(scores, _NEG_INF))
    probs = self.drop(torch.softmax(scores, dim=-1))
    if bf16:
      probs, v = _bf16_round(probs), _bf16_round(v)
    ctx = (probs @ v).transpose(1, 2)                    # [B, L, H, Dh]
    return self.out(ctx)


class TransformerBlock(nn.Module):
  """A transformer encoder block (BST's, CMBF's and Uniter's): post-LN
  (the reference's layout) or, with pre_ln, LN before each sub-layer and
  the residual outside; the feed-forward's activation `hidden_act`."""

  def __init__(self, hidden_size: int, num_heads: int,
               intermediate_size: int, pre_ln: bool = False,
               hidden_dropout: float = 0.0, attention_dropout: float = 0.0,
               hidden_act: str = 'gelu',
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.pre_ln = pre_ln
    self.act = get_activation(hidden_act)
    self.drop = Dropout(hidden_dropout)
    self.mha = PackedMHA(hidden_size, num_heads, hidden_size, hidden_size,
                         dropout_rate=attention_dropout, **kw)
    self.ln1 = LayerNorm(hidden_size, device=device)
    self.ln2 = LayerNorm(hidden_size, device=device)
    self.ffn1 = Dense(hidden_size, intermediate_size, **kw)
    self.ffn2 = Dense(intermediate_size, hidden_size, **kw)

  def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    a_in = self.ln1(x) if self.pre_ln else x
    att = self.drop(self.mha(a_in, a_in, mask))
    if self.pre_ln:
      x = x + att
      f_in = self.ln2(x)
    else:
      x = self.ln1(x + att)
      f_in = x
    ffn = self.drop(self.ffn2(self.act(self.ffn1(f_in))))
    if self.pre_ln:
      return x + ffn
    return self.ln2(x + ffn)


class BSTEncoder(nn.Module):
  """Behaviour-sequence transformer: seq [B, L, in] (and a target [B, t]
  at the head or tail when `target_features` > 0) projected to hidden_size,
  plus a learned position embedding, emb_ln, the blocks, the output masked;
  returns the target's token (the first, or the last at the tail) or, with
  output_all_tokens, every token flattened. The position table has
  max(max_position, tokens + start) rows, start 1 when no target is given
  but its head slot is reserved."""

  def __init__(self, in_features: int, seq_len: int, hidden_size: int,
               target_features: int = 0, num_layers: int = 1,
               num_heads: int = 4, intermediate_size: int = 128,
               max_position: int = 512, use_position: bool = True,
               output_all_tokens: bool = False,
               target_item_position: str = 'head',
               reserve_target_position: bool = True, pre_ln: bool = False,
               hidden_dropout: float = 0.0, attention_dropout: float = 0.0,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.drop = Dropout(hidden_dropout)
    if target_item_position not in ('head', 'tail', ''):
      raise ValueError('target_item_position %r' % target_item_position)
    self.pre_ln = pre_ln
    self.output_all_tokens = output_all_tokens
    self.position = target_item_position if target_features else ''
    self.input_proj = Dense(in_features, hidden_size, **kw)
    if self.position:
      self.target_proj = Dense(target_features, hidden_size, **kw)
    tokens = seq_len + (1 if self.position else 0)
    self.use_position = use_position
    self.pos_start = 1 if (not target_features and reserve_target_position
                           and target_item_position == 'head') else 0
    if use_position:
      rows = max(max_position, tokens + self.pos_start)
      self.position_emb = nn.Parameter(
          torch.randn((rows, hidden_size), generator=generator).mul_(0.02)
          .to(device))
    self.emb_ln = LayerNorm(hidden_size, device=device)
    for i in range(num_layers):
      self.add_module('block_%d' % i, TransformerBlock(
          hidden_size, num_heads, intermediate_size, pre_ln=pre_ln,
          hidden_dropout=hidden_dropout, attention_dropout=attention_dropout,
          **kw))
    self.num_layers = num_layers
    if pre_ln:
      self.final_ln = LayerNorm(hidden_size, device=device)

  def forward(self, seq: torch.Tensor, mask: torch.Tensor,
              target: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = self.input_proj(seq)
    tgt_idx = 0
    if self.position:
      t = self.target_proj(target)[:, None, :]
      ones = torch.ones((mask.shape[0], 1), dtype=mask.dtype,
                        device=mask.device)
      if self.position == 'tail':
        x = torch.cat([x, t], dim=1)
        mask = torch.cat([mask, ones], dim=1)
        tgt_idx = x.shape[1] - 1
      else:
        x = torch.cat([t, x], dim=1)
        mask = torch.cat([ones, mask], dim=1)
    if self.use_position:
      start = self.pos_start
      x = x + self.position_emb[None, start:start + x.shape[1], :]
    x = self.drop(self.emb_ln(x))
    for i in range(self.num_layers):
      x = getattr(self, 'block_%d' % i)(x, mask)
    if self.pre_ln:
      x = self.final_ln(x)
    x = x * mask[:, :, None]
    if self.output_all_tokens:
      return x.reshape(x.shape[0], -1)
    return x[:, tgt_idx, :]
