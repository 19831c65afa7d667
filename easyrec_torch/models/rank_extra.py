"""The multi-modal fusion rankers CMBF and Uniter.

Counterpart of easyrec_tpu/models/rank_extra.py (:126-331): the token
inputs (_image_tokens, _text_tokens and _other_features), CMBFEncoder and
UniterEncoder, which DBMTL also takes as its bottom_cmbf and bottom_uniter
(models/multi_task.py), and the rank models CMBF and Uniter (RocketLaunching,
the file's first model, is in models/rank.py). The towers read three
conventional feature groups: `image` (dense features cut into patch
tokens), `text` (one token per id or tag feature's embedding) and `other`
or `general` (concatenated, through other_feature_dnn where set). The
attention is PackedMHA and TransformerBlock of layers/attention.py, batched
matmuls under EASYREC_ATTN_IMPL as in the BST; no new kernel. Module and
parameter names follow the flax tree: an encoder's img_proj, img_sa_<i>,
txt_proj, txt_sa_<i>, img_cross_proj, txt_cross_proj, t2i_<i>, i2t_<i>,
t_ln_<i>, i_ln_<i> and other_dnn, or Uniter's img_proj, txt_proj,
position_emb, block_<i> and other_dnn; a model's encoder, final_dnn and
logits under `inner`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from easyrec_torch.layers.attention import (LayerNorm, PackedMHA,
                                            TransformerBlock)
from easyrec_torch.layers.dnn import DNN, Dense, has_dnn
from easyrec_torch.models.base import ModelContext, RankModel, register_model


def _dense_names(ctx, group: str):
  return [f for f in ctx.group_features(group)
          if ctx.specs[f].kind == 'dense']


def _image_width(ctx) -> int:
  """The width of the `image` group's dense features, 0 without it."""
  if 'image' not in ctx.groups:
    return 0
  return sum(ctx.specs[f].value_dim for f in _dense_names(ctx, 'image'))


def _image_tokens(ctx, batch, patch_num: int) -> Optional[torch.Tensor]:
  """The `image` group's dense features as [B, patch_num, width /
  patch_num] tokens; None without an image group (a text-only model)."""
  if 'image' not in ctx.groups:
    return None
  flat = torch.cat([ctx.input_layer.dense_feature(batch, f)
                    for f in _dense_names(ctx, 'image')], dim=-1)
  b, total = flat.shape
  if total % patch_num:
    raise ValueError('image feature dim %d not divisible by patch num %d'
                     % (total, patch_num))
  return flat.reshape(b, patch_num, total // patch_num)


def _text_dim(ctx) -> int:
  """The embedding dim of the `text` group's tokens, 0 without it."""
  if 'text' not in ctx.groups:
    return 0
  dims = {ctx.specs[f].embedding_dim for f in ctx.group_features('text')}
  if len(dims) != 1:
    raise ValueError('the text group needs equal embedding dims, got %s'
                     % sorted(dims))
  return dims.pop()


def _text_tokens(ctx, pulled, batch) -> Optional[torch.Tensor]:
  """The `text` group's embeddings as [B, F, D], one token a feature;
  None without a text group (an image-only model)."""
  if 'text' not in ctx.groups:
    return None
  return ctx.input_layer.group_stack(pulled, batch,
                                     ctx.group_features('text'))


def _other_group(ctx) -> Optional[str]:
  for g in ('other', 'general'):
    if g in ctx.groups:
      return g
  return None


def _build_other(owner: nn.Module, ctx, cfg, kw) -> int:
  """Build `other_dnn` on owner where other_feature_dnn has units;
  returns the width of the other features (0 without their group)."""
  group = _other_group(ctx)
  if group is None:
    return 0
  specs = ctx.specs
  width = sum(specs[f].value_dim if specs[f].kind == 'dense' else
              specs[f].embedding_dim for f in ctx.group_features(group))
  if has_dnn(cfg, 'other_feature_dnn'):
    owner.other_dnn = DNN.from_config(cfg.other_feature_dnn, width, **kw)
    width = owner.other_dnn.out_features
  return width


def _with_other(owner: nn.Module, ctx, pulled, batch, parts) -> torch.Tensor:
  """parts, then the other features where there are any, concatenated."""
  group = _other_group(ctx)
  if group is not None:
    x = ctx.input_layer.group_concat(pulled, batch,
                                     ctx.group_features(group))
    parts = parts + [owner.other_dnn(x) if hasattr(owner, 'other_dnn')
                     else x]
  return torch.cat(parts, dim=-1)


class CMBFEncoder(nn.Module):
  """Cross-modal fusion: each modality projected and through its own
  self-attention blocks; with both, text attending to image tokens and
  image to text (PackedMHA, a residual and a LayerNorm a layer), the two
  token means concatenated; with one, that modality's token mean. The
  other features follow. cfg is a CMBFTower message."""

  def __init__(self, ctx: ModelContext, cfg, generator=None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.ctx = ctx
    self.patch_num = int(cfg.image_feature_patch_num) or 1
    img_w, txt_w = _image_width(ctx), _text_dim(ctx)
    self.has_img, self.has_txt = 'image' in ctx.groups, 'text' in ctx.groups
    if not (self.has_img or self.has_txt):
      raise ValueError('CMBF needs an "image" and/or "text" feature group')
    d_img = int(cfg.image_head_size) * int(cfg.image_multi_head_num)
    d_txt = (int(cfg.text_head_size) or 16) * int(cfg.text_multi_head_num)
    drops = dict(hidden_dropout=cfg.hidden_dropout_prob,
                 attention_dropout=cfg.attention_probs_dropout_prob)
    self.n_img_sa = int(cfg.image_self_attention_layer_num)
    self.n_txt_sa = int(cfg.text_self_attention_layer_num)
    if self.has_img:
      self.img_proj = Dense(img_w // self.patch_num, d_img, **kw)
      for i in range(self.n_img_sa):
        self.add_module('img_sa_%d' % i, TransformerBlock(
            d_img, int(cfg.image_multi_head_num), d_img * 2, **drops, **kw))
    if self.has_txt:
      self.txt_proj = Dense(txt_w, d_txt, **kw)
      for i in range(self.n_txt_sa):
        self.add_module('txt_sa_%d' % i, TransformerBlock(
            d_txt, int(cfg.text_multi_head_num), d_txt * 2, **drops, **kw))
    self.cross = self.has_img and self.has_txt
    if self.cross:
      d = max(d_img, d_txt)
      heads = int(cfg.multi_head_num) or 1
      self.img_cross_proj = Dense(d_img, d, **kw)
      self.txt_cross_proj = Dense(d_txt, d, **kw)
      self.n_cross = int(cfg.cross_modal_layer_num) or 1
      for i in range(self.n_cross):
        self.add_module('t2i_%d' % i, PackedMHA(d, heads, d, d, **kw))
        self.add_module('i2t_%d' % i, PackedMHA(d, heads, d, d, **kw))
        self.add_module('t_ln_%d' % i, LayerNorm(d, device=device))
        self.add_module('i_ln_%d' % i, LayerNorm(d, device=device))
      width = 2 * d
    else:
      width = d_img if self.has_img else d_txt
    self.out_features = width + _build_other(self, ctx, cfg, kw)

  def _self_attention(self, x, prefix: str, n: int):
    mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
    for i in range(n):
      x = getattr(self, '%s_%d' % (prefix, i))(x, mask)
    return x

  def forward(self, batch, pulled) -> torch.Tensor:
    ctx = self.ctx
    img = txt = None
    if self.has_img:
      img = self._self_attention(
          self.img_proj(_image_tokens(ctx, batch, self.patch_num)),
          'img_sa', self.n_img_sa)
    if self.has_txt:
      txt = self._self_attention(
          self.txt_proj(_text_tokens(ctx, pulled, batch)), 'txt_sa',
          self.n_txt_sa)
    if not self.cross:
      parts = [(img if txt is None else txt).mean(dim=1)]
    else:
      img_c, txt_c = self.img_cross_proj(img), self.txt_cross_proj(txt)
      for i in range(self.n_cross):
        t2i = getattr(self, 't2i_%d' % i)(txt_c, img_c)
        i2t = getattr(self, 'i2t_%d' % i)(img_c, txt_c)
        txt_c = getattr(self, 't_ln_%d' % i)(txt_c + t2i)
        img_c = getattr(self, 'i_ln_%d' % i)(img_c + i2t)
      parts = [txt_c.mean(dim=1), img_c.mean(dim=1)]
    return _with_other(self, ctx, pulled, batch, parts)


class UniterEncoder(nn.Module):
  """Single-stream fusion: the image features as one token and the text
  tokens, each projected to hidden_size and concatenated, plus a learned
  position embedding, through the transformer blocks; the token mean,
  then the other features. cfg is a UniterTower message."""

  def __init__(self, ctx: ModelContext, cfg, generator=None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.ctx = ctx
    d = int(cfg.hidden_size) or 64
    self.has_img, self.has_txt = 'image' in ctx.groups, 'text' in ctx.groups
    if not (self.has_img or self.has_txt):
      raise ValueError('Uniter needs an "image" and/or "text" feature group')
    if self.has_img:
      self.img_proj = Dense(_image_width(ctx), d, **kw)
    if self.has_txt:
      self.txt_proj = Dense(_text_dim(ctx), d, **kw)
    self.use_position = bool(cfg.use_position_embeddings)
    if self.use_position:
      rows = int(cfg.max_position_embeddings) or 512
      self.position_emb = nn.Parameter(
          torch.randn((rows, d), generator=generator)
          .mul_(float(cfg.initializer_range) or 0.02).to(device))
    self.n_layers = int(cfg.num_hidden_layers) or 1
    for i in range(self.n_layers):
      self.add_module('block_%d' % i, TransformerBlock(
          d, int(cfg.num_attention_heads) or 4,
          int(cfg.intermediate_size) or d * 4,
          hidden_dropout=cfg.hidden_dropout_prob,
          attention_dropout=cfg.attention_probs_dropout_prob,
          hidden_act=cfg.hidden_act or 'gelu', **kw))
    self.out_features = d + _build_other(self, ctx, cfg, kw)

  def forward(self, batch, pulled) -> torch.Tensor:
    ctx = self.ctx
    toks = []
    if self.has_img:
      toks.append(self.img_proj(_image_tokens(ctx, batch, 1)))
    if self.has_txt:
      toks.append(self.txt_proj(_text_tokens(ctx, pulled, batch)))
    x = torch.cat(toks, dim=1) if len(toks) > 1 else toks[0]
    mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
    if self.use_position:
      x = x + self.position_emb[None, :x.shape[1], :]
    for i in range(self.n_layers):
      x = getattr(self, 'block_%d' % i)(x, mask)
    return _with_other(self, ctx, pulled, batch, [x.mean(dim=1)])


class _FusionRanker(RankModel):
  """An encoder (`encoder`), final_dnn where it has units, `logits`."""

  encoder_cls = None
  message = ''

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, device)
    kw = dict(generator=generator, device=device)
    cfg = getattr(ctx.model_config, self.message)
    self.encoder = self.encoder_cls(ctx, cfg.config, **kw)
    width = self.encoder.out_features
    if has_dnn(cfg, 'final_dnn'):
      self.final_dnn = DNN.from_config(cfg.final_dnn, width, **kw)
      width = self.final_dnn.out_features
    self.logits = Dense(width, self.logits_dim(), **kw)

  def raw_logits(self, batch, pulled) -> torch.Tensor:
    h = self.encoder(batch, pulled)
    if hasattr(self, 'final_dnn'):
      h = self.final_dnn(h)
    return self.logits(h)


@register_model('CMBF')
class CMBF(_FusionRanker):
  """reference: model/cmbf.py (image and text cross-modal fusion)."""

  encoder_cls = CMBFEncoder
  message = 'cmbf'


@register_model('Uniter')
class Uniter(_FusionRanker):
  """reference: model/uniter.py (single-stream multi-modal fusion)."""

  encoder_cls = UniterEncoder
  message = 'uniter'


def fusion_bottom(ctx: ModelContext, dbmtl_cfg, generator=None,
                  device=None) -> Optional[Tuple[str, nn.Module]]:
  """DBMTL's multi-modal bottom and the name flax gives it (bottom_cmbf
  or bottom_uniter), where the DBMTL message sets one; else None."""
  kw = dict(generator=generator, device=device)
  if dbmtl_cfg.HasField('bottom_cmbf'):
    return 'bottom_cmbf', CMBFEncoder(ctx, dbmtl_cfg.bottom_cmbf, **kw)
  if dbmtl_cfg.HasField('bottom_uniter'):
    return 'bottom_uniter', UniterEncoder(ctx, dbmtl_cfg.bottom_uniter,
                                          **kw)
  return None
