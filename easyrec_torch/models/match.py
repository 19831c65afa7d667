"""The match family: two-tower retrieval models.

Counterpart of easyrec_tpu/models/match.py: MatchModel (:33-181) with its
similarity columns (_full_logits: the in-batch items with the item-id
collision mask, a sampler's negatives, the hard negatives under their
-1e9 mask, and the per-negative user towers of seq_att_groups), its
listwise (in-batch softmax) and pointwise losses, metric inputs and
serving outputs; _tower_dnn (:184); the two-tower module (:193-310) of
DSSM and DSSM_SENet; DAT (:314-381) with its AMM losses; MIND (:384-487)
over layers/capsule.py; MultiTowerRecall (:490-523) and DropoutNet
(:526-589). A model's modules carry the flax tree's names (user_dnn,
item_dnn, user_senet, seq_att_<i>, user_aug_proj, capsule, concat_dnn,
final_dnn, logits, user_content, user_tower, ...) at its root: the JAX
match modules are not wrapped, so `flax_root` is ''. Every model adds the
config's kd terms to its loss (BaseModel.kd_losses), which the JAX
package's match models leave out (ROADMAP: faults of the reference).

Two draws of the JAX package cannot be reproduced by torch and are held
as distributions (ROADMAP's known divergences): MIND's routing logits
(layers/capsule.py) and DropoutNet's Bernoulli over whole preference
vectors, which draws from the trainer's generator as dropout does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from easyrec_torch.config import schema
from easyrec_torch.layers.attention import DinAttention
from easyrec_torch.layers.capsule import CapsuleLayer
from easyrec_torch.layers.dnn import DNN, Dense, Stochastic, has_dnn
from easyrec_torch.layers.fibinet import SENet
from easyrec_torch.losses import losses as L
from easyrec_torch.models.base import BaseModel, ModelContext, register_model
from easyrec_torch.models.seq_input import build_flat_part
from easyrec_torch.ops.embedding import sequence_dim
from easyrec_torch.parallel import mesh


def normalize(x: torch.Tensor) -> torch.Tensor:
  return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                         min=1e-9)


def tower_dnn(cfg, in_features: int, **kw) -> DNN:
  """A tower's embedding head: the DNN with its last layer a plain linear
  one (no activation, no BatchNorm), as the reference pops the last unit
  off the tower (JAX _tower_dnn)."""
  return DNN.from_config(cfg, in_features, use_final_activation=False,
                         use_final_bn=False, **kw)


def _cfg_value(cfg, name: str, default):
  return getattr(cfg, name) if schema.has_field(cfg.type_name, name) \
      else default


class MatchModel(BaseModel):
  """Two-tower base: similarity columns, the in-batch softmax or the
  pointwise loss, recall@k inputs and the serving embeddings. A model's
  forward returns `user_tower_emb` and `item_tower_emb`, and where a
  sampler's views are in the batch, `neg_item_tower_emb`,
  `hard_neg_item_tower_emb` and `neg_user_tower_emb`; a pointwise model
  `logits` and `probs` as well."""

  flax_root = ''

  def simi_cfg(self):
    return getattr(self.config, self.config.WhichOneof('model'))

  @property
  def simi_func(self) -> str:
    return _cfg_value(self.simi_cfg(), 'simi_func', 'COSINE')

  @property
  def temperature(self) -> float:
    return float(_cfg_value(self.simi_cfg(), 'temperature', 1.0) or 1.0)

  @property
  def is_listwise(self) -> bool:
    return self.config.loss_type == 'SOFTMAX_CROSS_ENTROPY'

  @property
  def label_name(self) -> str:
    return self.config.label_name or self.ctx.label_fields[0]

  def labels(self, batch) -> torch.Tensor:
    return batch['label.%s' % self.label_name]

  def maybe_norm(self, x: torch.Tensor) -> torch.Tensor:
    return normalize(x) if self.simi_func == 'COSINE' else x

  def _item_id_mask(self, batch):
    """[B, B'] bool: rows whose item ids collide with the in-batch items'
    (match_model.py:50-69); in a world B' spans every rank's rows."""
    cfg = self.simi_cfg()
    item_id = _cfg_value(cfg, 'item_id', '')
    if not item_id or _cfg_value(cfg, 'ignore_in_batch_neg_sam', False):
      return None
    key = 'feat.%s.ids' % item_id
    if key not in batch:
      return None
    ids = batch[key][:, 0]
    return mesh.gather_ids(ids)[None, :] == ids[:, None]

  @staticmethod
  def _in_batch_columns(b: int) -> int:
    """The in-batch columns of a [b, ...] logits block: every rank's rows
    in a world."""
    world = mesh.active_world()
    return b if world is None else b * world.size

  @staticmethod
  def _own_diag(b: int, logits: torch.Tensor) -> torch.Tensor:
    """[b, columns] bool: each row's own item among the in-batch columns
    (the diagonal, at this rank's rows' offset in a world)."""
    world = mesh.active_world()
    off = 0 if world is None else world.rank * b
    cols = torch.arange(logits.shape[1], device=logits.device)
    rows = torch.arange(b, device=logits.device)
    return cols[None, :] == rows[:, None] + off

  def _hard_columns(self, outputs, batch, u, b):
    hard = outputs.get('hard_neg_item_tower_emb')
    if hard is None or 'hard_neg_mask' not in batch:
      return None
    mask = batch['hard_neg_mask']
    hard = self.maybe_norm(hard).reshape(b, mask.shape[1], -1)
    hl = torch.einsum('bd,bhd->bh', u, hard)
    return hl.masked_fill(~(mask > 0), -1e9)

  def full_logits(self, outputs, batch) -> torch.Tensor:
    """The similarity columns over the temperature: [B, B + N + H] of the
    in-batch items (collisions off the diagonal at -1e9), the sampled
    negatives and each row's hard negatives (missing ones at -1e9) -- in a
    world the in-batch columns are every rank's items (mesh.gather_rows),
    this rank's own at its rows' offset; or,
    with per-negative user towers, [B, 1 + N + H] of the positive and
    the sampled negatives, in-batch items not scored."""
    u = self.maybe_norm(outputs['user_tower_emb'])
    item = self.maybe_norm(outputs['item_tower_emb'])
    neg = outputs.get('neg_item_tower_emb')
    neg_user = outputs.get('neg_user_tower_emb')
    b = u.shape[0]
    if neg_user is not None and neg is not None:
      pos = torch.sum(u * item, dim=1)
      nl = torch.einsum('bnd,nd->bn', self.maybe_norm(neg_user),
                        self.maybe_norm(neg))
      cols = [pos[:, None], nl]
    else:
      logits = u @ mesh.gather_rows(item)[0].T
      collide = self._item_id_mask(batch)
      if collide is not None:
        logits = logits.masked_fill(collide & ~self._own_diag(b, logits),
                                    -1e9)
      cols = [logits]
      if neg is not None:
        cols.append(u @ self.maybe_norm(neg).T)
    hard = self._hard_columns(outputs, batch, u, b)
    if hard is not None:
      cols.append(hard)
    full = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
    return full / self.temperature

  def match_loss(self, outputs, batch) -> Tuple[torch.Tensor, Dict]:
    """The model's own loss, before the kd terms."""
    labels = self.labels(batch)
    weights = batch['sample_weight']
    if self.is_listwise:
      logits = self.full_logits(outputs, batch)
      logp = torch.log_softmax(logits, dim=1)
      if outputs.get('neg_user_tower_emb') is not None:
        per = -logp[:, 0]
      else:
        per = -logp[self._own_diag(logits.shape[0], logits)]
      w = weights * labels
      loss = mesh.batch_sum(torch.sum(per * w)) / \
          torch.clamp(mesh.batch_sum(torch.sum(w)), min=1e-9)
      return loss, {'softmax_cross_entropy': loss}
    if self.config.loss_type == 'L2_LOSS':
      loss = L.l2_loss(labels, outputs['logits'], weights)
      return loss, {'l2_loss': loss}
    loss = L.sigmoid_cross_entropy(labels, outputs['logits'], weights)
    return loss, {'sigmoid_cross_entropy': loss}

  def build_loss(self, outputs, batch) -> Tuple[torch.Tensor, Dict]:
    total, losses = self.match_loss(outputs, batch)
    return self.add_kd(total, losses, outputs, batch)

  def metric_inputs(self, outputs, batch) -> Dict[str, torch.Tensor]:
    labels = self.labels(batch)
    weights = batch['sample_weight']
    if self.is_listwise:
      logits = self.full_logits(outputs, batch)
      if outputs.get('neg_user_tower_emb') is not None:
        pos = logits[:, 0]
        return {'labels': labels, 'probs': torch.sigmoid(pos), 'preds': pos,
                'weights': weights, 'neg_sam_logits': logits}
      b = logits.shape[0]
      nb = self._in_batch_columns(b)
      pos = logits[self._own_diag(b, logits)]
      mi = {'labels': labels, 'probs': torch.sigmoid(pos), 'preds': pos,
            'weights': weights, 'in_batch_logits': logits[:, :nb]}
      if logits.shape[1] > nb:
        # the positive against the sampled negatives only
        mi['neg_sam_logits'] = torch.cat([pos[:, None], logits[:, nb:]],
                                         dim=1)
      return mi
    if self.config.loss_type == 'L2_LOSS':
      return {'labels': labels, 'probs': outputs['logits'],
              'preds': outputs['logits'], 'weights': weights}
    return {'labels': labels, 'probs': outputs['probs'],
            'preds': outputs['probs'], 'weights': weights}

  def export_outputs(self, outputs) -> Dict[str, torch.Tensor]:
    out = {'user_emb': outputs['user_tower_emb'],
           'item_emb': outputs['item_tower_emb']}
    if self.config.loss_type == 'L2_LOSS':
      if 'logits' in outputs:
        out['y'] = outputs['logits']
    elif 'probs' in outputs:
      out['probs'] = outputs['probs']
    return out

  def pointwise(self, out, user_emb, item_emb, scale_simi: bool):
    """The pointwise head: the similarity over the temperature, through
    the learned simi_scale and simi_bias where scale_simi is set."""
    if self.simi_func == 'COSINE':
      sim = torch.sum(normalize(user_emb) * normalize(item_emb), dim=1)
    else:
      sim = torch.sum(user_emb * item_emb, dim=1)
    logits = sim / self.temperature
    if scale_simi:
      logits = logits * self.simi_scale[0] + self.simi_bias[0]
    out['logits'] = logits
    out['probs'] = torch.sigmoid(logits)


def _view_in_batch(batch, pfx: str) -> bool:
  return any(k.startswith(pfx + 'feat.') for k in batch)


class _TwoTowerModel(MatchModel):
  """DSSM and DSSM_SENet (JAX _TwoTowerModule): the user and item groups
  (through a SENet each for DSSM_SENet) into user_dnn and item_dnn; a
  DinAttention per seq_att_map of seq_att_groups (seq_att_<i>, queried by
  the map's key) concatenated to the user input; a sampler's views
  through the same item tower (their input concatenated, no SENet, as the
  JAX module does), and with attention the per-negative user towers."""

  use_senet = False

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx)
    kw = dict(generator=generator, device=device)
    cfg = self.simi_cfg()
    self.user_names = ctx.group_features('user')
    self.item_names = ctx.group_features('item')
    if self.use_senet:
      widths = []
      for side, names in (('user', self.user_names),
                          ('item', self.item_names)):
        dims = {ctx.specs[f].embedding_dim for f in names}
        if len(dims) != 1:
          raise ValueError('group_stack needs equal embedding dims, got %s'
                           % sorted(dims))
        sc = getattr(cfg, '%s_tower' % side).senet
        senet = SENet(len(names), dims.pop(),
                      reduction_ratio=int(sc.reduction_ratio) or 4,
                      num_squeeze_group=int(sc.num_squeeze_group) or 2,
                      **kw)
        self.add_module('%s_senet' % side, senet)
        widths.append(senet.out_features)
      user_w, item_w = widths
    else:
      user_w = build_flat_part(self, ctx, self.user_names, **kw)
      item_w = build_flat_part(self, ctx, self.item_names, **kw)
    self.att_maps = [m for g in ctx.seq_att_groups.values()
                     for m in g.seq_att_map]
    for i, m in enumerate(self.att_maps):
      dh = sequence_dim(ctx.specs[m.hist_seq[0]])
      self.add_module('seq_att_%d' % i, DinAttention(dh, **kw))
      user_w += dh
    # the two towers run in the compute dtype (JAX match.py:218-221)
    dt = dict(compute_dtype=ctx.compute_dtype)
    self.user_dnn = tower_dnn(cfg.user_tower.dnn, user_w, **dt, **kw)
    self.item_dnn = tower_dnn(cfg.item_tower.dnn, item_w, **dt, **kw)
    self.scale_simi = not self.is_listwise and \
        _cfg_value(cfg, 'scale_simi', False)
    if self.scale_simi:
      self.simi_scale = nn.Parameter(torch.ones(1, device=device))
      self.simi_bias = nn.Parameter(torch.zeros(1, device=device))

  def _side_input(self, pulled, batch, side: str) -> torch.Tensor:
    il = self.ctx.input_layer
    names = self.user_names if side == 'user' else self.item_names
    if self.use_senet:
      return getattr(self, '%s_senet' % side)(
          il.group_stack(pulled, batch, names))
    return il.group_concat(pulled, batch, names, owner=self)

  def forward(self, batch, pulled) -> Dict[str, torch.Tensor]:
    il = self.ctx.input_layer
    user_in = self._side_input(pulled, batch, 'user')
    item_in = self._side_input(pulled, batch, 'item')
    atts = []
    for i, m in enumerate(self.att_maps):
      keys, mask = il.sequence_embedding(pulled, batch, m.hist_seq[0])
      atts.append((getattr(self, 'seq_att_%d' % i), keys, mask, m.key[0]))
    user_base = user_in
    if atts:
      user_in = torch.cat([user_in] + [
          att(il.feature_embedding(pulled, batch, kname), keys, mask)
          for att, keys, mask, kname in atts], dim=-1)
    user_emb = self.user_dnn(user_in)
    item_emb = self.item_dnn(item_in)
    out = {'user_tower_emb': user_emb, 'item_tower_emb': item_emb}
    for pfx, key in (('neg.', 'neg_item_tower_emb'),
                     ('hard_neg.', 'hard_neg_item_tower_emb')):
      if not _view_in_batch(batch, pfx):
        continue
      neg_in = il.group_concat(pulled, batch, self.item_names, owner=self,
                               prefix=pfx)
      out[key] = self.item_dnn(neg_in)
      if atts and pfx == 'neg.':
        # each sampled item re-queries the user's history: a user tower
        # per (row, negative)
        n, b = neg_in.shape[0], user_base.shape[0]
        neg_att = []
        for att, keys, mask, kname in atts:
          q = il.feature_embedding(pulled, batch, kname, prefix='neg.')
          neg_att.append(att(
              q[None].expand(b, n, q.shape[-1]),
              keys[:, None].expand((b, n) + tuple(keys.shape[1:])),
              mask[:, None].expand((b, n) + tuple(mask.shape[1:]))))
        base = user_base[:, None].expand(b, n, user_base.shape[-1])
        out['neg_user_tower_emb'] = self.user_dnn(
            torch.cat([base] + neg_att, dim=-1))
    if not self.is_listwise:
      self.pointwise(out, user_emb, item_emb, self.scale_simi)
    return out


@register_model('DSSM')
class DSSM(_TwoTowerModel):
  """reference: model/dssm.py:17"""


@register_model('DSSM_SENet')
class DSSMSENet(_TwoTowerModel):
  """reference: model/dssm_senet.py"""

  use_senet = True


@register_model('DAT')
class DAT(MatchModel):
  """Dual augmented two-tower (JAX _DATModule, DAT): each tower's input
  carries an augmented vector, the user_id_augment / item_id_augment
  groups' where both exist, else a learned projection of the tower's own
  input (user_aug_proj, item_aug_proj), fit to the other tower's width
  where it differs (user_aug_fit, item_aug_fit); the AMM losses pull each
  augmented vector to the other tower's embedding, which they do not
  move."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx)
    kw = dict(generator=generator, device=device)
    cfg = ctx.model_config.dat
    user_w = build_flat_part(self, ctx, ctx.group_features('user'), **kw)
    item_w = build_flat_part(self, ctx, ctx.group_features('item'), **kw)
    u_last = int(cfg.user_tower.dnn.hidden_units[-1])
    i_last = int(cfg.item_tower.dnn.hidden_units[-1])
    self.aug_groups = 'user_id_augment' in ctx.groups and \
        'item_id_augment' in ctx.groups
    if self.aug_groups:
      au_w = build_flat_part(self, ctx, ctx.group_features('user_id_augment'),
                             **kw)
      ai_w = build_flat_part(self, ctx, ctx.group_features('item_id_augment'),
                             **kw)
    else:
      self.user_aug_proj = Dense(user_w, i_last, **kw)
      self.item_aug_proj = Dense(item_w, u_last, **kw)
      au_w, ai_w = i_last, u_last
    self.user_dnn = tower_dnn(cfg.user_tower.dnn, user_w + au_w, **kw)
    self.item_dnn = tower_dnn(cfg.item_tower.dnn, item_w + ai_w, **kw)
    if au_w != i_last:
      self.user_aug_fit = Dense(au_w, i_last, **kw)
    if ai_w != u_last:
      self.item_aug_fit = Dense(ai_w, u_last, **kw)

  def forward(self, batch, pulled) -> Dict[str, torch.Tensor]:
    ctx = self.ctx
    il = ctx.input_layer

    def concat(group):
      return il.group_concat(pulled, batch, ctx.group_features(group),
                             owner=self)

    user_in, item_in = concat('user'), concat('item')
    if self.aug_groups:
      au, ai = concat('user_id_augment'), concat('item_id_augment')
    else:
      au, ai = self.user_aug_proj(user_in), self.item_aug_proj(item_in)
    user_emb = self.user_dnn(torch.cat([user_in, au], dim=-1))
    item_emb = self.item_dnn(torch.cat([item_in, ai], dim=-1))
    if hasattr(self, 'user_aug_fit'):
      au = self.user_aug_fit(au)
    if hasattr(self, 'item_aug_fit'):
      ai = self.item_aug_fit(ai)
    return {'user_tower_emb': user_emb, 'item_tower_emb': item_emb,
            'augmented_u': au, 'augmented_i': ai}

  def match_loss(self, outputs, batch):
    total, losses = super().match_loss(outputs, batch)
    cfg = self.config.dat
    w = batch['sample_weight'] * self.labels(batch)
    amm_u = torch.sum(torch.square(
        outputs['augmented_u'] - outputs['item_tower_emb'].detach()), dim=1)
    amm_i = torch.sum(torch.square(
        outputs['augmented_i'] - outputs['user_tower_emb'].detach()), dim=1)
    lu = L.weighted_mean(amm_u, w)
    li = L.weighted_mean(amm_i, w)
    losses['amm_loss_u'] = lu
    losses['amm_loss_i'] = li
    return total + cfg.amm_u_weight * lu + cfg.amm_i_weight * li, losses


@register_model('MIND')
class MIND(MatchModel):
  """Multi-interest matching (JAX _MINDModule, MIND): the `hist` group's
  id sequences (not time_id_fea) averaged (user_seq_combine SUM, which
  the reference averages) or concatenated, through pre_capsule where set
  and weighted by the time ids' softmax where time_id_fea is set; the
  capsule's interests beside the user_dnn's features through concat_dnn;
  the item tower item_dnn; the user embedding the interests weighted by
  softmax(simi_pow x similarity to the positive item), or the best one
  (simi_pow >= 100). The capsule draws its routing logits (module
  docstring); `routing_logits`, where set, is handed to it instead."""

  routing_logits = None

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx)
    kw = dict(generator=generator, device=device)
    cfg = ctx.model_config.mind
    self.hist_names = [f for f in ctx.group_features('hist')
                       if ctx.specs[f].kind == 'sequence' and
                       f != cfg.time_id_fea]
    dims = [sequence_dim(ctx.specs[f]) for f in self.hist_names]
    hist_w = dims[0] if cfg.user_seq_combine == 'SUM' else sum(dims)
    if has_dnn(cfg, 'pre_capsule_dnn'):
      self.pre_capsule = DNN.from_config(cfg.pre_capsule_dnn, hist_w, **kw)
      hist_w = self.pre_capsule.out_features
    caps = cfg.capsule_config
    self.capsule = CapsuleLayer(
        hist_w, max_k=int(caps.max_k) or 5,
        high_dim=int(caps.high_dim) or hist_w,
        num_iters=int(caps.num_iters) or 3,
        routing_logits_scale=caps.routing_logits_scale,
        routing_logits_stddev=caps.routing_logits_stddev,
        squash_pow=caps.squash_pow, const_caps_num=caps.const_caps_num, **kw)
    user_w = build_flat_part(self, ctx, ctx.group_features('user'), **kw)
    self.user_dnn = DNN.from_config(cfg.user_dnn, user_w, **kw)
    self.concat_dnn = tower_dnn(
        cfg.concat_dnn, self.capsule.out_features + self.user_dnn.out_features,
        **kw)
    item_w = build_flat_part(self, ctx, ctx.group_features('item'), **kw)
    self.item_dnn = tower_dnn(cfg.item_dnn, item_w, **kw)

  def forward(self, batch, pulled) -> Dict[str, torch.Tensor]:
    ctx = self.ctx
    il = ctx.input_layer
    cfg = self.config.mind
    seqs, mask = [], None
    for h in self.hist_names:
      s, m = il.sequence_embedding(pulled, batch, h)
      seqs.append(s)
      mask = m if mask is None else torch.maximum(mask, m)
    if cfg.user_seq_combine == 'SUM':
      hist = sum(seqs) / len(seqs)
    else:
      hist = torch.cat(seqs, dim=-1)
    if hasattr(self, 'pre_capsule'):
      hist = self.pre_capsule(hist)
    if cfg.time_id_fea:
      # padding steps' time logits at -1e32 before the softmax over steps
      t, tmask = il.sequence_embedding(pulled, batch, cfg.time_id_fea)
      neg = (tmask.to(hist.dtype) * 2 - 1) * 1e32
      t = torch.minimum(t, neg[:, :, None])
      hist = hist * torch.softmax(t, dim=1)
    interests, caps_mask = self.capsule(hist, mask, self.routing_logits)
    user_in = il.group_concat(pulled, batch, ctx.group_features('user'),
                              owner=self)
    user_feat = self.user_dnn(user_in)
    k = interests.shape[1]
    tiled = user_feat[:, None, :].expand(-1, k, -1)
    user_interests = self.concat_dnn(torch.cat([interests, tiled], dim=-1))
    item_in = il.group_concat(pulled, batch, ctx.group_features('item'),
                              owner=self)
    item_emb = self.item_dnn(item_in)
    simi = torch.einsum('bkd,bd->bk', self.maybe_norm(user_interests),
                        self.maybe_norm(item_emb))
    simi = simi.masked_fill(~(caps_mask > 0), -1e9)
    if cfg.simi_pow >= 100:
      att = torch.nn.functional.one_hot(torch.argmax(simi, dim=1),
                                        k).to(simi.dtype)
    else:
      att = torch.softmax(simi * cfg.simi_pow, dim=1)
    user_emb = torch.einsum('bk,bkd->bd', att, user_interests)
    return {'user_tower_emb': user_emb, 'item_tower_emb': item_emb,
            'user_interests': user_interests, 'interests_mask': caps_mask}

  def match_loss(self, outputs, batch):
    total, losses = super().match_loss(outputs, batch)
    cfg = self.config.mind
    if cfg.max_interests_simi < 1.0:
      # pairs of live interests more alike than max_interests_simi
      ui = normalize(outputs['user_interests'])
      sims = torch.einsum('bkd,bjd->bkj', ui, ui)
      k = sims.shape[1]
      off = ~torch.eye(k, dtype=torch.bool, device=sims.device)
      msk = outputs['interests_mask']
      pair_mask = off[None] * (msk[:, :, None] * msk[:, None, :])
      reg = mesh.batch_sum(torch.sum(
          torch.clamp(sims - cfg.max_interests_simi, min=0.0) * pair_mask)) \
          / torch.clamp(mesh.batch_sum(torch.sum(pair_mask)), min=1e-9)
      losses['interest_simi_reg'] = reg
      total = total + reg
    return total, losses

  def export_outputs(self, outputs) -> Dict[str, torch.Tensor]:
    return {'user_emb': outputs['user_tower_emb'],
            'user_interests': outputs['user_interests'],
            'item_emb': outputs['item_tower_emb']}


@register_model('MultiTowerRecall')
class MultiTowerRecall(MatchModel):
  """The two towers' embeddings concatenated through final_dnn into one
  logit (JAX _MultiTowerRecallModule); the sigmoid cross entropy."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx)
    kw = dict(generator=generator, device=device)
    cfg = ctx.model_config.multi_tower_recall
    self.user_dnn = tower_dnn(cfg.user_tower.dnn, build_flat_part(
        self, ctx, ctx.group_features('user'), **kw), **kw)
    self.item_dnn = tower_dnn(cfg.item_tower.dnn, build_flat_part(
        self, ctx, ctx.group_features('item'), **kw), **kw)
    self.final_dnn = DNN.from_config(
        cfg.final_dnn, self.user_dnn.out_features +
        self.item_dnn.out_features, **kw)
    self.logits = Dense(self.final_dnn.out_features, 1, **kw)

  def forward(self, batch, pulled) -> Dict[str, torch.Tensor]:
    ctx = self.ctx
    il = ctx.input_layer
    user_emb = self.user_dnn(il.group_concat(
        pulled, batch, ctx.group_features('user'), owner=self))
    item_emb = self.item_dnn(il.group_concat(
        pulled, batch, ctx.group_features('item'), owner=self))
    logits = self.logits(self.final_dnn(torch.cat([user_emb, item_emb],
                                                  dim=1)))[:, 0]
    return {'user_tower_emb': user_emb, 'item_tower_emb': item_emb,
            'logits': logits, 'probs': torch.sigmoid(logits)}

  def match_loss(self, outputs, batch):
    loss = L.sigmoid_cross_entropy(self.labels(batch), outputs['logits'],
                                   batch['sample_weight'])
    return loss, {'sigmoid_cross_entropy': loss}


class _VectorDropout(Stochastic):
  """DropoutNet's cold-start simulation: in training each row's whole
  vector is kept with probability 1 - rate (unscaled), drawn from the
  trainer's generator."""

  def __init__(self, rate: float):
    super().__init__()
    self.rate = float(rate)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if not self.training or self.rate <= 0:
      return x
    keep = torch.rand((x.shape[0], 1), generator=self.rng(),
                      device=x.device) < 1 - self.rate
    return x * keep.to(x.dtype)


_DROPOUTNET_PARTS = ('user_content', 'user_preference', 'item_content',
                     'item_preference')


@register_model('DropoutNet')
class DropoutNet(MatchModel):
  """Cold-start two towers (JAX _DropoutNetModule): each of the
  user_content, user_preference, item_content and item_preference groups
  present through its DNN (the preference inputs dropped whole at
  user_dropout_rate / item_dropout_rate in training), each side's
  concatenated into user_tower / item_tower; the cosine similarity is the
  logit, and the loss the support-vector softmax over rolled in-batch
  negatives."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx)
    kw = dict(generator=generator, device=device)
    cfg = ctx.model_config.dropoutnet
    self.parts = [p for p in _DROPOUTNET_PARTS if p in ctx.groups]
    widths = {'user': 0, 'item': 0}
    for p in self.parts:
      dnn = DNN.from_config(getattr(cfg, p), build_flat_part(
          self, ctx, ctx.group_features(p), **kw), **kw)
      self.add_module(p, dnn)
      widths[p.split('_')[0]] += dnn.out_features
      if p.endswith('preference'):
        self.add_module('%s_drop' % p, _VectorDropout(
            getattr(cfg, '%s_dropout_rate' % p.split('_')[0])))
    self.user_tower = tower_dnn(cfg.user_tower, widths['user'], **kw)
    self.item_tower = tower_dnn(cfg.item_tower, widths['item'], **kw)

  def forward(self, batch, pulled) -> Dict[str, torch.Tensor]:
    il = self.ctx.input_layer
    outs = {'user': [], 'item': []}
    for p in self.parts:
      x = il.group_concat(pulled, batch, self.ctx.group_features(p),
                          owner=self)
      if hasattr(self, '%s_drop' % p):
        x = getattr(self, '%s_drop' % p)(x)
      outs[p.split('_')[0]].append(getattr(self, p)(x))
    user_emb = self.user_tower(torch.cat(outs['user'], dim=1))
    item_emb = self.item_tower(torch.cat(outs['item'], dim=1))
    sim = torch.sum(normalize(user_emb) * normalize(item_emb), dim=1)
    return {'user_tower_emb': user_emb, 'item_tower_emb': item_emb,
            'logits': sim, 'probs': torch.sigmoid(sim)}

  def match_loss(self, outputs, batch):
    sl = self.config.dropoutnet.softmax_loss
    loss = L.softmax_loss_with_negative_mining(
        outputs['user_tower_emb'], outputs['item_tower_emb'],
        self.labels(batch), batch['sample_weight'],
        num_negative_samples=int(sl.num_negative_samples) or 4,
        margin=sl.margin, gamma=sl.gamma,
        coef=sl.coefficient_of_support_vector)
    return loss, {'softmax_neg_mining': loss}
