"""The other match models: PDN and CoMetricLearningI2I.

Counterpart of easyrec_tpu/models/match_extra.py: PDN (_PDNModule :32-132,
PDN :135-153) and CoMetricLearningI2I (_CMLModule :156-178, :181-231),
with the flax tree's module names at the model's root (user_dnn, u2i_dnn,
trigger_dnn, sim_dnn, direct_user, direct_item, bias_dnn, the scale's
direct_sim_w / direct_sim_b; highway_<i>, dnn)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from easyrec_torch.layers.dnn import DNN, Highway, has_dnn
from easyrec_torch.losses import losses as L
from easyrec_torch.models.base import BaseModel, ModelContext, register_model
from easyrec_torch.models.match import MatchModel, normalize, tower_dnn
from easyrec_torch.models.seq_input import build_flat_part
from easyrec_torch.ops.embedding import sequence_dim
from easyrec_torch.parallel import mesh


def _softplus(x: torch.Tensor) -> torch.Tensor:
  """jax.nn.softplus: log(1 + e^x) as logaddexp(x, 0)."""
  return torch.logaddexp(x, torch.zeros_like(x))


@register_model('PDN')
class PDN(MatchModel):
  """Path-based deep network (JAX _PDNModule): per behaviour, a trigger
  score exp(trigger_dnn(u2i_dnn([u2i_seq; i_seq]) + user_dnn(user))) times
  a similarity score exp(sim_dnn([c, c, i2i_seq, item])) with c =
  i2i_dnn(i_seq) * item_dnn(item), summed over the valid steps; plus the
  softplus of the direct towers' similarity (scaled by |direct_sim_w| and
  shifted by direct_sim_b under scale_simi) and of the bias net over the
  `bias` group, where configured. probs = 1 - exp(-score), logits =
  log(probs) clipped to [1e-8, 1 - 1e-8]. The sequences come from the
  i_seq, u2i_seq and i2i_seq groups, or from `hist` for all three."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx)
    kw = dict(generator=generator, device=device)
    cfg = ctx.model_config.pdn
    if 'i_seq' in ctx.groups:
      self.seq_groups = tuple(g if g in ctx.groups else 'i_seq'
                              for g in ('i_seq', 'u2i_seq', 'i2i_seq'))
    else:
      self.seq_groups = ('hist',) * 3
    i_w, u2i_w, i2i_w = (self._seq_width(g) for g in self.seq_groups)
    user_w = build_flat_part(self, ctx, ctx.group_features('user'), **kw)
    item_w = build_flat_part(self, ctx, ctx.group_features('item'), **kw)
    self.user_dnn = DNN.from_config(cfg.user_dnn, user_w, **kw)
    self.u2i_dnn = DNN.from_config(cfg.u2i_dnn, u2i_w + i_w, **kw)
    self.trigger_dnn = tower_dnn(cfg.trigger_dnn, self.u2i_dnn.out_features,
                                 **kw)
    self.item_dnn = DNN.from_config(cfg.item_dnn, item_w, **kw)
    self.i2i_dnn = DNN.from_config(cfg.i2i_dnn, i_w, **kw)
    if len(cfg.sim_dnn.hidden_units):
      self.sim_dnn = tower_dnn(
          cfg.sim_dnn, 2 * self.i2i_dnn.out_features + i2i_w +
          self.item_dnn.out_features, **kw)
    self.direct = has_dnn(cfg, 'direct_user_dnn') and \
        has_dnn(cfg, 'direct_item_dnn')
    if self.direct:
      self.direct_user = tower_dnn(cfg.direct_user_dnn, user_w, **kw)
      self.direct_item = tower_dnn(cfg.direct_item_dnn, item_w, **kw)
      if cfg.scale_simi:
        self.direct_sim_w = nn.Parameter(torch.ones(1, device=device))
        self.direct_sim_b = nn.Parameter(torch.zeros(1, device=device))
    if has_dnn(cfg, 'bias_dnn') and 'bias' in ctx.groups:
      self.bias_dnn = tower_dnn(cfg.bias_dnn, build_flat_part(
          self, ctx, ctx.group_features('bias'), **kw), **kw)

  def _seq_names(self, group: str):
    return [f for f in self.ctx.group_features(group)
            if self.ctx.specs[f].kind == 'sequence']

  def _seq_width(self, group: str) -> int:
    return sum(sequence_dim(self.ctx.specs[f])
               for f in self._seq_names(group))

  def _seq(self, pulled, batch, group: str):
    il = self.ctx.input_layer
    seqs, mask = [], None
    for f in self._seq_names(group):
      s, m = il.sequence_embedding(pulled, batch, f)
      seqs.append(s)
      mask = m if mask is None else torch.maximum(mask, m)
    return (torch.cat(seqs, dim=-1) if len(seqs) > 1 else seqs[0]), mask

  def forward(self, batch, pulled) -> Dict[str, torch.Tensor]:
    ctx = self.ctx
    il = ctx.input_layer
    user_in = il.group_concat(pulled, batch, ctx.group_features('user'),
                              owner=self)
    item_in = il.group_concat(pulled, batch, ctx.group_features('item'),
                              owner=self)
    i_seq, mask = self._seq(pulled, batch, self.seq_groups[0])
    u2i_seq = i_seq if self.seq_groups[1] == self.seq_groups[0] else \
        self._seq(pulled, batch, self.seq_groups[1])[0]
    i2i_seq = i_seq if self.seq_groups[2] == self.seq_groups[0] else \
        self._seq(pulled, batch, self.seq_groups[2])[0]
    user_fea = self.user_dnn(user_in)
    tseq = self.u2i_dnn(torch.cat([u2i_seq, i_seq], dim=-1))
    trigger_out = torch.exp(self.trigger_dnn(tseq + user_fea[:, None, :]))
    item_fea = self.item_dnn(item_in)
    cross = self.i2i_dnn(i_seq) * item_fea[:, None, :]
    item_tile = item_fea[:, None, :].expand(-1, i_seq.shape[1], -1)
    if hasattr(self, 'sim_dnn'):
      sim_out = torch.exp(self.sim_dnn(torch.cat(
          [cross, cross, i2i_seq, item_tile], dim=-1)))
    else:
      sim_out = torch.ones_like(trigger_out)
    score = torch.sum((trigger_out * sim_out)[..., 0] * mask, dim=1)
    out = {}
    if self.direct:
      du, di = self.direct_user(user_in), self.direct_item(item_in)
      if self.simi_func == 'COSINE':
        du, di = normalize(du), normalize(di)
      direct = torch.sum(du * di, dim=1)
      if hasattr(self, 'direct_sim_w'):
        direct = direct * torch.abs(self.direct_sim_w[0]) + \
            self.direct_sim_b[0]
      score = score + _softplus(direct)
      out['user_tower_emb'], out['item_tower_emb'] = du, di
    if hasattr(self, 'bias_dnn'):
      bias = self.bias_dnn(il.group_concat(
          pulled, batch, ctx.group_features('bias'), owner=self))
      score = score + _softplus(bias[:, 0])
    probs = 1.0 - torch.exp(-score)
    out.update(logits=torch.log(torch.clamp(probs, 1e-8, 1 - 1e-8)),
               probs=probs, trigger_out=trigger_out[..., 0],
               sim_out=sim_out[..., 0])
    return out

  def match_loss(self, outputs, batch):
    loss = L.sigmoid_cross_entropy(self.labels(batch), outputs['logits'],
                                   batch['sample_weight'])
    return loss, {'sigmoid_cross_entropy': loss}

  def metric_inputs(self, outputs, batch) -> Dict[str, torch.Tensor]:
    return {'labels': self.labels(batch), 'probs': outputs['probs'],
            'preds': outputs['probs'], 'weights': batch['sample_weight']}


@register_model('CoMetricLearningI2I')
class CoMetricLearningI2I(BaseModel):
  """Collaborative metric learning (JAX _CMLModule): the `input` group
  (else the first) through each highway tower (emb_size, activation and
  num_layers of its config; the JAX module reads none of the rest) and
  the dnn with a linear last layer, L2-normalised where
  output_l2_normalized_emb; items of one session (field.<session_id>)
  pulled together by the circle or the multi-similarity loss."""

  flax_root = ''

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx)
    kw = dict(generator=generator, device=device)
    cfg = ctx.model_config.metric_learning
    self.group = cfg.input or next(iter(ctx.groups))
    width = build_flat_part(self, ctx, ctx.group_features(self.group), **kw)
    for i, hw in enumerate(cfg.highway):
      highway = Highway(width, int(hw.emb_size),
                        activation=hw.activation or 'relu',
                        num_layers=int(hw.num_layers) or 1, **kw)
      self.add_module('highway_%d' % i, highway)
      width = highway.out_features
    if len(cfg.dnn.hidden_units):
      self.dnn = tower_dnn(cfg.dnn, width, **kw)

  def forward(self, batch, pulled) -> Dict[str, torch.Tensor]:
    cfg = self.config.metric_learning
    x = self.ctx.input_layer.group_concat(
        pulled, batch, self.ctx.group_features(self.group), owner=self)
    for i in range(len(cfg.highway)):
      x = getattr(self, 'highway_%d' % i)(x)
    if hasattr(self, 'dnn'):
      x = self.dnn(x)
    if cfg.output_l2_normalized_emb:
      x = normalize(x)
    return {'float_emb': x}

  def _session_ids(self, batch) -> torch.Tensor:
    cfg = self.config.metric_learning
    for key in ('field.%s' % cfg.session_id, 'label.%s' % cfg.session_id):
      if key in batch:
        return batch[key]
    raise KeyError('CoMetricLearningI2I needs the session_id column %r in '
                   'the batch' % cfg.session_id)

  def build_loss(self, outputs, batch) -> Tuple[torch.Tensor, Dict]:
    cfg = self.config.metric_learning
    emb = outputs['float_emb']
    sess = self._session_ids(batch)
    weights = batch['sample_weight']
    which = cfg.WhichOneof('loss')
    if which == 'multi_similarity_loss':
      p = cfg.multi_similarity_loss
      loss = L.multi_similarity_loss(emb, sess, weights, alpha=p.alpha,
                                     beta=p.beta, lamb=p.lamb, eps=p.eps)
      losses = {'multi_similarity_loss': loss}
    else:
      p = cfg.circle_loss
      loss = L.circle_loss(emb, sess, weights,
                           margin=p.margin if which else 0.25,
                           gamma=p.gamma if which else 32.0)
      losses = {'circle_loss': loss}
    return self.add_kd(loss, losses, outputs, batch)

  def metric_inputs(self, outputs, batch) -> Dict[str, torch.Tensor]:
    """Every off-diagonal pair of the batch: a positive where both rows
    share a session, scored by the sigmoid of its similarity. In a world a
    rank's rows pair with the global batch's (parallel/mesh.py), so the
    ranks' pairs together are the global batch's."""
    emb = outputs['float_emb']
    sess = self._session_ids(batch)
    cols, base = mesh.gather_rows(emb.detach())
    sim = emb @ cols.T
    same = (mesh.gather_ids(sess)[None, :] == sess[:, None]).to(
        torch.float32)
    rows = torch.arange(sim.shape[0], device=sim.device) + base
    off = (rows[:, None] != torch.arange(sim.shape[1], device=sim.device)[
        None, :]).to(torch.float32)
    return {'labels': (same * off).reshape(-1),
            'probs': torch.sigmoid(sim).reshape(-1),
            'preds': sim.reshape(-1), 'weights': off.reshape(-1)}

  def export_outputs(self, outputs) -> Dict[str, torch.Tensor]:
    return {'float_emb': outputs['float_emb']}
