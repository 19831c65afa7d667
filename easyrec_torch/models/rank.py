"""Ranking models. Counterpart of easyrec_tpu/models/rank.py: DeepFM
(:32-88), WideAndDeep (:90-133), MultiTower with its DIN and BST towers
(:135-221), DCN (:231-264), AutoInt (:266-305), DLRM (:308-362) and FM
(:364-395); and of easyrec_tpu/models/rank_extra.py: RocketLaunching
(:32-128). Submodule names follow the flax parameter tree (dnn,
tower_<group>, din_<group>, bst_<group>, final_dnn, cross, deep,
interact_<i>, bot_dnn, bot_proj, top_dnn, share_dnn, booster_dense_<i>,
light_dense_<i>, logits, and the group inputs' modules of
models/seq_input.py) so `convert.py` maps the two one to one; flax's
parameters a module creates itself (FM's `global_bias`) are parameters
of the model here."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from easyrec_torch.layers.attention import (BSTEncoder, DinAttention,
                                            MultiHeadSelfAttention)
from easyrec_torch.layers.dnn import DNN, Dense, has_dnn
from easyrec_torch.layers.interaction import FM as FMLayer
from easyrec_torch.layers.interaction import CrossNet, DotInteraction
from easyrec_torch.losses import losses as L
from easyrec_torch.models.base import ModelContext, RankModel, register_model
from easyrec_torch.models.seq_input import (build_flat_part,
                                            build_group_input, build_seq_att,
                                            group_input, group_input_fn,
                                            seq_att_output,
                                            seq_group_tensors,
                                            seq_group_widths)


def _categorical(ctx, group_name: str):
  return [f for f in ctx.group_features(group_name)
          if ctx.specs[f].kind == 'categorical']


def _field_dim(ctx, names, what: str) -> int:
  """The one embedding dim of the stacked fields `names`."""
  dims = {ctx.specs[f].embedding_dim for f in names}
  if len(dims) != 1:
    raise ValueError('%s needs equal embedding dims, got %s'
                     % (what, sorted(dims)))
  return dims.pop()


def _add_wide(logits: torch.Tensor, wide: torch.Tensor) -> torch.Tensor:
  """The wide output added per logit when the dims align, else summed."""
  return logits + (wide if wide.shape[-1] == logits.shape[-1]
                   else wide.sum(dim=1, keepdim=True))


@register_model('DeepFM')
class DeepFM(RankModel):
  """reference: model/deepfm.py:16"""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, device)
    cfg = ctx.model_config.deepfm
    self.wide_names = ctx.group_features('wide') if 'wide' in ctx.groups \
        else ctx.group_features('deep')
    self.fm_names = _categorical(ctx, 'deep')
    fm_dim = _field_dim(ctx, self.fm_names, 'DeepFM')
    self.wide_dim = ctx.layout.wide_output_dim
    self.fm = FMLayer(use_variant=True)
    dt = dict(compute_dtype=ctx.compute_dtype)
    self.dnn = DNN.from_config(
        cfg.dnn, build_group_input(self, ctx, 'deep', generator, device),
        generator=generator, device=device, **dt)
    self.use_final = has_dnn(cfg, 'final_dnn')
    if self.use_final:
      self.final_dnn = DNN.from_config(
          cfg.final_dnn, self.wide_dim + fm_dim + self.dnn.out_features,
          generator=generator, device=device, **dt)
      self.logits = Dense(self.final_dnn.out_features, self.logits_dim(),
                          generator, device)
    else:
      self.logits = Dense(fm_dim + self.dnn.out_features, self.logits_dim(),
                          generator, device)

  def raw_logits(self, batch, pulled) -> torch.Tensor:
    il = self.ctx.input_layer
    wide = il.wide_logits(pulled, batch, self.wide_names)
    fm_out = self.fm(il.group_stack(pulled, batch, self.fm_names))
    deep_out = self.dnn(group_input(self, self.ctx, pulled, batch, 'deep'))
    if self.use_final:
      final = self.final_dnn(torch.cat([wide, fm_out, deep_out], dim=1))
      return self.logits(final)
    return _add_wide(self.logits(torch.cat([fm_out, deep_out], dim=1)),
                     wide)


@register_model('MultiTower')
@register_model('MultiTowerDIN')
@register_model('MultiTowerBST')
class MultiTower(RankModel):
  """reference: model/multi_tower.py, multi_tower_din.py:18,
  multi_tower_bst.py. A DNN tower per feature group, a DIN tower per
  din_towers entry ([attended history and aux histories, through seq_dnn
  where set; query]), a BST tower per bst_towers entry (the target's
  token of a transformer over [target, history]); their outputs
  concatenate in that order into final_dnn and the logit."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, device)
    cfg = ctx.model_config.multi_tower
    kw = dict(generator=generator, device=device)
    self.tower_inputs = [t.input for t in cfg.towers]
    width = 0
    for t in cfg.towers:
      dnn = DNN.from_config(
          t.dnn, build_group_input(self, ctx, t.input, **kw),
          compute_dtype=ctx.compute_dtype, **kw)
      self.add_module('tower_%s' % t.input, dnn)
      width += dnn.out_features
    self.din_inputs = []
    for t in cfg.din_towers:
      group = ctx.seq_att_groups[t.input]
      dq, dh, da = seq_group_widths(ctx, group)
      need_key = group.need_key_feature and dq > 0
      if need_key and dq != dh:
        if not group.allow_key_transform:
          raise ValueError(
              'seq_att group %r: key dim %d != hist dim %d; set '
              'allow_key_transform to project the key' % (t.input, dq, dh))
        self.add_module('key_transform_%s' % t.input, Dense(dq, dh, **kw))
      self.add_module('din_%s' % t.input, DinAttention(
          dh, tuple(t.dnn.hidden_units)[:-1] or (32,),
          activation=t.dnn.activation or 'relu', **kw))
      att_width = dh + sum(da)
      if len(group.seq_dnn.hidden_units):
        seq_dnn = DNN.from_config(group.seq_dnn, att_width, **kw)
        self.add_module('seq_dnn_%s' % t.input, seq_dnn)
        att_width = seq_dnn.out_features
      self.din_inputs.append((t.input, need_key))
      width += att_width + (dh if need_key else 0)
    self.bst_inputs = []
    for t in cfg.bst_towers:
      group = ctx.seq_att_groups[t.input]
      dq, dh, _ = seq_group_widths(ctx, group)
      seq_len = max(ctx.specs[h].num_ids for m in group.seq_att_map
                    for h in m.hist_seq)
      self.add_module('bst_%s' % t.input, BSTEncoder(
          dh, seq_len, dh, target_features=dq,
          num_heads=int(t.multi_head_size) or 4, intermediate_size=4 * dh,
          max_position=max(int(t.seq_len), seq_len + 1), pre_ln=t.pre_ln,
          **kw))
      self.bst_inputs.append(t.input)
      width += dh
    self.final_dnn = DNN.from_config(cfg.final_dnn, width,
                                     compute_dtype=ctx.compute_dtype, **kw)
    self.logits = Dense(self.final_dnn.out_features, self.logits_dim(), **kw)

  def _din_tower(self, name, need_key, batch, pulled) -> torch.Tensor:
    query, hist, mask, aux = seq_group_tensors(
        self.ctx, self.ctx.seq_att_groups[name], batch, pulled)
    if not need_key:
      # no target key: the masked mean of the history is the query
      denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
      query = (hist * mask[:, :, None]).sum(dim=1) / denom
    elif hasattr(self, 'key_transform_%s' % name):
      query = getattr(self, 'key_transform_%s' % name)(query)
    att = getattr(self, 'din_%s' % name)(query, hist, mask, aux=tuple(aux))
    if hasattr(self, 'seq_dnn_%s' % name):
      att = getattr(self, 'seq_dnn_%s' % name)(att)
    return torch.cat([att, query], dim=1) if need_key else att

  def _bst_tower(self, name, batch, pulled) -> torch.Tensor:
    query, hist, mask, _ = seq_group_tensors(
        self.ctx, self.ctx.seq_att_groups[name], batch, pulled)
    return getattr(self, 'bst_%s' % name)(hist, mask, target=query)

  def raw_logits(self, batch, pulled) -> torch.Tensor:
    gi = group_input_fn(self, self.ctx, pulled, batch)
    outs = [getattr(self, 'tower_%s' % name)(gi(name))
            for name in self.tower_inputs]
    outs += [self._din_tower(name, need_key, batch, pulled)
             for name, need_key in self.din_inputs]
    outs += [self._bst_tower(name, batch, pulled)
             for name in self.bst_inputs]
    return self.logits(self.final_dnn(torch.cat(outs, dim=1)))


@register_model('WideAndDeep')
class WideAndDeep(RankModel):
  """reference: model/wide_and_deep.py:16. The deep DNN over the `deep`
  group; with final_dnn, [wide, deep] feed it and the logit, else the wide
  output is added onto the deep logit."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, device)
    cfg = ctx.model_config.wide_and_deep
    kw = dict(generator=generator, device=device)
    self.wide_names = ctx.group_features('wide')
    dt = dict(compute_dtype=ctx.compute_dtype)
    self.dnn = DNN.from_config(
        cfg.dnn, build_group_input(self, ctx, 'deep', **kw), **dt, **kw)
    self.use_final = has_dnn(cfg, 'final_dnn')
    width = self.dnn.out_features
    if self.use_final:
      self.final_dnn = DNN.from_config(
          cfg.final_dnn, ctx.layout.wide_output_dim + width, **dt, **kw)
      width = self.final_dnn.out_features
    self.logits = Dense(width, self.logits_dim(), **kw)

  def raw_logits(self, batch, pulled) -> torch.Tensor:
    wide = self.ctx.input_layer.wide_logits(pulled, batch, self.wide_names)
    deep = self.dnn(group_input(self, self.ctx, pulled, batch, 'deep'))
    if self.use_final:
      return self.logits(self.final_dnn(torch.cat([wide, deep], dim=1)))
    return _add_wide(self.logits(deep), wide)


@register_model('DCN')
class DCN(RankModel):
  """reference: model/dcn.py:15. The `deep` DNN and the `cross` CrossNet
  (cross_num layers, 0 meaning 3) over their towers' groups, a group both
  name rendered once, then final_dnn and the logit."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, device)
    cfg = ctx.model_config.dcn
    kw = dict(generator=generator, device=device)
    self.deep_group = cfg.deep_tower.input
    self.cross_group = cfg.cross_tower.input
    dt = dict(compute_dtype=ctx.compute_dtype)
    self.deep = DNN.from_config(
        cfg.deep_tower.dnn,
        build_group_input(self, ctx, self.deep_group, **kw), **dt, **kw)
    cross_dim = build_group_input(self, ctx, self.cross_group, **kw)
    self.cross = CrossNet(cross_dim,
                          num_layers=int(cfg.cross_tower.cross_num) or 3,
                          **kw)
    self.final_dnn = DNN.from_config(
        cfg.final_dnn, self.deep.out_features + cross_dim, **dt, **kw)
    self.logits = Dense(self.final_dnn.out_features, self.logits_dim(), **kw)

  def raw_logits(self, batch, pulled) -> torch.Tensor:
    gi = group_input_fn(self, self.ctx, pulled, batch)
    deep = self.deep(gi(self.deep_group))
    cross = self.cross(gi(self.cross_group))
    return self.logits(self.final_dnn(torch.cat([deep, cross], dim=1)))


@register_model('AutoInt')
class AutoInt(RankModel):
  """reference: model/autoint.py:16. The categorical features of one group
  (`all` or `deep`, else the first that is not `wide`) stacked as fields,
  each sequence_features sub-group's attended vector one field more
  (projected by seq_proj_<name> to the field dim where its width
  differs), interacting_layer_num multi-head self-attention layers
  (interact_<i>), flattened into the logit."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, device)
    cfg = ctx.model_config.autoint
    kw = dict(generator=generator, device=device)
    groups = list(ctx.groups)
    self.group = next((g for g in groups if g in ('all', 'deep')),
                      next((g for g in groups if g != 'wide'), groups[0]))
    self.names = _categorical(ctx, self.group)
    dim = _field_dim(ctx, self.names, 'AutoInt')
    # the JAX package attends a sub-group under its own name (no group
    # scope): seq_dnn_<name>, seq_proj_<name>
    self.seq_scopes = []
    for sg in ctx.groups[self.group].sequence_features:
      scope = sg.group_name or 'seq'
      width = build_seq_att(self, ctx, sg, scope, **kw)
      if width != dim:
        self.add_module('seq_proj_%s' % scope, Dense(width, dim, **kw))
      self.seq_scopes.append((sg, scope))
    fields = len(self.names) + len(self.seq_scopes)
    heads = int(cfg.multi_head_num) or 1
    head_size = int(cfg.multi_head_size) or dim
    self.num_layers = int(cfg.interacting_layer_num) or 1
    width = dim
    for i in range(self.num_layers):
      self.add_module('interact_%d' % i, MultiHeadSelfAttention(
          width, heads, head_size, **kw))
      width = heads * head_size
    self.logits = Dense(fields * width, self.logits_dim(), **kw)

  def raw_logits(self, batch, pulled) -> torch.Tensor:
    x = self.ctx.input_layer.group_stack(pulled, batch, self.names)
    for sg, scope in self.seq_scopes:
      att = seq_att_output(self, self.ctx, sg, batch, pulled, scope)
      if hasattr(self, 'seq_proj_%s' % scope):
        att = getattr(self, 'seq_proj_%s' % scope)(att)
      x = torch.cat([x, att[:, None, :]], dim=1)
    for i in range(self.num_layers):
      x = getattr(self, 'interact_%d' % i)(x)
    return self.logits(x.reshape(x.shape[0], -1))


@register_model('DLRM')
class DLRM(RankModel):
  """reference: model/dlrm.py:16. The `dense` group through bot_dnn (and
  bot_proj to the embedding dim where its output differs), the `sparse`
  group's categorical features stacked; `dot` interacts [bottom, sparse]
  pairwise (DotInteraction) and the top DNN reads [interactions, the
  flattened sparse embeddings] and the bottom output only under
  arch_with_dense_feature; `cat` flattens [bottom, sparse]."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, device)
    cfg = ctx.model_config.dlrm
    kw = dict(generator=generator, device=device)
    self.dense_names = ctx.group_features('dense') \
        if 'dense' in ctx.groups else []
    self.sparse_names = _categorical(
        ctx, 'sparse' if 'sparse' in ctx.groups else next(iter(ctx.groups)))
    dim = _field_dim(ctx, self.sparse_names, 'DLRM')
    fields = len(self.sparse_names)
    if self.dense_names:
      self.bot_dnn = DNN.from_config(
          cfg.bot_dnn, build_flat_part(self, ctx, self.dense_names, **kw),
          compute_dtype=ctx.compute_dtype, **kw)
      if self.bot_dnn.out_features != dim:
        self.bot_proj = Dense(self.bot_dnn.out_features, dim, **kw)
      fields += 1
    self.dot = (cfg.arch_interaction_op or 'dot') == 'dot'
    self.with_dense = bool(cfg.arch_with_dense_feature and self.dense_names)
    if self.dot:
      self.dot_interaction = DotInteraction(cfg.arch_interaction_itself)
      pairs = fields * (fields + 1) // 2 if cfg.arch_interaction_itself \
          else fields * (fields - 1) // 2
      width = pairs + len(self.sparse_names) * dim + \
          (dim if self.with_dense else 0)
    else:
      width = fields * dim
    self.top_dnn = DNN.from_config(cfg.top_dnn, width,
                                   compute_dtype=ctx.compute_dtype, **kw)
    self.logits = Dense(self.top_dnn.out_features, self.logits_dim(), **kw)

  def raw_logits(self, batch, pulled) -> torch.Tensor:
    il = self.ctx.input_layer
    cat_emb = il.group_stack(pulled, batch, self.sparse_names)   # [B, F, D]
    feats, bot = [cat_emb], None
    if self.dense_names:
      bot = self.bot_dnn(il.group_concat(pulled, batch, self.dense_names,
                                         owner=self))
      if hasattr(self, 'bot_proj'):
        bot = self.bot_proj(bot)
      feats = [bot[:, None, :], cat_emb]
    x = torch.cat(feats, dim=1)
    if self.dot:
      tops = [self.dot_interaction(x),
              cat_emb.reshape(cat_emb.shape[0], -1)]
      if self.with_dense:
        tops.append(bot)
    else:
      tops = [x.reshape(x.shape[0], -1)]
    return self.logits(self.top_dnn(torch.cat(tops, dim=1)))


@register_model('FM')
class FM(RankModel):
  """reference: model/fm.py. The second-order FM summed over the deep
  group's categorical features (`deep`, else the first that is not
  `wide`), the `wide` group's logits summed in, and `global_bias`."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, device)
    groups = list(ctx.groups)
    self.names = _categorical(
        ctx, 'deep' if 'deep' in ctx.groups else
        next(g for g in groups if g != 'wide'))
    self.wide_names = ctx.group_features('wide') \
        if 'wide' in ctx.groups else []
    self.fm = FMLayer(use_variant=False)
    self.global_bias = nn.Parameter(torch.zeros(1, device=device))

  def raw_logits(self, batch, pulled) -> torch.Tensor:
    il = self.ctx.input_layer
    logits = self.fm(il.group_stack(pulled, batch, self.names))   # [B, 1]
    if self.wide_names:
      wide = il.wide_logits(pulled, batch, self.wide_names)
      logits = logits + wide.sum(dim=1, keepdim=True)
    return logits + self.global_bias[None, :]


@register_model('DummyModel')
class DummyModel(RankModel):
  """reference: model/dummy_model.py; JAX rank.py:398-413. Zero logits plus
  one trained bias [1], initialised to zero: it reads no embedding, so a
  run times the input pipeline apart from a model."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, device)
    self.bias = nn.Parameter(torch.zeros(1, device=device))

  def raw_logits(self, batch, pulled) -> torch.Tensor:
    b = batch['sample_weight'].shape[0]
    return torch.zeros((b, 1), device=self.bias.device) + \
        self.bias[None, :]


@register_model('RocketLaunching')
class RocketLaunching(RankModel):
  """reference: model/rocket_launching.py; JAX rank_extra.py:32-128. The
  group (`all`, else the first) concatenated, through share_dnn where set;
  a booster stack (booster_dense_<i>, relu) and a light stack
  (light_dense_<i>, relu) over it, the light one on the shared output
  with its gradient stopped; the prediction is the light logit. The loss
  sums both cross entropies, the hint (L2 from the light probability to
  the stopped booster probability) and, with feature_based_distillation,
  the mean distance of the equal-shaped hidden pairs to the stopped
  booster's (cosine, or euclidean sqrt(mean(sq) + 1e-12))."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, device)
    cfg = ctx.model_config.rocket_launching
    kw = dict(generator=generator, device=device)
    self.group = 'all' if 'all' in ctx.groups else next(iter(ctx.groups))
    width = build_flat_part(self, ctx, ctx.group_features(self.group), **kw)
    self.use_share = has_dnn(cfg, 'share_dnn')
    if self.use_share:
      self.share_dnn = DNN.from_config(cfg.share_dnn, width, **kw)
      width = self.share_dnn.out_features
    for tower in ('booster', 'light'):
      w = width
      units = list(getattr(cfg, '%s_dnn' % tower).hidden_units)
      for i, u in enumerate(units):
        self.add_module('%s_dense_%d' % (tower, i), Dense(w, u, **kw))
        w = u
      self.add_module('%s_logits' % tower, Dense(w, self.logits_dim(), **kw))
    self.n_booster = len(cfg.booster_dnn.hidden_units)
    self.n_light = len(cfg.light_dnn.hidden_units)

  def _tower(self, tower: str, n: int, h: torch.Tensor):
    hidden = []
    for i in range(n):
      h = torch.relu(getattr(self, '%s_dense_%d' % (tower, i))(h))
      hidden.append(h)
    return getattr(self, '%s_logits' % tower)(h), hidden

  def raw_outputs(self, batch, pulled) -> Dict[str, object]:
    x = self.ctx.input_layer.group_concat(
        pulled, batch, self.ctx.group_features(self.group), owner=self)
    shared = self.share_dnn(x) if self.use_share else x
    booster, booster_hidden = self._tower('booster', self.n_booster, shared)
    light, light_hidden = self._tower('light', self.n_light,
                                      shared.detach())
    return {'raw_logits': light, 'booster_logits': booster,
            'light_hidden': light_hidden, 'booster_hidden': booster_hidden}

  def build_loss(self, outputs, batch):
    labels = batch['label.%s' % self.label_name]
    weights = batch['sample_weight']
    light = outputs['logits']
    booster = outputs['booster_logits'][:, 0]
    l_light = L.sigmoid_cross_entropy(labels, light, weights)
    l_booster = L.sigmoid_cross_entropy(labels, booster, weights)
    hint = L.l2_loss(torch.sigmoid(booster).detach(), torch.sigmoid(light),
                     weights)
    losses = {'light_ce': l_light, 'booster_ce': l_booster,
              'hint_loss': hint}
    total = l_light + l_booster + hint
    cfg = self.config.rocket_launching
    if cfg.feature_based_distillation and outputs['light_hidden']:
      cosine = cfg.feature_distillation_function == 'COSINE'
      sims = []
      for lh, bh in zip(outputs['light_hidden'], outputs['booster_hidden']):
        bh = bh.detach()
        if lh.shape != bh.shape:
          continue
        if cosine:
          ln = lh / torch.clamp(torch.linalg.norm(lh, dim=-1, keepdim=True),
                                min=1e-9)
          bn = bh / torch.clamp(torch.linalg.norm(bh, dim=-1, keepdim=True),
                                min=1e-9)
          sims.append(1.0 - L.batch_mean(torch.sum(ln * bn, dim=-1)))
        else:
          sims.append(torch.sqrt(L.batch_mean(torch.square(lh - bh)) +
                                 1e-12))
      if sims:
        fd = sum(sims) / len(sims)
        losses['feature_distill'] = fd
        total = total + fd
    return total, losses

  def export_outputs(self, outputs) -> Dict[str, torch.Tensor]:
    out = super().export_outputs(outputs)
    out['booster_probs'] = torch.sigmoid(outputs['booster_logits'][:, 0])
    return out
