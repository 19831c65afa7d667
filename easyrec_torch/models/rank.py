"""Ranking models. Counterpart of easyrec_tpu/models/rank.py: DeepFM
(:32-88) and MultiTower with its DIN and BST towers (:135-221). Submodule
names follow the flax parameter tree (dnn, tower_<group>, din_<group>,
seq_dnn_<group>, bst_<group>, final_dnn, logits, and the group inputs'
modules of models/seq_input.py) so `convert.py` maps the two one to
one."""

from __future__ import annotations

import torch

from easyrec_torch.layers.attention import BSTEncoder, DinAttention
from easyrec_torch.layers.dnn import DNN, Dense
from easyrec_torch.layers.interaction import FM
from easyrec_torch.models.base import ModelContext, RankModel, register_model
from easyrec_torch.models.seq_input import (build_group_input, group_input,
                                            group_input_fn,
                                            seq_group_tensors,
                                            seq_group_widths)


@register_model('DeepFM')
class DeepFM(RankModel):
  """reference: model/deepfm.py:16"""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx)
    cfg = ctx.model_config.deepfm
    self.deep_names = ctx.group_features('deep')
    self.wide_names = ctx.group_features('wide') if 'wide' in ctx.groups \
        else self.deep_names
    self.fm_names = [f for f in self.deep_names
                     if ctx.specs[f].kind == 'categorical']
    dims = {ctx.specs[f].embedding_dim for f in self.fm_names}
    if len(dims) != 1:
      raise ValueError('DeepFM needs equal embedding dims, got %s'
                       % sorted(dims))
    fm_dim = dims.pop()
    self.wide_dim = ctx.layout.wide_output_dim
    self.fm = FM(use_variant=True)
    self.dnn = DNN.from_config(
        cfg.dnn, build_group_input(self, ctx, 'deep', generator, device),
        generator=generator, device=device)
    self.use_final = cfg.HasField('final_dnn') and \
        len(cfg.final_dnn.hidden_units) > 0
    if self.use_final:
      self.final_dnn = DNN.from_config(
          cfg.final_dnn, self.wide_dim + fm_dim + self.dnn.out_features,
          generator=generator, device=device)
      self.logits = Dense(self.final_dnn.out_features, 1, generator, device)
    else:
      self.logits = Dense(fm_dim + self.dnn.out_features, 1, generator,
                          device)

  def raw_logits(self, batch, pulled) -> torch.Tensor:
    il = self.ctx.input_layer
    wide = il.wide_logits(pulled, batch, self.wide_names)
    fm_out = self.fm(il.group_stack(pulled, batch, self.fm_names))
    deep_out = self.dnn(group_input(self, self.ctx, pulled, batch, 'deep'))
    if self.use_final:
      final = self.final_dnn(torch.cat([wide, fm_out, deep_out], dim=1))
      return self.logits(final)
    logits = self.logits(torch.cat([fm_out, deep_out], dim=1))
    return logits + (wide if wide.shape[-1] == logits.shape[-1]
                     else wide.sum(dim=1, keepdim=True))


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
    super().__init__(ctx)
    cfg = ctx.model_config.multi_tower
    kw = dict(generator=generator, device=device)
    self.tower_inputs = [t.input for t in cfg.towers]
    width = 0
    for t in cfg.towers:
      dnn = DNN.from_config(
          t.dnn, build_group_input(self, ctx, t.input, **kw), **kw)
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
    self.final_dnn = DNN.from_config(cfg.final_dnn, width, **kw)
    self.logits = Dense(self.final_dnn.out_features, 1, **kw)

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
