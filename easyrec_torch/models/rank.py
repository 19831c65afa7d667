"""Ranking models. Counterpart of easyrec_tpu/models/rank.py: DeepFM
(:32-88). Submodule names follow the flax parameter tree (dnn, final_dnn,
logits) so `convert.py` maps the two one to one."""

from __future__ import annotations

import torch

from easyrec_torch.layers.dnn import DNN, Dense
from easyrec_torch.layers.interaction import FM
from easyrec_torch.models.base import ModelContext, RankModel, register_model
from easyrec_torch.models.seq_input import group_input, group_width


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
    self.dnn = DNN.from_config(cfg.dnn, group_width(ctx, 'deep'),
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
    deep_out = self.dnn(group_input(self.ctx, pulled, batch, 'deep'))
    if self.use_final:
      final = self.final_dnn(torch.cat([wide, fm_out, deep_out], dim=1))
      return self.logits(final)
    logits = self.logits(torch.cat([fm_out, deep_out], dim=1))
    return logits + (wide if wide.shape[-1] == logits.shape[-1]
                     else wide.sum(dim=1, keepdim=True))
