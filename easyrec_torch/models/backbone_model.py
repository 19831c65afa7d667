"""Backbone-driven models: model_class 'RankModel', 'MatchModel' and
'MultiTaskModel' with a `backbone` block DAG and `model_params`.

Counterpart of easyrec_tpu/models/backbone_model.py: _as_tensor (:28-32),
the rank wrapper (:35-58), the match wrapper (:61-100) and the multi-task
wrapper (:103-157).

The JAX wrappers' parameters: a rank model's backbone under `inner`
(`inner/backbone/...`, then `inner/logits`, which it skips when the
backbone already gives the logit's one column); a match model's and a
multi-task model's at the root (`backbone/...`; then per task tower
`<tower>_dnn`, `<tower>_relation_dnn` and `<tower>_logits`). The models here hold the
same modules under the same names, made by the build pass (`build`) that
their constructor runs (models/backbone.py).
"""

from __future__ import annotations

from typing import Dict

import torch

from easyrec_torch.layers.dnn import DNN, Dense, has_dnn
from easyrec_torch.models import backbone as bb
from easyrec_torch.models.base import (ModelContext, RankModel,
                                       register_model)
from easyrec_torch.models.match import MatchModel
from easyrec_torch.models.multi_task import MultiTaskModel
from easyrec_torch.ops import embedding as emb_ops
from easyrec_torch.utils.synthetic import synthetic_batch


def _as_tensor(out):
  if isinstance(out, (list, tuple)):
    vals = bb._flatten(list(out))
    return torch.cat(vals, dim=-1) if len(vals) > 1 else vals[0]
  return out


def build(model, state: bb.BuildState, device=None) -> None:
  """The build pass: one forward of `model` in eval mode, without
  gradients, on a two-row synthetic batch of its features (rows pulled as
  zeros), which makes every module of its backbone and heads; then the
  model is moved to `device`."""
  ctx = model.ctx
  batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
      ctx.specs, ctx.label_fields, 2, seed=0).items()}
  packs = emb_ops.pack_ids(ctx.layout, batch)
  pulled = {k: torch.zeros(tuple(p.shape) + (ctx.layout.tables[k].dim,))
            for k, p in packs.items()}
  state.building = True
  try:
    model.eval()
    with torch.no_grad():
      model(batch, pulled)
  finally:
    state.building = False
    state.generator = None
    model.train()
  if device is not None:
    model.to(device)


def _aux_losses(state: bb.BuildState):
  """The losses recorded in a forward, in flax's `losses` collection
  order (by path; one path's values in call order)."""
  return [v for _, v in sorted(state.sink, key=lambda pv: pv[0])]


@register_model('RankModel')
class BackboneRankModel(RankModel):
  """The backbone's output (a list concatenated) -> the logit: itself
  where it has one column, else through `logits`."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, device)
    self.state = bb.BuildState(generator)
    self.backbone = bb.BackboneModule(ctx, ctx.model_config.backbone,
                                      self.state, 'inner/backbone')
    build(self, self.state, device)

  def raw_outputs(self, batch, pulled) -> Dict[str, object]:
    self.state.sink.clear()
    x = _as_tensor(self.backbone(batch, pulled))
    n = self.logits_dim()
    if not (x.ndim == 2 and x.shape[-1] == n):
      x = bb.lazy_child(self, self.state, 'logits', lambda: Dense(
          x.shape[-1], n, **self.state.kw))(x)
    return {'raw_logits': x, 'aux_losses': _aux_losses(self.state)}


@register_model('MatchModel')
class BackboneMatchModel(MatchModel):
  """The backbone's output blocks at user_tower_idx_in_output and
  item_tower_idx_in_output of model_params are the two towers; a
  pointwise model's logit is their similarity (cosine or inner product)
  over the temperature (no scale_simi, as the JAX wrapper)."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx)
    self.state = bb.BuildState(generator)
    self.backbone = bb.BackboneModule(ctx, ctx.model_config.backbone,
                                      self.state, 'backbone')
    build(self, self.state, device)

  def simi_cfg(self):
    return self.config.model_params

  def forward(self, batch, pulled) -> Dict[str, object]:
    self.state.sink.clear()
    mp = self.config.model_params
    out = self.backbone(batch, pulled)
    if not isinstance(out, (list, tuple)):
      raise ValueError('MatchModel backbone must declare output_blocks '
                       'for the user and item towers')
    result = {'user_tower_emb': out[int(mp.user_tower_idx_in_output)],
              'item_tower_emb': out[int(mp.item_tower_idx_in_output)]}
    if not self.is_listwise:
      self.pointwise(result, result['user_tower_emb'],
                     result['item_tower_emb'], False)
    result['aux_losses'] = _aux_losses(self.state)
    return result


@register_model('MultiTaskModel')
class BackboneMultiTaskModel(MultiTaskModel):
  """The backbone's outputs, one per task tower (or the one output for
  all), through each tower's DNN, then the relation towers' features
  concatenated and their relation DNN, then the logits."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, generator, device)
    self.state = bb.BuildState(generator)
    self.backbone = bb.BackboneModule(ctx, ctx.model_config.backbone,
                                      self.state, 'backbone')
    build(self, self.state, device)

  def _child(self, name: str, make):
    return bb.lazy_child(self, self.state, name, make)

  def forward(self, batch, pulled) -> Dict[str, object]:
    self.state.sink.clear()
    towers = self.towers
    out = self.backbone(batch, pulled)
    if isinstance(out, (list, tuple)):
      task_inputs = list(out)
      if len(task_inputs) < len(towers):
        raise ValueError('backbone produced %d outputs for %d task towers'
                         % (len(task_inputs), len(towers)))
    else:
      task_inputs = [out] * len(towers)
    kw = self.state.kw
    feats = {}
    for i, tower in enumerate(towers):
      h = task_inputs[i]
      if has_dnn(tower, 'dnn'):
        h = self._child('%s_dnn' % tower.tower_name, lambda: DNN.from_config(
            tower.dnn, h.shape[-1], **kw))(h)
      feats[tower.tower_name] = h
    result = {}
    for tower in towers:
      name = tower.tower_name
      h = feats[name]
      if tower.relation_tower_names:
        h = torch.cat([h] + [feats[r] for r in tower.relation_tower_names],
                      dim=-1)
        if has_dnn(tower, 'relation_dnn'):
          h = self._child('%s_relation_dnn' % name, lambda: DNN.from_config(
              tower.relation_dnn, h.shape[-1], **kw))(h)
      n_out = max(int(tower.num_class), 1)
      logits = self._child('%s_logits' % name, lambda: Dense(
          h.shape[-1], n_out, **kw))(h)
      self._predict(result, tower, logits[:, 0] if n_out == 1 else logits)
    result['aux_losses'] = _aux_losses(self.state)
    return result
