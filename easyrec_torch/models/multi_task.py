"""Multi-task models: SimpleMultiTask, MMoE, ESMM, DBMTL and PLE.

Counterpart of easyrec_tpu/models/multi_task.py: MultiTaskModel (:27) with
its tower-label matching, per-tower losses (build_loss :38-78,
_tower_loss :80-103), metric inputs (:105-126) and export outputs (:128);
_tower_head (:133); SimpleMultiTask (:162), MMoE (:201), ESMM (:246), DBMTL
(:366) and PLE (:415). Each model's outputs are `logits_<tower>` and
`probs_<tower>` (sigmoid, or softmax for num_class > 1), and ESMM's
`probs_ctcvr`.

flax creates these models' parameters inside their __call__, at the
model's root (the JAX package wraps no multi-task module, so they sit
under no 'inner' scope): a tower's `<tower>_dnn`, `<tower>_logits` and
DBMTL's `<tower>_relation`, `bottom_dnn`, the `mmoe` layer, PLE's
`cgc_<network_name or index>`, ESMM's `group_<input>` and the group
inputs' modules. The torch models build them in __init__ under the same
names, so convert.py maps the two one to one.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from easyrec_torch.config.config_util import task_towers
from easyrec_torch.layers.dnn import DNN, Dense, has_dnn
from easyrec_torch.layers.multi_task import CGCLayer, MMoE as MMoELayer
from easyrec_torch.losses import losses as L
from easyrec_torch.models.base import BaseModel, ModelContext, register_model
from easyrec_torch.models.rank_extra import fusion_bottom
from easyrec_torch.models.seq_input import (build_group_input, group_input,
                                            group_input_fn)


class MultiTaskModel(BaseModel):
  """Per-task towers, losses and metric inputs."""

  flax_root = ''

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx)
    self.kw = dict(generator=generator, device=device)
    self.towers = task_towers(ctx.model_config)

  def _tower_label(self, tower, idx: int) -> str:
    return tower.label_name or self.ctx.label_fields[idx]

  def _label(self, batch, idx: int) -> torch.Tensor:
    return batch['label.%s' % self._tower_label(self.towers[idx], idx)]

  # -- towers -------------------------------------------------------------

  def _add_head(self, tower, in_features: int, name: str) -> None:
    """_tower_head's modules: `<name>_dnn` where the tower has a dnn, and
    `<name>_logits`."""
    if has_dnn(tower, 'dnn'):
      dnn = DNN.from_config(tower.dnn, in_features, **self.kw)
      self.add_module('%s_dnn' % name, dnn)
      in_features = dnn.out_features
    self.add_module('%s_logits' % name,
                    Dense(in_features, max(int(tower.num_class), 1),
                          **self.kw))

  def _head(self, tower, x: torch.Tensor, name: str) -> torch.Tensor:
    if hasattr(self, '%s_dnn' % name):
      x = getattr(self, '%s_dnn' % name)(x)
    logits = getattr(self, '%s_logits' % name)(x)
    return logits[:, 0] if logits.shape[1] == 1 else logits

  @staticmethod
  def _predict(out: Dict, tower, logits: torch.Tensor) -> None:
    out['logits_%s' % tower.tower_name] = logits
    out['probs_%s' % tower.tower_name] = torch.sigmoid(logits) \
        if int(tower.num_class) <= 1 else torch.softmax(logits, dim=-1)

  # -- loss ---------------------------------------------------------------

  def build_loss(self, outputs, batch):
    weights = batch['sample_weight']
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for idx, tower in enumerate(self.towers):
      name = tower.tower_name
      label = self._label(batch, idx)
      logits = outputs['logits_%s' % name]
      w = weights if tower.use_sample_weight else torch.ones_like(weights)
      if tower.task_space_indicator_label:
        ind = batch['label.%s' % tower.task_space_indicator_label]
        w = w * (tower.in_task_space_weight * (ind > 0) +
                 tower.out_task_space_weight * (ind <= 0))
      if not tower.losses:
        value = self._tower_loss(tower.loss_type, None, tower, label,
                                 logits, w)
        losses['%s_loss_%s' % (tower.loss_type.lower(), name)] = value
        total = total + tower.weight * value
        continue
      for loss_cfg in tower.losses:
        lt = loss_cfg.loss_type
        if lt == 'ORDER_CALIBRATE_LOSS':
          # a task's probability must not exceed its relation towers':
          # mean relu(p_t - p_rel), no sample weight
          for rel in getattr(tower, 'relation_tower_names', []):
            value = torch.mean(torch.relu(outputs['probs_%s' % name] -
                                          outputs['probs_%s' % rel]))
            losses['order_calibrate_loss_%s_%s' % (rel, name)] = value
            total = total + loss_cfg.weight * value
          continue
        which = loss_cfg.WhichOneof('loss_param')
        params = getattr(loss_cfg, which) if which else None
        value = self._tower_loss(lt, params, tower, label, logits, w)
        losses['%s_loss_%s' % (lt.lower(), name)] = value
        total = total + tower.weight * loss_cfg.weight * value
    return total, losses

  @staticmethod
  def _tower_loss(lt, params, tower, label, logits, w) -> torch.Tensor:
    if lt == 'SIGMOID_L2_LOSS':
      squeezed = logits[..., 0] if logits.ndim > 1 else logits
      return L.l2_loss(label, torch.sigmoid(squeezed), w)
    # the cross entropies (config_util.check_ported refuses other types)
    if int(tower.num_class) > 1 and lt not in (
        'L2_LOSS', 'BINARY_FOCAL_LOSS', 'F1_REWEIGHTED_LOSS'):
      return L.softmax_cross_entropy(label, logits, w)
    return L.loss_by_type(lt, params, label, logits, w)

  # -- metrics and export -------------------------------------------------

  @staticmethod
  def _metric(labels, probs, weights) -> Dict[str, torch.Tensor]:
    return {'labels': labels, 'probs': probs, 'weights': weights}

  def metric_inputs(self, outputs, batch):
    """The first tower drives the headline metrics."""
    return self._metric(self._label(batch, 0),
                        outputs['probs_%s' % self.towers[0].tower_name],
                        batch['sample_weight'])

  def metric_task_names(self) -> List[str]:
    return [t.tower_name for t in self.towers]

  def metric_inputs_per_task(self, outputs, batch):
    return {t.tower_name: self._metric(self._label(batch, i),
                                       outputs['probs_%s' % t.tower_name],
                                       batch['sample_weight'])
            for i, t in enumerate(self.towers)}

  def export_outputs(self, outputs):
    return {k: v for k, v in outputs.items()
            if k.startswith('probs_') or k.startswith('logits_')}


@register_model('SimpleMultiTask')
class SimpleMultiTask(MultiTaskModel):
  """reference: model/simple_multi_task.py"""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, generator, device)
    self.group = next(iter(ctx.groups))
    width = build_group_input(self, ctx, self.group, **self.kw)
    for tower in self.towers:
      self._add_head(tower, width, tower.tower_name)

  def forward(self, batch, pulled):
    x = group_input(self, self.ctx, pulled, batch, self.group)
    out = {}
    for tower in self.towers:
      self._predict(out, tower, self._head(tower, x, tower.tower_name))
    return out


@register_model('MMoE')
class MMoE(MultiTaskModel):
  """reference: model/mmoe.py:14. The experts are expert_dnn's, or the
  deprecated form's first experts[].dnn; num_expert, or the number of
  experts[] where it is 0."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, generator, device)
    cfg = ctx.model_config.mmoe
    self.group = next(iter(ctx.groups))
    width = build_group_input(self, ctx, self.group, **self.kw)
    expert_cfg = cfg.expert_dnn if cfg.HasField('expert_dnn') else \
        cfg.experts[0].dnn
    self.mmoe = MMoELayer(
        width, len(self.towers), int(cfg.num_expert) or len(cfg.experts),
        tuple(expert_cfg.hidden_units),
        expert_activation=expert_cfg.activation or 'relu', **self.kw)
    for tower in self.towers:
      self._add_head(tower, self.mmoe.out_features, tower.tower_name)

  def forward(self, batch, pulled):
    x = group_input(self, self.ctx, pulled, batch, self.group)
    out = {}
    for tower, feat in zip(self.towers, self.mmoe(x)):
      self._predict(out, tower, self._head(tower, feat, tower.tower_name))
    return out


@register_model('ESMM')
class ESMM(MultiTaskModel):
  """reference: model/esmm.py:17. The input is each of `groups` through
  its DNN `group_<input>`, concatenated (the first feature group where
  there are none); the towers' modules are `ctr_*` and `cvr_*` whatever
  their names. cvr is trained through p_ctr * p_cvr (`probs_ctcvr`)."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, generator, device)
    cfg = ctx.model_config.esmm
    self.inputs = [g.input for g in cfg.groups]
    if self.inputs:
      width = 0
      for g in cfg.groups:
        dnn = DNN.from_config(g.dnn, build_group_input(self, ctx, g.input,
                                                       **self.kw), **self.kw)
        self.add_module('group_%s' % g.input, dnn)
        width += dnn.out_features
    else:
      self.group = next(iter(ctx.groups))
      width = build_group_input(self, ctx, self.group, **self.kw)
    self._add_head(cfg.ctr_tower, width, 'ctr')
    self._add_head(cfg.cvr_tower, width, 'cvr')

  def forward(self, batch, pulled):
    if self.inputs:
      gi = group_input_fn(self, self.ctx, pulled, batch)
      feats = [getattr(self, 'group_%s' % g)(gi(g)) for g in self.inputs]
      x = torch.cat(feats, dim=1) if len(feats) > 1 else feats[0]
    else:
      x = group_input(self, self.ctx, pulled, batch, self.group)
    ctr, cvr = self.towers
    ctr_logits = self._head(ctr, x, 'ctr')
    cvr_logits = self._head(cvr, x, 'cvr')
    p_ctr, p_cvr = torch.sigmoid(ctr_logits), torch.sigmoid(cvr_logits)
    return {'logits_%s' % ctr.tower_name: ctr_logits,
            'probs_%s' % ctr.tower_name: p_ctr,
            'logits_%s' % cvr.tower_name: cvr_logits,
            'probs_%s' % cvr.tower_name: p_cvr,
            'probs_ctcvr': p_ctr * p_cvr}

  def metric_task_names(self) -> List[str]:
    # auc_ctr, the cvr AUC in the clicked space, and auc_ctcvr over all
    # impressions (reference esmm.py:58-98)
    return [t.tower_name for t in self.towers] + ['ctcvr']

  def build_loss(self, outputs, batch):
    weights = batch['sample_weight']
    ctr, cvr = self.towers
    ctr_label, cvr_label = self._label(batch, 0), self._label(batch, 1)
    ctr_loss = L.sigmoid_cross_entropy(
        ctr_label, outputs['logits_%s' % ctr.tower_name], weights)
    # ctcvr: cross entropy in probability space on p_ctr * p_cvr against
    # ctr_label * cvr_label
    ctcvr_label = ctr_label * cvr_label
    p = torch.clamp(outputs['probs_ctcvr'], 1e-7, 1 - 1e-7)
    per = -(ctcvr_label * torch.log(p) + (1 - ctcvr_label) * torch.log(1 - p))
    ctcvr_loss = torch.sum(per * weights) / torch.clamp(torch.sum(weights),
                                                        min=1e-9)
    total = ctr.weight * ctr_loss + cvr.weight * ctcvr_loss
    return total, {'ctr_loss': ctr_loss, 'ctcvr_loss': ctcvr_loss}

  def metric_inputs_per_task(self, outputs, batch):
    weights = batch['sample_weight']
    ctr, cvr = self.towers
    ctr_label, cvr_label = self._label(batch, 0), self._label(batch, 1)
    return {
        ctr.tower_name: self._metric(
            ctr_label, outputs['probs_%s' % ctr.tower_name], weights),
        # the cvr AUC in the clicked space
        cvr.tower_name: self._metric(
            cvr_label, outputs['probs_%s' % cvr.tower_name],
            weights * ctr_label),
        'ctcvr': self._metric(ctr_label * cvr_label, outputs['probs_ctcvr'],
                              weights),
    }


@register_model('DBMTL')
class DBMTL(MultiTaskModel):
  """reference: model/dbmtl.py. bottom_dnn over the first feature group
  (or over the multi-modal bottom_cmbf or bottom_uniter encoder of
  models/rank_extra.py, where the message sets one), an optional MMoE (its experts relu, as the JAX package builds them),
  then each tower's dnn; a tower with relation towers (those earlier in
  config order) or a relation_dnn concatenates its features with theirs
  into `<tower>_relation`."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, generator, device)
    cfg = ctx.model_config.dbmtl
    self.group = next(iter(ctx.groups))
    bottom = fusion_bottom(ctx, cfg, **self.kw)
    self.bottom_name = bottom[0] if bottom else None
    if bottom:
      self.add_module(*bottom)
      width = bottom[1].out_features
    else:
      width = build_group_input(self, ctx, self.group, **self.kw)
    if has_dnn(cfg, 'bottom_dnn'):
      self.bottom_dnn = DNN.from_config(cfg.bottom_dnn, width, **self.kw)
      width = self.bottom_dnn.out_features
    self.use_mmoe = int(cfg.num_expert) > 0
    if self.use_mmoe:
      self.mmoe = MMoELayer(width, len(self.towers), int(cfg.num_expert),
                            tuple(cfg.expert_dnn.hidden_units), **self.kw)
      width = self.mmoe.out_features
    widths: Dict[str, int] = {}
    self.relations = []
    for tower in self.towers:
      name = tower.tower_name
      w = width
      if has_dnn(tower, 'dnn'):
        dnn = DNN.from_config(tower.dnn, w, **self.kw)
        self.add_module('%s_dnn' % name, dnn)
        w = dnn.out_features
      rel = [r for r in tower.relation_tower_names if r in widths]
      concat = bool(rel) or has_dnn(tower, 'relation_dnn')
      if concat:
        w += sum(widths[r] for r in rel)
        if has_dnn(tower, 'relation_dnn'):
          dnn = DNN.from_config(tower.relation_dnn, w, **self.kw)
          self.add_module('%s_relation' % name, dnn)
          w = dnn.out_features
      self.relations.append((rel, concat))
      widths[name] = w
      self.add_module('%s_logits' % name,
                      Dense(w, max(int(tower.num_class), 1), **self.kw))

  def forward(self, batch, pulled):
    if self.bottom_name:
      x = getattr(self, self.bottom_name)(batch, pulled)
    else:
      x = group_input(self, self.ctx, pulled, batch, self.group)
    if hasattr(self, 'bottom_dnn'):
      x = self.bottom_dnn(x)
    feats = self.mmoe(x) if self.use_mmoe else [x] * len(self.towers)
    tower_feature: Dict[str, torch.Tensor] = {}
    out = {}
    for tower, feat, (rel, concat) in zip(self.towers, feats,
                                          self.relations):
      name = tower.tower_name
      h = feat
      if hasattr(self, '%s_dnn' % name):
        h = getattr(self, '%s_dnn' % name)(h)
      if concat:
        h = torch.cat([h] + [tower_feature[r] for r in rel], dim=1)
        if hasattr(self, '%s_relation' % name):
          h = getattr(self, '%s_relation' % name)(h)
      tower_feature[name] = h
      logits = getattr(self, '%s_logits' % name)(h)
      self._predict(out, tower, logits[:, 0] if logits.shape[1] == 1
                    else logits)
    return out


@register_model('PLE')
class PLE(MultiTaskModel):
  """reference: model/ple.py:13. CGC layers `cgc_<network_name or index>`
  in turn, the last without a shared output; each tower reads its task's
  output (expert_num_per_task and share_num of 0 read as 1; share_expert_net
  defaults to task_expert_net)."""

  def __init__(self, ctx: ModelContext, generator=None, device=None):
    super().__init__(ctx, generator, device)
    cfg = ctx.model_config.ple
    self.group = next(iter(ctx.groups))
    width = build_group_input(self, ctx, self.group, **self.kw)
    nets = list(cfg.extraction_networks)
    self.cgc_names = []
    task_widths, share_width = [width] * len(self.towers), width
    for li, net in enumerate(nets):
      task_units = tuple(net.task_expert_net.hidden_units)
      layer = CGCLayer(
          task_widths, share_width, int(net.expert_num_per_task) or 1,
          int(net.share_num) or 1, task_units,
          tuple(net.share_expert_net.hidden_units)
          if net.HasField('share_expert_net') else task_units,
          final_layer=li == len(nets) - 1, **self.kw)
      name = 'cgc_%s' % (net.network_name or str(li))
      self.add_module(name, layer)
      self.cgc_names.append(name)
      task_widths = [layer.out_features] * len(self.towers)
      share_width = layer.out_features
    for tower, w in zip(self.towers, task_widths):
      self._add_head(tower, w, tower.tower_name)

  def forward(self, batch, pulled):
    x = group_input(self, self.ctx, pulled, batch, self.group)
    task_inputs, shared = [x] * len(self.towers), x
    for name in self.cgc_names:
      task_inputs, shared = getattr(self, name)(task_inputs, shared)
    out = {}
    for tower, feat in zip(self.towers, task_inputs):
      self._predict(out, tower, self._head(tower, feat, tower.tower_name))
    return out
