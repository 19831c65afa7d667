"""Model base: context, registry and the rank-model loss/prediction.

Counterpart of easyrec_tpu/models/base.py: ModelContext (:29, with its
compute_dtype), build_context (:94), BaseModel (:125), RankModel (:160)
with its prediction by loss type (_prediction :180-214: sigmoid or, with
num_class > 1, softmax and the argmax `y`; JRC's softmax; ZILN's
probability and expected value; L2's raw `y`), every loss type of
_single_loss (:216-310, with _session :312), the model-level loss terms
(_loss_configs :325-339; build_loss :399-439 with the Uncertainty
weighting) and export_outputs (:449), the knowledge-distillation terms
(_kd_losses, :341-396, BaseModel.kd_losses here), and the _WithPrediction
wrapper of models/rank.py (:416-440), folded into RankModel.forward with
its `loss_uncertainty` parameter. A model's forward returns a dict of
outputs; a rank model's are `logits` and `probs` (and `y`), a
multi-task model's (models/multi_task.py) `logits_<tower>` and
`probs_<tower>`, and the trainer, export and serving read them through
build_loss, metric_inputs, metric_inputs_per_task and export_outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from easyrec_torch.config import schema
from easyrec_torch.features.embedding_layout import EmbeddingLayout
from easyrec_torch.layers.dnn import Stochastic
from easyrec_torch.losses import losses as L
from easyrec_torch.ops import embedding as emb_ops
from easyrec_torch.utils.registry import MODELS


@dataclasses.dataclass
class ModelContext:
  """Everything a model needs, precomputed from the pipeline config."""
  model_config: object                   # EasyRecModel message
  specs: Dict[str, object]               # feature name -> FeatureSpec
  layout: EmbeddingLayout
  label_fields: List[str]
  # train_config.compute_dtype: the DNN and MLP towers (and the match
  # towers) run in it; parameters and optimizer state stay f32
  compute_dtype: torch.dtype = torch.float32

  def __post_init__(self):
    self.input_layer = emb_ops.InputLayer(self.layout, self.specs)
    self.groups = {g.group_name: g for g in self.model_config.feature_groups}
    self.seq_att_groups = seq_att_groups(self.model_config)

  def group_features(self, name: str) -> List[str]:
    if name not in self.groups:
      raise KeyError('unknown feature group %r (have %s)' %
                     (name, sorted(self.groups)))
    return list(self.groups[name].feature_names)


def seq_att_groups(model_config) -> Dict[str, object]:
  """The seq_att groups by name, then the sequence_features sub-groups of
  the feature groups under their own name or their group's, where that
  name is not taken yet (JAX ModelContext.__post_init__, :37-43)."""
  groups = {g.group_name: g for g in model_config.seq_att_groups}
  for g in model_config.feature_groups:
    for sg in g.sequence_features:
      groups.setdefault(sg.group_name or g.group_name, sg)
  return groups


def _group_names(model_config, roles) -> List[str]:
  """Features of the groups in `roles`, then, for the deep role, the keys,
  histories and aux histories of the seq_att groups and sub-groups: the
  JAX package's order (ModelContext.deep_feature_names, :53), which fixes
  the fused tables' row offsets."""
  names = []
  for g in model_config.feature_groups:
    if g.wide_deep in roles:
      names.extend(g.feature_names)
  if 'DEEP' in roles:
    for g in seq_att_groups(model_config).values():
      for m in g.seq_att_map:
        names.extend(m.key)
        names.extend(m.hist_seq)
        names.extend(m.aux_hist_seq)
  return list(dict.fromkeys(names))


def wide_output_dim(model_config) -> int:
  """Wide embedding dim of the active model message, where it has one
  (DeepFM, WideAndDeep; default 1)."""
  which = model_config.WhichOneof('model')
  if which is None:
    return 1
  sub = getattr(model_config, which)
  if schema.has_field(sub.type_name, 'wide_output_dim'):
    return max(int(sub.wide_output_dim), 1)
  return 1


def compute_dtype(train_config) -> torch.dtype:
  """bfloat16 where train_config.compute_dtype says so, else float32."""
  return torch.bfloat16 if train_config.compute_dtype == 'bfloat16' \
      else torch.float32


def build_context(pipeline_config, specs,
                  dtype: torch.dtype = torch.float32) -> ModelContext:
  mc = pipeline_config.model_config
  deep = _group_names(mc, ('DEEP', 'WIDE_AND_DEEP'))
  wide = _group_names(mc, ('WIDE', 'WIDE_AND_DEEP'))
  layout = EmbeddingLayout(
      specs, deep_features=[f for f in deep if f in specs],
      wide_features=[f for f in wide if f in specs],
      wide_output_dim=wide_output_dim(mc))
  return ModelContext(model_config=mc, specs=specs, layout=layout,
                      label_fields=list(pipeline_config.data_config
                                        .label_fields),
                      compute_dtype=dtype)


class BaseModel(nn.Module):
  """One model family: forward(batch, pulled) -> {output: tensor}, its
  loss and its metric inputs.

  `flax_root` is the scope the JAX package's parameters of the model sit
  under: 'inner' for a rank model (its _WithPrediction wrapper), none for
  a multi-task model; convert.py and fine-tune restore name variables
  with it."""

  flax_root = 'inner'

  def __init__(self, ctx: ModelContext):
    super().__init__()
    self.ctx = ctx
    self.config = ctx.model_config

  def build_loss(self, outputs, batch) -> Tuple[torch.Tensor, Dict]:
    """(total loss, {name: loss}) of a batch."""
    raise NotImplementedError

  def metric_inputs(self, outputs, batch) -> Dict[str, torch.Tensor]:
    """labels, probs and weights of the headline metrics."""
    raise NotImplementedError

  def metric_task_names(self) -> List[str]:
    """The tasks evaluate() reports an `auc_<task>` for."""
    return []

  def metric_inputs_per_task(self, outputs, batch
                             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{task: metric inputs} of metric_task_names()."""
    return {}

  def export_outputs(self, outputs) -> Dict[str, torch.Tensor]:
    """The outputs an export serves."""
    raise NotImplementedError

  def kd_losses(self, outputs, batch) -> Dict[str, Tuple[torch.Tensor,
                                                          float]]:
    """{name: (value, weight)} of the model's kd terms (JAX RankModel
    ._kd_losses): the student's prediction `pred_name` (else `logits`)
    against the teacher's soft label field.<soft_label_name> (else
    label.<...>), both as logits (a probability turned into one unless
    *_is_logits), at the temperature t: the binary KL divergence of the
    t-softened probabilities times t^2, the L2 loss of the raw values, or
    (any other type) the sigmoid cross entropy of pred / t against the
    softened teacher times t^2; LISTWISE_DISTILL_LOSS takes the listwise
    rank loss of the softened teacher. A task-space indicator field weighs
    rows in and out of the space."""
    out = {}
    weights = batch['sample_weight']
    for i, kd in enumerate(self.config.kd):
      pred = outputs.get(kd.pred_name) if kd.pred_name else None
      if pred is None:
        pred = outputs['logits']
      soft_key = 'field.%s' % kd.soft_label_name
      if soft_key not in batch:
        soft_key = 'label.%s' % kd.soft_label_name
      soft = batch[soft_key]
      w = weights
      if kd.task_space_indicator_name:
        ind_key = 'field.%s' % kd.task_space_indicator_name
        if ind_key in batch:
          try:
            thr = float(kd.task_space_indicator_value)
          except ValueError:
            thr = 0.0
          in_space = (batch[ind_key] > thr).to(torch.float32)
          w = w * (kd.in_task_space_weight * in_space +
                   kd.out_task_space_weight * (1.0 - in_space))
      t = float(kd.temperature) or 1.0
      pred_l = pred if kd.pred_is_logits else _logit(pred)
      soft_l = soft if kd.label_is_logits else _logit(soft)
      if kd.loss_type == 'KL_DIVERGENCE_LOSS':
        p = torch.sigmoid(soft_l / t)
        q = torch.sigmoid(pred_l / t)
        kl = p * (_log_clip(p) - _log_clip(q)) + \
            (1 - p) * (_log_clip(1 - p) - _log_clip(1 - q))
        value = L.weighted_mean(kl, w) * t * t
      elif kd.loss_type == 'L2_LOSS':
        value = L.l2_loss(soft, pred, w)
      elif kd.loss_type == 'LISTWISE_DISTILL_LOSS':
        # the session field of the kd's loss_param where the batch
        # carries it (collect_extra_fields does not add it), else one
        # session for the batch; the listwise rank loss of the softened
        # teacher (JAX base.py:384-389)
        which = kd.WhichOneof('loss_param')
        sess = None
        if which:
          param = getattr(kd, which)
          if schema.has_field(param.type_name, 'session_name'):
            sess = batch.get('field.%s' % param.session_name)
        value = L.listwise_rank_loss(torch.sigmoid(soft_l / t), pred_l,
                                     sess if sess is not None else
                                     torch.zeros_like(w), w)
      else:
        value = L.sigmoid_cross_entropy(torch.sigmoid(soft_l / t),
                                        pred_l / t, w) * t * t
      out[kd.loss_name or 'kd_loss_%d' % i] = (
          value, float(kd.loss_weight) or 1.0)
    return out

  def add_kd(self, total, losses, outputs, batch):
    """total + weight x each kd term, the terms logged by name."""
    for name, (value, w) in self.kd_losses(outputs, batch).items():
      losses[name] = value
      total = total + w * value
    return total, losses


def _logit(p: torch.Tensor) -> torch.Tensor:
  p = torch.clamp(p, 1e-9, 1.0 - 1e-9)
  return torch.log(p) - torch.log1p(-p)


def _log_clip(p: torch.Tensor) -> torch.Tensor:
  return torch.log(torch.clamp(p, 1e-9, 1.0))


# the loss types whose prediction is a classification's: a sigmoid of one
# logit, or with num_class > 1 a softmax and its argmax `y` (JAX
# _prediction, :183-194)
CLASSIFICATION_TYPES = (
    'CLASSIFICATION', 'F1_REWEIGHTED_LOSS', 'BINARY_FOCAL_LOSS',
    'PAIR_WISE_LOSS', 'PAIRWISE_FOCAL_LOSS', 'PAIRWISE_LOGISTIC_LOSS',
    'PAIRWISE_HINGE_LOSS', 'BINARY_CROSS_ENTROPY_LOSS', 'CROSS_ENTROPY_LOSS',
    'LISTWISE_RANK_LOSS', 'LISTWISE_DISTILL_LOSS')


class RandomLossWeights(Stochastic):
  """`loss_weight_strategy: Random` (JAX models/rank.py:435-438, applied at
  models/base.py:433-436): softmax(normal(n)) * n, one weight a loss term.
  In training the normal draw comes from the generator set_generator gives
  the model (the trainer's); in eval from a fresh generator seeded
  EVAL_SEED on the batch's device. The JAX package draws from its dropout
  rng and from PRNGKey(0), which torch cannot draw: the weights scale the
  loss only, so predictions and metrics do not depend on them."""

  EVAL_SEED = 0

  def __init__(self, n_terms: int):
    super().__init__()
    self.n_terms = int(n_terms)

  def forward(self, device) -> torch.Tensor:
    gen = self.rng() if self.training else \
        torch.Generator(device=device).manual_seed(self.EVAL_SEED)
    z = torch.randn((self.n_terms,), generator=gen, device=device)
    return torch.softmax(z, dim=0) * self.n_terms


class RankModel(BaseModel):
  """Ranking base (binary, multi-class or regression): subclasses compute
  raw logits [B, logits_dim()] from (batch, pulled), or raw_outputs with
  more; forward adds the prediction of the model's loss_type.

  With `loss_weight_strategy: Uncertainty` and more than one loss term,
  the model holds `loss_uncertainty` (zeros, one per term), which flax
  keeps beside `inner`, not under it (convert.py maps it there), and
  forward passes it on as `uncertainty_w`. With `Random` and more than one
  term, forward passes on `random_loss_w`, a draw of RandomLossWeights."""

  def __init__(self, ctx: ModelContext, device=None):
    super().__init__(ctx)
    cfg = self.config
    n_terms = max(len(cfg.losses), 1) + len(cfg.kd)
    if n_terms > 1 and cfg.loss_weight_strategy == 'Uncertainty':
      self.loss_uncertainty = nn.Parameter(torch.zeros(n_terms,
                                                       device=device))
    if n_terms > 1 and cfg.loss_weight_strategy == 'Random':
      self.random_loss_weights = RandomLossWeights(n_terms)

  @property
  def label_name(self) -> str:
    return self.config.label_name or self.ctx.label_fields[0]

  @property
  def num_class(self) -> int:
    return max(int(self.config.num_class), 1)

  def logits_dim(self) -> int:
    """ZILN's 3 logits (class, mu, sigma), JRC's 2, else num_class."""
    lt = self.config.loss_type
    if lt == 'ZILN_LOSS':
      return 3
    if lt == 'JRC_LOSS':
      return 2
    return self.num_class

  def raw_logits(self, batch, pulled) -> torch.Tensor:
    raise NotImplementedError

  def raw_outputs(self, batch, pulled) -> Dict[str, object]:
    """{'raw_logits': [B, logits_dim()], and any other output}."""
    return {'raw_logits': self.raw_logits(batch, pulled)}

  def prediction(self, logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """logits, probs and y of the raw logits by loss_type (JAX
    _prediction)."""
    lt = self.config.loss_type
    out = {'logits': logits}
    squeezed = logits[..., 0] if logits.ndim > 1 else logits
    if lt in CLASSIFICATION_TYPES:
      if self.num_class == 1:
        out.update(logits=squeezed, probs=torch.sigmoid(squeezed))
      else:
        out.update(probs=torch.softmax(logits, dim=-1),
                   y=torch.argmax(logits, dim=-1))
    elif lt == 'JRC_LOSS':
      out['probs'] = torch.softmax(logits, dim=-1)[..., 1]
    elif lt == 'ZILN_LOSS':
      p = torch.sigmoid(logits[..., 0])
      sigma = torch.clamp(F.softplus(logits[..., 2]), max=5.0)
      out.update(probs=p, y=p * torch.exp(logits[..., 1] +
                                          0.5 * torch.square(sigma)))
    elif lt == 'L2_LOSS':
      out['y'] = squeezed
    elif lt == 'SIGMOID_L2_LOSS':
      out['y'] = torch.sigmoid(squeezed)
    else:
      out['probs'] = torch.sigmoid(squeezed)
    return out

  def forward(self, batch, pulled) -> Dict[str, torch.Tensor]:
    out = self.raw_outputs(batch, pulled)
    out.update(self.prediction(out.pop('raw_logits')))
    if hasattr(self, 'loss_uncertainty'):
      out['uncertainty_w'] = self.loss_uncertainty
    if hasattr(self, 'random_loss_weights'):
      out['random_loss_w'] = self.random_loss_weights(
          batch['sample_weight'].device)
    return out

  def _loss_configs(self) -> List[Dict]:
    """[{type, weight, params, learn, name}] of the model's loss terms:
    its `losses`, else its loss_type at weight 1."""
    out = []
    for loss in self.config.losses:
      which = loss.WhichOneof('loss_param')
      out.append({'type': loss.loss_type, 'weight': float(loss.weight),
                  'params': getattr(loss, which) if which else None,
                  'learn': bool(loss.learn_loss_weight),
                  'name': loss.loss_name or loss.loss_type})
    return out or [{'type': self.config.loss_type, 'weight': 1.0,
                    'params': None, 'learn': False,
                    'name': self.config.loss_type}]

  @staticmethod
  def session(batch, params, required: bool = False):
    """The session ids a loss names (`session_name`: field.<name>, else
    label.<name>); None where it names none, which a listwise or JRC loss
    refuses (JAX _session)."""
    name = params.session_name if params is not None and \
        schema.has_field(params.type_name, 'session_name') else ''
    for key in ('field.%s' % name, 'label.%s' % name) if name else ():
      if key in batch:
        return batch[key]
    if required:
      raise ValueError('loss requires session_name field in batch')
    return None

  def single_loss(self, cfg, labels, outputs, weights, batch
                  ) -> torch.Tensor:
    """One loss term of the model (JAX _single_loss, :216-310)."""
    lt, params = cfg['type'], cfg['params']
    logits = outputs['logits']
    if lt in ('CLASSIFICATION', 'BINARY_CROSS_ENTROPY_LOSS',
              'CROSS_ENTROPY_LOSS') and self.num_class > 1:
      return L.softmax_cross_entropy(labels, logits, weights)
    if lt == 'L2_LOSS':
      return L.l2_loss(labels, outputs.get('y', logits), weights)
    if lt == 'SIGMOID_L2_LOSS':
      return L.l2_loss(labels, outputs['y'], weights)
    if lt in L.PAIRWISE_LOSSES:
      return L.PAIRWISE_LOSSES[lt](labels, logits, weights,
                                   session_ids=self.session(batch, params),
                                   **L.pairwise_kwargs(lt, params))
    if lt == 'JRC_LOSS':
      return L.jrc_loss(labels, logits, self.session(batch, params, True),
                        weights,
                        alpha=params.alpha if params is not None else 0.5,
                        same_label_loss=params.same_label_loss
                        if params is not None else True)
    if lt == 'ZILN_LOSS':
      kw = {}
      if params is not None:
        kw = dict(max_sigma=params.max_sigma,
                  max_log_clip_value=params.max_log_clip_value,
                  classification_weight=params.classification_weight,
                  regression_weight=params.regression_weight,
                  mu_regularization=params.mu_regularization,
                  sigma_regularization=params.sigma_regularization)
      return L.ziln_loss(labels, logits, weights, **kw)
    if lt == 'LISTWISE_RANK_LOSS':
      kw = dict(temperature=params.temperature,
                label_is_logits=params.label_is_logits,
                transform_fn=params.transform_fn) \
          if params is not None else {}
      return L.listwise_rank_loss(labels, logits,
                                  self.session(batch, params, True),
                                  weights, **kw)
    if lt == 'LISTWISE_DISTILL_LOSS':
      kw = dict(temperature=params.temperature,
                label_clip_max_value=params.label_clip_max_value,
                transform_fn=params.transform_fn) \
          if params is not None else {}
      return L.listwise_distill_loss(labels, logits,
                                     self.session(batch, params, True),
                                     weights, **kw)
    # a classification model's binary terms
    return L.loss_by_type(lt, params, labels, logits, weights)

  def build_loss(self, outputs, batch) -> Tuple[torch.Tensor, Dict]:
    """The weighted sum of the loss terms; under Uncertainty each learned
    term is exp(-u) * L + u / 2 (its exp(-u) halved for L2), and where
    some term sets learn_loss_weight only those are learned, the rest
    keep their fixed weight."""
    labels = batch['label.%s' % self.label_name]
    weights = batch['sample_weight']
    losses, terms = {}, []
    for cfg in self._loss_configs():
      value = self.single_loss(cfg, labels, outputs, weights, batch)
      losses[cfg['name']] = value
      terms.append((value, cfg))
    for name, (value, w) in self.kd_losses(outputs, batch).items():
      losses[name] = value
      terms.append((value, {'type': None, 'weight': w, 'learn': False}))
    rw = outputs.get('random_loss_w')
    if rw is not None:
      return sum(rw[i] * v for i, (v, _) in enumerate(terms)), losses
    u = outputs.get('uncertainty_w')
    if u is None:
      return sum(cfg['weight'] * v for v, cfg in terms), losses
    explicit = any(cfg['learn'] for _, cfg in terms)
    total = 0.0
    for i, (value, cfg) in enumerate(terms):
      if explicit and not cfg['learn']:
        total = total + cfg['weight'] * value
        continue
      scale = 0.5 if cfg['type'] in ('L2_LOSS', 'SIGMOID_L2_LOSS') else 1.0
      total = total + scale * torch.exp(-u[i]) * value + 0.5 * u[i]
    return total, losses

  def metric_inputs(self, outputs, batch) -> Dict[str, torch.Tensor]:
    return {'labels': batch['label.%s' % self.label_name],
            'probs': outputs.get('probs'),
            'preds': outputs.get('y', outputs.get('probs')),
            'weights': batch['sample_weight']}

  def export_outputs(self, outputs) -> Dict[str, torch.Tensor]:
    """The serving outputs (JAX models/base.py:449-457): probs, y and
    logits, those present."""
    return {k: outputs[k] for k in ('probs', 'y', 'logits') if k in outputs}


def register_model(name: str):
  return MODELS.register(name)


def create_model(ctx: ModelContext, generator=None, device=None) -> BaseModel:
  name = ctx.model_config.model_class
  if name not in MODELS:
    raise NotImplementedError('model_class %r is not ported' % name)
  return MODELS.get(name)(ctx, generator=generator, device=device)
