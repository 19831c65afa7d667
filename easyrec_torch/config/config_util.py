"""Pipeline-config loading for the port.

Counterpart of easyrec_tpu/config/config_util.py: text-format load with the
same automatic expansions (shared feature names, `name[1-3]` input-field and
group-name ranges), plain dotted-path edits, the train/eval input paths, and
save_pipeline_config, which writes a config back in text format. Configs
come back as `text_format.Message` trees; `check_ported` raises
NotImplementedError, naming the field, for anything the port does not run.
"""

from __future__ import annotations

import glob as _glob
import json
import logging
import os
import re
from typing import Dict, List, Optional, Union

from easyrec_torch.config import schema
from easyrec_torch.config.text_format import Message, parse, to_text

EasyRecConfig = Message

_RANK_MODELS = ('DeepFM', 'MultiTower', 'MultiTowerDIN', 'MultiTowerBST',
                'WideAndDeep', 'DCN', 'AutoInt', 'DLRM', 'FM',
                'RocketLaunching', 'CMBF', 'Uniter', 'RankModel',
                'DummyModel')
_MULTI_TASK_MODELS = ('SimpleMultiTask', 'MMoE', 'ESMM', 'DBMTL', 'PLE',
                      'MultiTaskModel')
# the match family (models/match.py, match_extra.py, and the backbone's
# MatchModel)
_MATCH_MODELS = ('DSSM', 'DSSM_SENet', 'DAT', 'MIND', 'MultiTowerRecall',
                 'DropoutNet', 'PDN', 'CoMetricLearningI2I', 'MatchModel')
# the models a backbone DSL builds (models/backbone_model.py)
_BACKBONE_MODELS = ('RankModel', 'MultiTaskModel', 'MatchModel')
_PORTED_MODELS = _RANK_MODELS + _MULTI_TASK_MODELS + _MATCH_MODELS
# a match model's loss_type: the in-batch softmax (listwise), the
# pointwise sigmoid cross entropy, or DSSM_reg's L2 on the similarity
# (JAX MatchModel.build_loss)
_MATCH_LOSSES = ('SOFTMAX_CROSS_ENTROPY', 'CLASSIFICATION', 'L2_LOSS')
# the loss types a task tower computes as the JAX package's
# MultiTaskModel._tower_loss does; it falls back to cross entropy for any
# other, which the port refuses instead
_TOWER_LOSSES = ('CLASSIFICATION', 'CROSS_ENTROPY_LOSS',
                 'BINARY_CROSS_ENTROPY_LOSS', 'SOFTMAX_CROSS_ENTROPY',
                 'L2_LOSS', 'SIGMOID_L2_LOSS', 'BINARY_FOCAL_LOSS',
                 'F1_REWEIGHTED_LOSS', 'ORDER_CALIBRATE_LOSS')
# a rank model's loss_type: the JAX package's RankModel predicts and
# computes each (base.py:180-310); the softmax types take num_class > 1,
# ZILN and JRC make 3 and 2 logits whatever num_class says
_RANK_MODEL_LOSSES = ('CLASSIFICATION', 'CROSS_ENTROPY_LOSS',
                      'BINARY_CROSS_ENTROPY_LOSS', 'L2_LOSS',
                      'SIGMOID_L2_LOSS', 'BINARY_FOCAL_LOSS',
                      'F1_REWEIGHTED_LOSS', 'PAIR_WISE_LOSS',
                      'PAIRWISE_FOCAL_LOSS', 'PAIRWISE_LOGISTIC_LOSS',
                      'PAIRWISE_HINGE_LOSS', 'JRC_LOSS', 'ZILN_LOSS',
                      'LISTWISE_RANK_LOSS', 'LISTWISE_DISTILL_LOSS')
_MULTI_CLASS_LOSSES = ('CLASSIFICATION', 'CROSS_ENTROPY_LOSS',
                       'BINARY_CROSS_ENTROPY_LOSS', 'JRC_LOSS', 'ZILN_LOSS')
# the types of a rank model's `losses` terms that the JAX package's
# RankModel._single_loss computes on a model of one logit. SIGMOID_L2_LOSS
# reads the prediction `y` that only a SIGMOID_L2_LOSS model makes, so the
# JAX package raises a KeyError on it under classification; JRC and ZILN
# index the 2 and 3 logits that only a model of that loss_type makes
_RANK_LOSSES = ('CLASSIFICATION', 'CROSS_ENTROPY_LOSS',
                'BINARY_CROSS_ENTROPY_LOSS', 'L2_LOSS', 'BINARY_FOCAL_LOSS',
                'F1_REWEIGHTED_LOSS', 'PAIR_WISE_LOSS', 'PAIRWISE_FOCAL_LOSS',
                'PAIRWISE_LOGISTIC_LOSS', 'PAIRWISE_HINGE_LOSS',
                'LISTWISE_RANK_LOSS', 'LISTWISE_DISTILL_LOSS')
_PORTED_FEATURE_TYPES = ('IdFeature', 'RawFeature', 'TagFeature',
                         'ComboFeature', 'LookupFeature', 'SequenceFeature',
                         'ExprFeature', 'PassThroughFeature')
_PORTED_INPUT_TYPES = ('CSVInput', 'CSVInputV2', 'CSVInputEx', 'DummyInput',
                       'TFRecordInput', 'BatchTFRecordInput', 'RTPInput',
                       'RTPInputV2', 'OdpsRTPInput', 'OdpsRTPInputV2',
                       'CriteoInput', 'KafkaInput', 'DataHubInput',
                       'HiveInput', 'HiveRTPInput', 'OdpsInput',
                       'OdpsInputV2', 'OdpsInputV3', 'ParquetInput',
                       'ParquetInputV2', 'ParquetInputV3',
                       'HiveParquetInput')


def get_configs_from_pipeline_file(path: str,
                                   auto_expand: bool = True) -> Message:
  """Load an EasyRecConfig from a text-format config file, or from
  protobuf's JSON form where the path ends in .json (config/json_format.py;
  unknown fields dropped)."""
  with open(path, 'r', encoding='utf-8') as f:
    content = f.read()
  if path.endswith('.json'):
    from easyrec_torch.config import json_format
    config = json_format.parse(content, 'EasyRecConfig')
    if auto_expand:
      _auto_expand(config)
    return config
  return get_configs_from_pipeline_str(content, auto_expand)


def get_configs_from_pipeline_str(content: str,
                                  auto_expand: bool = True) -> Message:
  """Parse an EasyRecConfig from a text-format string."""
  config = parse(content, 'EasyRecConfig')
  if auto_expand:
    _auto_expand(config)
  return config


def _auto_expand(config: Message) -> None:
  auto_expand_share_feature_configs(config)
  auto_expand_input_fields(config)
  auto_expand_group_feature_names(config)


def save_pipeline_config(config: Message, directory: str,
                         filename: str = 'pipeline.config') -> str:
  """Write `config` in text format as directory/filename (the JAX
  package's save_pipeline_config, config_util.py:63-72); returns the
  path."""
  os.makedirs(directory, exist_ok=True)
  path = os.path.join(directory, filename)
  with open(path, 'w', encoding='utf-8') as f:
    f.write(to_text(config))
  return path


def get_feature_configs(config: Message) -> List[Message]:
  """The feature config list (nested or legacy flat form)."""
  if config.feature_config.features:
    return list(config.feature_config.features)
  return list(config.feature_configs)


_RANGE_RE = re.compile(r'^(.*)\[(\d+)-(\d+)\](.*)$')


def _expand_range(name: str) -> List[str]:
  m = _RANGE_RE.match(name)
  if not m:
    return [name]
  prefix, lo, hi, suffix = m.group(1), int(m.group(2)), int(m.group(3)), \
      m.group(4)
  return ['%s%d%s' % (prefix, i, suffix) for i in range(lo, hi + 1)]


def auto_expand_share_feature_configs(config: Message) -> None:
  """Each name in FeatureConfig.shared_names becomes its own feature config
  that shares the embedding via embedding_name."""
  for fc_list in (config.feature_configs, config.feature_config.features):
    extra = []
    for fc in fc_list:
      if not fc.shared_names:
        continue
      shared = []
      for name in fc.shared_names:
        shared.extend(_expand_range(name))
      if fc.embedding_dim > 0 and not fc.embedding_name:
        base = fc.feature_name or fc.input_names[0]
        fc.embedding_name = base + '_shared_embedding'
      for name in shared:
        clone = fc.copy()
        clone.ClearField('shared_names')
        clone.ClearField('feature_name')
        clone.input_names = [name]
        extra.append(clone)
      fc.ClearField('shared_names')
    fc_list.extend(extra)


def auto_expand_group_feature_names(config: Message) -> None:
  """Expand `name[1-3]` ranges inside feature_groups.feature_names."""
  for group in config.model_config.feature_groups:
    if not any(_RANGE_RE.match(n) for n in group.feature_names):
      continue
    names = []
    for n in group.feature_names:
      names.extend(_expand_range(n))
    group.feature_names = names


def auto_expand_input_fields(config: Message) -> None:
  """Expand input field name ranges like f[1-10] when enabled."""
  dc = config.data_config
  if not dc.auto_expand_input_fields:
    return
  fields = []
  for field in dc.input_fields:
    for name in _expand_range(field.input_name):
      clone = field.copy()
      clone.input_name = name
      fields.append(clone)
  dc.input_fields = fields
  dc.auto_expand_input_fields = False


_SELECTOR_RE = re.compile(r'^(?P<name>\w+)\[(?P<cond>.+)\]$')


def edit_config(config: Message,
                edits: Union[str, Dict[str, object]]) -> Message:
  """Apply dotted-path edits (a dict, or its JSON text), as the JAX
  package's edit_config (config_util.py:167-297):
    plain paths        train_config.num_steps: 100
    a list index       feature_configs[0].embedding_dim: 32
    an index range     feature_configs[0:2].embedding_dim: 32
    a field predicate  feature_configs[input_names[0]=c1].embedding_dim: 32
    a comparison       feature_configs[embedding_dim>=16].combiner: mean
  A value for a repeated field is a list, a JSON list's text or a comma
  list; for a message, its text format or a dict of its JSON form; enum
  values go by name."""
  if isinstance(edits, str):
    edits = json.loads(edits)
  for path, value in edits.items():
    _apply_edit(config, path.split('.'), value)
  return config


def _apply_edit(msg: Message, parts: List[str], value) -> None:
  targets = [msg]
  for i, part in enumerate(parts):
    last = i == len(parts) - 1
    nxt = []
    for target in targets:
      sel = _SELECTOR_RE.match(part)
      if sel:
        if last:
          raise ValueError('cannot assign directly to selector %s' % part)
        nxt.extend(_select(getattr(target, sel.group('name')),
                           sel.group('cond')))
      elif last:
        _set_field(target, part, value)
      else:
        child = getattr(target, part)
        setattr(target, part, child)    # materialise an unset sub-message
        nxt.append(child)
    targets = nxt


def _select(repeated: list, cond: str) -> list:
  if re.match(r'^\d+$', cond):
    return [repeated[int(cond)]]
  m = re.match(r'^(\d*):(\d*)$', cond)
  if m:
    lo = int(m.group(1)) if m.group(1) else 0
    hi = int(m.group(2)) if m.group(2) else len(repeated)
    return list(repeated[lo:hi])
  m = re.match(r'^([\w\[\]]+)\s*(>=|<=|!=|=|>|<)\s*(.*)$', cond)
  if not m:
    raise ValueError('bad selector condition: %s' % cond)
  fexpr, op, raw = m.group(1), m.group(2), m.group(3)
  out = []
  for item in repeated:
    sel = _SELECTOR_RE.match(fexpr)
    val = getattr(item, sel.group('name'))[int(sel.group('cond'))] \
        if sel else getattr(item, fexpr)
    ref = _convert_type(raw, type(val)) if val is not None else raw
    if _CMP[op](val, ref):
      out.append(item)
  return out


_CMP = {'=': lambda a, b: a == b, '!=': lambda a, b: a != b,
        '>': lambda a, b: a > b, '<': lambda a, b: a < b,
        '>=': lambda a, b: a >= b, '<=': lambda a, b: a <= b}


def _convert_type(raw, target_type):
  if target_type is bool:
    if isinstance(raw, str):
      return raw.strip().lower() in ('true', '1', 'yes')
    return bool(raw)
  try:
    return target_type(raw)
  except (TypeError, ValueError):
    return raw


_PY_TYPES = {'int': int, 'int64': int, 'float': float, 'double': float,
             'bool': bool}


def _message_value(type_name: str, value) -> Message:
  if isinstance(value, Message):
    return value
  if isinstance(value, dict):
    from easyrec_torch.config import json_format
    return json_format.parse_dict(value, type_name)
  if isinstance(value, str):
    return parse(value, type_name)
  raise ValueError('cannot assign %r to a %s message' % (value, type_name))


def _merge(dst: Message, src: Message) -> None:
  """src's set fields into dst, as protobuf's text and JSON parsers merge
  into a message: repeated fields appended, the rest set."""
  for spec in schema.MESSAGES[src.type_name]:
    if spec.name not in src._values:
      continue
    if spec.repeated:
      getattr(dst, spec.name).extend(src._values[spec.name])
    else:
      setattr(dst, spec.name, src._values[spec.name])


def _set_field(target: Message, name: str, value) -> None:
  spec = schema.field(target.type_name, name)
  if spec.repeated:
    if isinstance(value, str):
      value = json.loads(value) if value.strip().startswith('[') \
          else value.split(',')
    if not isinstance(value, (list, tuple)):
      value = [value]
    if spec.message_type:
      setattr(target, name, [_message_value(spec.message_type, v)
                             for v in value])
    else:
      py_type = _PY_TYPES.get(spec.kind, str)
      setattr(target, name, [_convert_type(v, py_type) for v in value])
  elif spec.message_type and isinstance(value, Message):
    setattr(target, name, value)
  elif spec.message_type:
    child = getattr(target, name)
    _merge(child, _message_value(spec.message_type, value))
    setattr(target, name, child)
  elif spec.enum_type or spec.kind == 'string':
    setattr(target, name, value)
  else:
    setattr(target, name,
            _convert_type(value, _PY_TYPES.get(spec.kind, str)))


def get_train_input_path(config: Message) -> Union[str, Message, None]:
  """The train_path oneof's value (JAX config_util.py:322-330): a path
  string for file inputs, the KafkaServer, DatahubServer or HiveConfig
  message for a streaming or warehouse input."""
  return _input_path(config, 'train_path')


def get_eval_input_path(config: Message) -> Union[str, Message, None]:
  """The eval_path oneof's value, as get_train_input_path."""
  return _input_path(config, 'eval_path')


def _input_path(config: Message, oneof: str):
  which = config.WhichOneof(oneof)
  if which is None:
    return None
  if schema.field('EasyRecConfig', which).kind == 'unported':
    raise NotImplementedError('input source %s is not ported' % which)
  return getattr(config, which)


def expand_input_paths(pattern: Union[str, list]) -> list:
  """Expand comma-separated path patterns with glob (incl `**`)."""
  patterns = [p for p in pattern.split(',') if p] \
      if isinstance(pattern, str) else list(pattern)
  paths = []
  for p in patterns:
    if any(ch in p for ch in '*?['):
      matched = sorted(_glob.glob(p, recursive=True))
      if not matched:
        logging.warning('input pattern %s matched no files', p)
      paths.extend(matched)
    else:
      paths.append(p)
  return paths


def _unported_fields(msg: Message, path: str):
  for spec in schema.MESSAGES[msg.type_name]:
    if spec.name not in msg._values:
      continue
    value = msg._values[spec.name]
    if spec.repeated and not value:
      continue          # reading a repeated field leaves an empty list
    where = '%s.%s' % (path, spec.name) if path else spec.name
    if spec.kind == 'unported':
      yield where
    elif spec.message_type:
      for i, sub in enumerate(value if spec.repeated else [value]):
        yield from _unported_fields(
            sub, '%s[%d]' % (where, i) if spec.repeated else where)


def task_towers(model_config: Message) -> List[Message]:
  """The task towers of a multi-task model message, in config order
  (ESMM's ctr_tower, then cvr_tower)."""
  which = model_config.WhichOneof('model')
  if which == 'esmm':
    return [model_config.esmm.ctr_tower, model_config.esmm.cvr_tower]
  return list(getattr(model_config, which).task_towers) if which else []


def _keras_layers(backbone: Message):
  """(where, KerasLayer) of every keras layer of a backbone."""
  pkgs = [('packages[%d]' % i, p) for i, p in enumerate(backbone.packages)]
  for scope, pkg in [('', backbone)] + pkgs:
    for bi, block in enumerate(pkg.blocks):
      where = '%sblocks[%d]' % (scope + '.' if scope else '', bi)
      layers = [(where + '.layers[%d]' % li, lp)
                for li, lp in enumerate(block.layers)] + [(where, block)]
      for lw, holder in layers:
        which = holder.WhichOneof('layer')
        if which == 'keras_layer':
          yield lw, holder.keras_layer
        elif which in ('recurrent', 'repeat'):
          yield lw, getattr(holder, which).keras_layer


def process_neg_sampler_data_path(config: Message) -> None:
  """Strip the negative sampler's input paths (JAX config_util.py
  :365-376)."""
  dc = config.data_config
  which = dc.WhichOneof('sampler')
  if not which:
    return
  sampler = getattr(dc, which)
  for name in ('input_path', 'user_input_path', 'item_input_path',
               'pos_edge_input_path', 'hard_neg_edge_input_path'):
    if schema.has_field(sampler.type_name, name) and getattr(sampler, name):
      setattr(sampler, name, getattr(sampler, name).strip())


def collect_extra_fields(config: Message) -> List[str]:
  """Input fields that ride along in batches as numeric 'field.<name>'
  columns (JAX config_util.py:379-427): the grouped metrics' ids (gauc's
  uid_field, session_auc's session_id_field, of the eval config and the
  task towers), the rank losses' session_name fields, the kd terms'
  prediction, soft label and task-space indicator fields, and the
  metric-learning model's session_id and sample_id; names that are
  labels (those flow as label.<name>) are dropped."""
  fields = []

  def _add(name):
    if name and name not in fields:
      fields.append(name)

  def _metric_fields(metrics_set):
    for m in metrics_set:
      which = m.WhichOneof('metric')
      if which == 'gauc':
        _add(m.gauc.uid_field)
      elif which == 'session_auc':
        _add(m.session_auc.session_id_field)

  _metric_fields(config.eval_config.metrics_set)
  mc = config.model_config
  for loss in mc.losses:
    which = loss.WhichOneof('loss_param')
    if which is not None:
      params = getattr(loss, which)
      if schema.has_field(params.type_name, 'session_name'):
        _add(params.session_name)
  for kd in mc.kd:
    _add(kd.pred_name)
    _add(kd.soft_label_name)
    _add(kd.task_space_indicator_name)
  which = mc.WhichOneof('model')
  if which is not None:
    sub = getattr(mc, which)
    if schema.has_field(sub.type_name, 'task_towers'):
      for tower in sub.task_towers:
        _metric_fields(tower.metrics_set)
    for name in ('session_id', 'sample_id'):
      if schema.has_field(sub.type_name, name):
        _add(getattr(sub, name))
  labels = set(config.data_config.label_fields)
  return [f for f in fields if f not in labels]


def check_ported(config: Message) -> None:
  """Raise NotImplementedError naming the first part of `config` that the
  port does not run: an unported field, model class, backbone layer,
  feature type, input type, loss or compute dtype."""
  mc = config.model_config
  if mc.model_class not in _PORTED_MODELS:
    raise NotImplementedError('model_class %r is not ported (ported: %s)'
                              % (mc.model_class, ', '.join(_PORTED_MODELS)))
  for where in _unported_fields(config, ''):
    raise NotImplementedError('config field %s is not ported' % where)
  if mc.model_class in _BACKBONE_MODELS:
    if not mc.HasField('backbone'):
      raise ValueError('model_class %s needs a backbone' % mc.model_class)
    from easyrec_torch.layers.keras_registry import has_layer
    for where, layer in _keras_layers(mc.backbone):
      if not has_layer(layer.class_name):
        raise NotImplementedError(
            'keras layer class %r (model_config.backbone.%s) is not ported'
            % (layer.class_name, where))
  if mc.kd and mc.model_class in _MULTI_TASK_MODELS:
    raise NotImplementedError('model_config.kd of a multi-task model is not '
                              'ported (the JAX package adds no kd term to '
                              'its loss)')
  if mc.model_class in _MATCH_MODELS:
    if mc.loss_type not in _MATCH_LOSSES or mc.num_class != 1:
      raise NotImplementedError('loss_type %s with num_class %d of a match '
                                'model is not ported'
                                % (mc.loss_type, mc.num_class))
    if mc.losses:
      # the JAX match models read loss_type only
      raise NotImplementedError('model_config.losses of a match model is '
                                'not ported')
  elif mc.model_class in _MULTI_TASK_MODELS:
    for tower in task_towers(mc):
      for lt in [tower.loss_type] + [l.loss_type for l in tower.losses]:
        if lt not in _TOWER_LOSSES:
          raise NotImplementedError('loss_type %s of task tower %s is not '
                                    'ported' % (lt, tower.tower_name))
  else:
    if mc.loss_type not in _RANK_MODEL_LOSSES or (
        mc.num_class != 1 and mc.loss_type not in _MULTI_CLASS_LOSSES):
      raise NotImplementedError('loss_type %s with num_class %d is not '
                                'ported' % (mc.loss_type, mc.num_class))
    for i, loss in enumerate(mc.losses):
      if loss.loss_type not in _RANK_LOSSES or mc.loss_type in (
          'JRC_LOSS', 'ZILN_LOSS') or (mc.num_class != 1 and
                                       loss.loss_type not in
                                       _MULTI_CLASS_LOSSES):
        # a term on logits of another shape than it reads: the JAX
        # package fails on it
        raise NotImplementedError('loss_type %s of model_config.losses[%d] '
                                  'is not ported' % (loss.loss_type, i))
  for fc in get_feature_configs(config):
    if fc.feature_type not in _PORTED_FEATURE_TYPES:
      raise NotImplementedError('feature_type %s (feature %s) is not ported'
                                % (fc.feature_type,
                                   fc.feature_name or fc.input_names[0]))
  it = config.data_config.input_type
  if it not in _PORTED_INPUT_TYPES:
    raise NotImplementedError('input_type %s is not ported' % it)
  if config.train_config.compute_dtype not in ('float32', 'bfloat16'):
    raise NotImplementedError('compute_dtype %s is not ported'
                              % config.train_config.compute_dtype)
