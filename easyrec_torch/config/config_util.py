"""Pipeline-config loading for the port.

Counterpart of easyrec_tpu/config/config_util.py: text-format load with the
same automatic expansions (shared feature names, `name[1-3]` input-field and
group-name ranges), plain dotted-path edits, and the train/eval input paths.
Configs come back as `text_format.Message` trees; `check_ported` raises
NotImplementedError, naming the field, for anything the port does not run.
"""

from __future__ import annotations

import glob as _glob
import logging
import re
from typing import Dict, List, Optional, Union

from easyrec_torch.config import schema
from easyrec_torch.config.text_format import Message, parse

EasyRecConfig = Message

_PORTED_MODELS = ('DeepFM', 'MultiTower', 'MultiTowerDIN')
_PORTED_FEATURE_TYPES = ('IdFeature', 'RawFeature', 'SequenceFeature')
_PORTED_INPUT_TYPES = ('CSVInput', 'CSVInputV2', 'CSVInputEx', 'DummyInput')


def get_configs_from_pipeline_file(path: str,
                                   auto_expand: bool = True) -> Message:
  """Load an EasyRecConfig from a text-format config file."""
  if path.endswith('.json'):
    raise NotImplementedError('json pipeline configs are not ported: %s'
                              % path)
  with open(path, 'r') as f:
    return get_configs_from_pipeline_str(f.read(), auto_expand)


def get_configs_from_pipeline_str(content: str,
                                  auto_expand: bool = True) -> Message:
  """Parse an EasyRecConfig from a text-format string."""
  config = parse(content, 'EasyRecConfig')
  if auto_expand:
    auto_expand_share_feature_configs(config)
    auto_expand_input_fields(config)
    auto_expand_group_feature_names(config)
  return config


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


def edit_config(config: Message, edits: Dict[str, object]) -> Message:
  """Apply plain dotted-path edits, e.g. {'train_config.num_steps': 100}."""
  for path, value in edits.items():
    parts = path.split('.')
    target = config
    for part in parts[:-1]:
      if '[' in part:
        raise NotImplementedError('config edit selectors are not ported: %s'
                                  % path)
      child = getattr(target, part)
      setattr(target, part, child)    # materialise an unset sub-message
      target = child
    setattr(target, parts[-1], value)
  return config


def get_train_input_path(config: Message) -> Optional[str]:
  return _input_path(config, 'train_path')


def get_eval_input_path(config: Message) -> Optional[str]:
  return _input_path(config, 'eval_path')


def _input_path(config: Message, oneof: str) -> Optional[str]:
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


def check_ported(config: Message) -> None:
  """Raise NotImplementedError naming the first part of `config` that the
  port does not run: an unported field, model class, feature type, input
  type, loss or compute dtype."""
  for where in _unported_fields(config, ''):
    raise NotImplementedError('config field %s is not ported' % where)
  mc = config.model_config
  if mc.model_class not in _PORTED_MODELS:
    raise NotImplementedError('model_class %r is not ported (ported: %s)'
                              % (mc.model_class, ', '.join(_PORTED_MODELS)))
  if mc.loss_type != 'CLASSIFICATION' or mc.num_class != 1:
    raise NotImplementedError('loss_type %s with num_class %d is not ported'
                              % (mc.loss_type, mc.num_class))
  for fc in get_feature_configs(config):
    if fc.feature_type not in _PORTED_FEATURE_TYPES:
      raise NotImplementedError('feature_type %s (feature %s) is not ported'
                                % (fc.feature_type,
                                   fc.feature_name or fc.input_names[0]))
  it = config.data_config.input_type
  if it not in _PORTED_INPUT_TYPES:
    raise NotImplementedError('input_type %s is not ported' % it)
  if config.train_config.compute_dtype != 'float32':
    raise NotImplementedError('compute_dtype %s is not ported'
                              % config.train_config.compute_dtype)
