"""RTP feature-generation (fg.json) bridge.

Counterpart of easyrec_tpu/utils/fg_util.py over the port's schema
messages: an RTP `fg.json` declares features by expression
("side:column"); convert_rtp_fg turns it into data_config input fields and
feature_config entries, and load_fg_json_to_config fills a pipeline config
from its fg_json_path (main.load_config calls it, as the JAX package's
main._load does). A relative fg_json_path opens relative to the working
directory, as in the JAX package.

The fg feature types: id_feature (is_multi or kv_separator make a
TagFeature), raw_feature (value_dimension, boundaries, normalizer),
combo_feature, lookup_feature and match_feature (both a LookupFeature of
inputs [key, map]), expr_feature, and sequence groups (sequence_name with
nested features, one SequenceFeature each, columns named
<sequence_name>__<column>).
"""

from __future__ import annotations

import json
import logging
from typing import List

from easyrec_torch.config.text_format import Message

MAX_HASH_BUCKET = 1 << 31

_FIELD_TYPES = {'string': 'STRING', 'float': 'FLOAT', 'double': 'DOUBLE',
                'integer': 'INT64', 'bigint': 'INT64', 'int64': 'INT64'}


def _expr_column(expression: str) -> str:
  """'user:uid' -> 'uid' (the input column name)."""
  return expression.split(':')[-1] if expression else ''


def _set_vocab(fg_feature: dict, fc: Message) -> None:
  if 'hash_bucket_size' in fg_feature:
    fc.hash_bucket_size = min(int(fg_feature['hash_bucket_size']),
                              MAX_HASH_BUCKET)
  elif 'vocab_list' in fg_feature:
    fc.vocab_list.extend(fg_feature['vocab_list'])
  elif 'vocab_file' in fg_feature:
    fc.vocab_file = fg_feature['vocab_file']
  elif 'num_buckets' in fg_feature:
    fc.num_buckets = int(fg_feature['num_buckets'])
  elif 'boundaries' in fg_feature:
    fc.boundaries.extend(float(b) for b in fg_feature['boundaries'])
  else:
    fc.hash_bucket_size = 100000


def _convert_one(fg_feature: dict, embedding_dim: int,
                 is_sequence: bool = False,
                 sequence_prefix: str = '') -> Message:
  fc = Message('FeatureConfig')
  ftype = fg_feature.get('feature_type', 'id_feature')
  expr = fg_feature.get('expression', '')
  expr_col = _expr_column(expr) if isinstance(expr, str) else ''
  name = fg_feature.get('feature_name') or expr_col
  column = sequence_prefix + (expr_col or name)
  fc.input_names.append(column)
  if sequence_prefix:
    fc.feature_name = sequence_prefix + name
  elif name != column:
    fc.feature_name = name
  dim = int(fg_feature.get('embedding_dimension',
                           fg_feature.get('embedding_dim', embedding_dim)))

  if is_sequence:
    fc.feature_type = 'SequenceFeature'
    fc.embedding_dim = dim
    if ftype == 'raw_feature':
      fc.sub_feature_type = 'RawFeature'
      if 'boundaries' in fg_feature:
        fc.boundaries.extend(float(b) for b in fg_feature['boundaries'])
    else:
      fc.sub_feature_type = 'IdFeature'
      _set_vocab(fg_feature, fc)
    return fc

  if ftype == 'id_feature':
    fc.feature_type = 'TagFeature' \
        if (fg_feature.get('is_multi') or fg_feature.get('kv_separator')) \
        else 'IdFeature'
    if fg_feature.get('kv_separator'):
      fc.kv_separator = fg_feature['kv_separator']
    fc.embedding_dim = dim
    _set_vocab(fg_feature, fc)
  elif ftype == 'raw_feature':
    fc.feature_type = 'RawFeature'
    fc.raw_input_dim = int(fg_feature.get('value_dimension', 1))
    if 'boundaries' in fg_feature:
      fc.boundaries.extend(float(b) for b in fg_feature['boundaries'])
      fc.embedding_dim = dim
    elif fg_feature.get('embedding_dimension') or \
        fg_feature.get('embedding_dim'):
      fc.embedding_dim = dim
    if 'normalizer' in fg_feature:
      fc.normalizer_fn = fg_feature['normalizer']
  elif ftype == 'combo_feature':
    fc.feature_type = 'ComboFeature'
    del fc.input_names[:]
    for e in fg_feature.get('expression', []):
      fc.input_names.append(_expr_column(e))
    fc.feature_name = name
    fc.embedding_dim = dim
    _set_vocab(fg_feature, fc)
  elif ftype in ('lookup_feature', 'match_feature'):
    fc.feature_type = 'LookupFeature'
    del fc.input_names[:]
    # the transform's inputs: [key, map]
    for key in ('key', 'map', 'user', 'item', 'category'):
      if key in fg_feature:
        fc.input_names.append(_expr_column(fg_feature[key]))
    if not fc.input_names:
      fc.input_names.append(column)
    fc.feature_name = name
    if fg_feature.get('needDiscrete', True) is False or \
        'boundaries' in fg_feature:
      fc.boundaries.extend(float(b)
                           for b in fg_feature.get('boundaries', []))
    fc.embedding_dim = dim
    _set_vocab(fg_feature, fc)
  elif ftype == 'expr_feature':
    fc.feature_type = 'ExprFeature'
    fc.expression = fg_feature.get('expression', '')
    del fc.input_names[:]
    for v in fg_feature.get('variables', []):
      fc.input_names.append(_expr_column(v))
    fc.feature_name = name
    if dim:
      fc.embedding_dim = dim
  else:
    raise ValueError('unsupported fg feature_type %r' % ftype)
  return fc


def convert_rtp_fg(fg: dict, embedding_dim: int = 16,
                   label_fields: List[str] = ()) -> dict:
  """fg.json dict -> {'feature_configs': [...], 'input_fields': [...],
  'label_fields': [...]}: FeatureConfig and Field messages, the labels
  first among the fields (FLOAT), each column once, in fg order."""
  feature_configs = []
  input_fields = []
  labels = list(fg.get('label_fields', label_fields))

  def _add_input(column: str, value_type: str = 'string'):
    if any(f.input_name == column for f in input_fields):
      return
    field = Message('Field')
    field.input_name = column
    field.input_type = _FIELD_TYPES.get(value_type.lower(), 'STRING')
    input_fields.append(field)

  for label in labels:
    _add_input(label, 'float')

  for fg_feature in fg.get('features', []):
    if 'sequence_name' in fg_feature:
      prefix = fg_feature['sequence_name'] + '__'
      for sub in fg_feature.get('features', []):
        fc = _convert_one(sub, embedding_dim, is_sequence=True,
                          sequence_prefix=prefix)
        if 'sequence_length' in fg_feature:
          fc.max_seq_len = int(fg_feature['sequence_length'])
        if 'sequence_delim' in fg_feature:
          fc.separator = fg_feature['sequence_delim']
        feature_configs.append(fc)
        for col in fc.input_names:
          _add_input(col)
    else:
      fc = _convert_one(fg_feature, embedding_dim)
      feature_configs.append(fc)
      vt = fg_feature.get('value_type', 'string')
      for col in fc.input_names:
        _add_input(col, vt if fc.feature_type == 'RawFeature'
                   else 'string')

  return {'feature_configs': feature_configs,
          'input_fields': input_fields, 'label_fields': labels}


def load_fg_json_to_config(pipeline_config: Message) -> None:
  """Fill the input fields, label fields and feature_config that the
  pipeline config leaves empty from its fg_json_path."""
  path = pipeline_config.fg_json_path
  if not path:
    return
  with open(path) as f:
    fg = json.load(f)
  converted = convert_rtp_fg(fg, label_fields=list(
      pipeline_config.data_config.label_fields))
  # an unset message field reads as a fresh message: set it back where
  # the fg adds to it
  dc = pipeline_config.data_config
  if not dc.input_fields and converted['input_fields']:
    dc.input_fields.extend(converted['input_fields'])
    pipeline_config.data_config = dc
  if not dc.label_fields and converted['label_fields']:
    dc.label_fields.extend(converted['label_fields'])
    pipeline_config.data_config = dc
  fc = pipeline_config.feature_config
  if not fc.features and converted['feature_configs']:
    fc.features.extend(converted['feature_configs'])
    pipeline_config.feature_config = fc
  logging.info('loaded %d features from fg json %s',
               len(converted['feature_configs']), path)
