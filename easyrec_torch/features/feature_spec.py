"""Feature specs: the static contract between the host feature pipeline and
the embedding engine.

Counterpart of easyrec_tpu/features/feature_spec.py:33-225. Every feature
packs into static shapes:
  categorical -> ids[B, K] int32 + weights[B, K] f32   (K = packing width)
  dense       -> dense[B, D] f32
  sequence    -> ids[B, L] int32 + mask[B, L] f32       (L = max_seq_len)
                 or, numeric, dense[B, L, N] f32 + mask[B, L] f32
A RawFeature with an embedding becomes a weighted-id lookup (ids = iota,
weights = values); a TagFeature is K = max_multi_len weighted ids, zero
weight on padding. Every feature type of the JAX package has a spec:
IdFeature, TagFeature, RawFeature, ExprFeature, LookupFeature (the
raw-projection form, and the kv-map form where an id scheme or an explicit
lookup_max_sel_elem_num is set), ComboFeature (K = max_multi_len, 8 by
default, crosses under combo_input_seps), SequenceFeature (ids,
boundary-bucketed values or numeric values) and PassThroughFeature.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# default packing width for multi-value (tag) features
DEFAULT_MAX_TAG_LEN = 16
DEFAULT_MAX_SEQ_LEN = 50


@dataclasses.dataclass
class FeatureSpec:
  """Static description of one transformed feature."""
  name: str                      # feature_name or input_names[0]
  kind: str                      # categorical | dense | sequence
  num_ids: int = 1               # K (packing width) or L (max_seq_len)
  table_name: str = ''           # embedding table identity
  rows: int = 0                  # vocab rows of the table
  embedding_dim: int = 0
  combiner: str = 'sum'
  value_dim: int = 1             # D of a dense feature
  is_weighted: bool = False      # raw-as-embedding: weights carry values
  seq_is_dense: bool = False     # numeric sequence: values, not ids
  config: Optional[object] = None   # the FeatureConfig message

  @property
  def ids_key(self) -> str:
    return 'feat.%s.ids' % self.name

  @property
  def weights_key(self) -> str:
    return 'feat.%s.weights' % self.name

  @property
  def dense_key(self) -> str:
    return 'feat.%s.dense' % self.name

  @property
  def mask_key(self) -> str:
    return 'feat.%s.mask' % self.name


def feature_output_name(config) -> str:
  return config.feature_name or config.input_names[0]


def table_rows(config) -> int:
  """Vocab rows needed by a feature's embedding table."""
  if config.hash_bucket_size > 0:
    return int(config.hash_bucket_size)
  if config.num_buckets > 0:
    return int(config.num_buckets)
  if config.vocab_list:
    return len(config.vocab_list) + 1          # +1 OOV bucket at the end
  if config.vocab_file:
    with open(config.vocab_file) as f:
      n = sum(1 for line in f if line.strip())
    return n + 1
  if list(config.boundaries):
    return len(config.boundaries) + 1
  if config.feature_type in ('RawFeature', 'ExprFeature', 'LookupFeature'):
    return max(int(config.raw_input_dim), 1)   # one row per raw dimension
  raise ValueError(
      'feature %s needs hash_bucket_size/num_buckets/vocab/boundaries' %
      feature_output_name(config))


def build_feature_spec(config,
                       max_tag_len: int = DEFAULT_MAX_TAG_LEN) -> FeatureSpec:
  """Build the static spec for one feature config."""
  name = feature_output_name(config)
  ftype = config.feature_type
  table_name = config.embedding_name or name
  emb_dim = int(config.embedding_dim)
  combiner = config.combiner or 'sum'
  multi_len = int(config.max_multi_len) or max_tag_len

  if ftype == 'IdFeature':
    return FeatureSpec(
        name=name, kind='categorical', num_ids=1,
        table_name=table_name, rows=table_rows(config),
        embedding_dim=emb_dim, combiner=combiner, config=config)

  if ftype == 'TagFeature':
    return FeatureSpec(
        name=name, kind='categorical', num_ids=multi_len,
        table_name=table_name, rows=table_rows(config),
        embedding_dim=emb_dim, combiner=combiner,
        is_weighted=bool(config.kv_separator) or len(config.input_names) > 1,
        config=config)

  # lookup_max_sel_elem_num reads 10 when unset (the proto's default): only
  # a config that sets it selects several map values
  explicit_sel = ftype == 'LookupFeature' and \
      config.HasField('lookup_max_sel_elem_num')
  if ftype == 'LookupFeature' and (
      config.hash_bucket_size > 0 or config.num_buckets > 0 or
      config.vocab_list or config.vocab_file or explicit_sel):
    # the kv-map lookup with an id scheme or multi-selection
    n_sel = max(int(config.lookup_max_sel_elem_num), 1) \
        if explicit_sel else 1
    if (config.hash_bucket_size > 0 or config.num_buckets > 0 or
        config.vocab_list or config.vocab_file or
        list(config.boundaries)):
      return FeatureSpec(
          name=name, kind='categorical', num_ids=n_sel,
          table_name=table_name, rows=table_rows(config),
          embedding_dim=emb_dim, combiner=combiner, config=config)
    if emb_dim > 0:
      # raw-projection numeric lookup: iota ids weighted by the values
      return FeatureSpec(
          name=name, kind='categorical', num_ids=n_sel,
          table_name=table_name, rows=n_sel, is_weighted=True,
          embedding_dim=emb_dim, combiner=combiner, config=config)
    return FeatureSpec(name=name, kind='dense', value_dim=n_sel,
                       config=config)

  if ftype in ('RawFeature', 'ExprFeature', 'LookupFeature'):
    raw_dim = max(int(config.raw_input_dim), 1)
    if list(config.boundaries):
      # bucketized: one id per raw dimension
      return FeatureSpec(
          name=name, kind='categorical', num_ids=raw_dim,
          table_name=table_name, rows=table_rows(config),
          embedding_dim=emb_dim, combiner=combiner, config=config)
    if emb_dim > 0:
      # raw-projection: ids = iota(raw_dim), weights = values
      return FeatureSpec(
          name=name, kind='categorical', num_ids=raw_dim,
          table_name=table_name, rows=raw_dim,
          embedding_dim=emb_dim, combiner='sum', is_weighted=True,
          config=config)
    return FeatureSpec(name=name, kind='dense', value_dim=raw_dim,
                       config=config)

  if ftype == 'ComboFeature':
    # combo_input_seps: the per-row cross product of multi-valued inputs,
    # at most max_multi_len (default 8) crosses
    n_ids = (int(config.max_multi_len) or 8) \
        if list(config.combo_input_seps) else 1
    return FeatureSpec(
        name=name, kind='categorical', num_ids=n_ids,
        table_name=table_name, rows=table_rows(config),
        embedding_dim=emb_dim, combiner=combiner, config=config)

  if ftype == 'SequenceFeature':
    seq_len = int(config.max_seq_len) or DEFAULT_MAX_SEQ_LEN
    if config.sub_feature_type == 'RawFeature' and \
        not list(config.boundaries):
      # numeric sequence: each position is raw_input_dim floats split by
      # seq_multi_sep
      return FeatureSpec(
          name=name, kind='sequence', num_ids=seq_len, seq_is_dense=True,
          value_dim=max(int(config.raw_input_dim), 1),
          embedding_dim=emb_dim, config=config)
    return FeatureSpec(
        name=name, kind='sequence', num_ids=seq_len,
        table_name=table_name, rows=table_rows(config),
        embedding_dim=emb_dim, combiner=combiner, config=config)

  if ftype == 'PassThroughFeature':
    return FeatureSpec(name=name, kind='dense',
                       value_dim=max(int(config.raw_input_dim), 1),
                       config=config)

  raise ValueError('unsupported feature type %s for %s' % (ftype, name))


def build_feature_specs(configs, max_tag_len: int = DEFAULT_MAX_TAG_LEN
                        ) -> Dict[str, FeatureSpec]:
  """Specs for all features; validates shared-embedding consistency.
  `max_tag_len` (DatasetConfig.max_tag_len) packs a TagFeature without
  max_multi_len."""
  specs: Dict[str, FeatureSpec] = {}
  table_shape: Dict[str, tuple] = {}
  for config in configs:
    spec = build_feature_spec(config, max_tag_len=max_tag_len)
    if spec.name in specs:
      raise ValueError('duplicate feature name %s' % spec.name)
    specs[spec.name] = spec
    if spec.kind in ('categorical', 'sequence') and not spec.seq_is_dense:
      shape = (spec.rows, spec.embedding_dim)
      prev = table_shape.get(spec.table_name)
      if prev is not None and prev != shape:
        raise ValueError(
            'shared embedding %s has inconsistent shapes %s vs %s' %
            (spec.table_name, prev, shape))
      table_shape[spec.table_name] = shape
  return specs
