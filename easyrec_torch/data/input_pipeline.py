"""Input pipeline: file readers -> feature transforms -> static batches.

Counterpart of easyrec_tpu/data/input_pipeline.py for the readers the port
runs: CSVReader (:101), TFRecordReader (:206-276) and DummyReader (:658),
under the same InputPipeline (:685), with the negative samplers spliced
in (data/samplers.py; :757-766, :843-850, :872-905). Every batch has
batch_size rows; a short tail is zero-padded with sample_weight 0.
Streaming readers are not ported.

Batches are flat dicts of numpy arrays:
  feat.<name>.ids / .weights / .dense : packed feature arrays
  label.<name>                        : float32 labels
  sample_weight                       : [B] f32 (0 on padding)
  field.<name>                        : the extra fields (kd soft labels,
                                        the metric-learning session ids):
                                        floats, or strings hashed into
                                        [0, 2^31) as int64
  raw.<name>                          : with raw_extra_fields, the
                                        extra fields' values as strings
                                        (host only; predict_csv's
                                        reserved_cols)
  neg.feat.<name>.*                   : with a sampler, the item-side
                                        features of its num_sample
                                        negatives (num_eval_sample off
                                        train; none in predict)
  hard_neg.feat.<name>.*, hard_neg_mask : with a hard-negative sampler,
                                        [B * H] rows of each user's hard
                                        negatives and the [B, H] mask of
                                        the real ones
"""

from __future__ import annotations

import csv
import gzip
import logging
from typing import Dict, Iterator, List, Optional

import numpy as np

from easyrec_torch.config import config_util
from easyrec_torch.data import samplers as sampler_lib
from easyrec_torch.features import feature_spec as fs
from easyrec_torch.features import transforms as tr
from easyrec_torch.ops.hashing import hash_strings
from easyrec_torch.utils.registry import INPUTS


class BaseReader:
  """Yields column chunks: dict[input_name -> np.ndarray]."""

  def __init__(self, data_config, input_path: str, shard_index: int = 0,
               shard_num: int = 1):
    self.data_config = data_config
    self.input_path = input_path
    self.shard_index = int(shard_index)
    self.shard_num = int(shard_num)
    self.field_names = [f.input_name for f in data_config.input_fields]

  def chunks(self, chunk_rows: int) -> Iterator[Dict[str, np.ndarray]]:
    raise NotImplementedError


@INPUTS.register('CSVInput')
@INPUTS.register('CSVInputV2')
@INPUTS.register('CSVInputEx')
class CSVReader(BaseReader):
  """Headerless (or with_header) delimited files with the schema taken from
  input_fields; glob patterns and comma-separated lists of paths.

  Chunks are cut every `chunk_rows` rows (the JAX package cuts them by the
  byte size of its CSV reader's blocks; a file smaller than one block is
  one chunk in both). A path ending in `.gz` is read through gzip, as the
  JAX package's CSV reader decompresses by suffix (:105-107). With
  shard_num > 1 (:118, :154-158) a reader takes the files paths[i::n]
  under data_config.file_shard, else the rows whose index across all its
  files is i modulo n.
  """

  def chunks(self, chunk_rows: int) -> Iterator[Dict[str, np.ndarray]]:
    paths = config_util.expand_input_paths(self.input_path)
    if not paths:
      raise FileNotFoundError('no input files match %s' % self.input_path)
    dc = self.data_config
    if dc.file_shard and self.shard_num > 1:
      paths = paths[self.shard_index::self.shard_num]
    row_shard = self.shard_num > 1 and not dc.file_shard
    sep = dc.separator or ','
    names = self.field_names
    row = 0
    for path in paths:
      try:
        f = gzip.open(path, 'rt', newline='') if path.endswith('.gz') \
            else open(path, newline='')
      except OSError as e:
        if dc.ignore_error:
          logging.warning('skipping bad file %s: %s', path, e)
          continue
        raise
      with f:
        reader = csv.reader(f, delimiter=sep)
        cols = list(range(len(names)))
        if dc.with_header:
          header = next(reader)
          cols = [header.index(n) for n in names]
        rows = []
        for fields in reader:
          if not fields:
            continue
          row += 1
          if row_shard and (row - 1) % self.shard_num != self.shard_index:
            continue
          rows.append(fields)
          if len(rows) == chunk_rows:
            yield self._columns(rows, cols)
            rows = []
        if rows:
          yield self._columns(rows, cols)

  def _columns(self, rows, cols) -> Dict[str, np.ndarray]:
    out = {}
    for f, c in zip(self.data_config.input_fields, cols):
      raw = [r[c] if c < len(r) else '' for r in rows]
      out[f.input_name] = _typed_column(raw, f)
    return out


def _typed_column(raw, field) -> np.ndarray:
  """Strings of one CSV column -> a typed numpy column with the field's
  default_val for empty cells."""
  t = field.input_type
  if t == 'STRING':
    col = np.array(raw, dtype=object)
    if field.HasField('default_val'):
      col[col == ''] = field.default_val
    return col
  if t in ('FLOAT', 'DOUBLE'):
    dflt = float(field.default_val or 0.0)
    return np.array([float(v) if v != '' else dflt for v in raw],
                    dtype=np.float64)
  if t == 'BOOL':
    dflt = (field.default_val or '').lower() in ('1', 'true')
    return np.array([v.lower() in ('1', 'true') if v != '' else dflt
                     for v in raw], dtype=np.bool_)
  dflt = int(float(field.default_val or 0))
  return np.array([int(v) if v != '' else dflt for v in raw], dtype=np.int64)


_TFRECORD_DTYPES = {'INT32': np.int32, 'INT64': np.int64,
                    'FLOAT': np.float32, 'DOUBLE': np.float64,
                    'BOOL': np.bool_}


@INPUTS.register('TFRecordInput')
@INPUTS.register('BatchTFRecordInput')
class TFRecordReader(BaseReader):
  """tf.Example TFRecord files (data/tfrecord.py reads them without
  TensorFlow), GZIP by data_config.data_compression_type or a .gz
  suffix; files and rows shard as CSVReader's do. A STRING field holds its
  bytes (several joined by '|') or its numbers as text; a numeric field
  its one value, or its default where it has none. A numeric feature of
  several values (the JAX package's arrow list column) is not ported."""

  def chunks(self, chunk_rows: int) -> Iterator[Dict[str, np.ndarray]]:
    from easyrec_torch.data import tfrecord
    paths = config_util.expand_input_paths(self.input_path)
    if not paths:
      raise FileNotFoundError('no input files match %s' % self.input_path)
    dc = self.data_config
    if dc.file_shard and self.shard_num > 1:
      paths = paths[self.shard_index::self.shard_num]
    row_shard = self.shard_num > 1 and not dc.file_shard
    row = 0
    for path in paths:
      buf = []
      for payload in tfrecord.read_records(
          path, compression=dc.data_compression_type or ''):
        row += 1
        if row_shard and (row - 1) % self.shard_num != self.shard_index:
          continue
        buf.append(payload)
        if len(buf) >= chunk_rows:
          yield self._columns(buf)
          buf = []
      if buf:
        yield self._columns(buf)

  def _columns(self, payloads) -> Dict[str, np.ndarray]:
    from easyrec_torch.data import tfrecord
    cols = tfrecord.example_to_columns(payloads, self.field_names)
    out = {}
    for f in self.data_config.input_fields:
      vals = cols[f.input_name]
      dflt = f.default_val if f.HasField('default_val') else None
      if f.input_type == 'STRING':
        out[f.input_name] = np.asarray(
            ['|'.join(map(str, v)) if isinstance(v, list) else
             (str(v) if v not in ('', None) else (dflt or ''))
             for v in vals], dtype=object)
        continue
      dt = _TFRECORD_DTYPES[f.input_type]
      try:
        dv = dt(float(dflt or 0))
      except (TypeError, ValueError):
        dv = dt(0)
      if any(isinstance(v, list) and len(v) > 1 for v in vals):
        raise NotImplementedError(
            'TFRecord field %s holds several numbers in a row: multi-value '
            'numeric fields are not ported' % f.input_name)

      def scalar(v):
        if isinstance(v, list):
          return v[0] if v else dv
        return dv if v in ('', None) else v
      out[f.input_name] = np.asarray([scalar(v) for v in vals], dtype=dt)
    return out


@INPUTS.register('DummyInput')
class DummyReader(BaseReader):
  """Synthetic constant chunks for input-bottleneck perf testing."""

  def chunks(self, chunk_rows: int) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(42)
    chunk = {}
    for f in self.data_config.input_fields:
      if f.input_type == 'STRING':
        chunk[f.input_name] = np.array(
            ['id%d' % v for v in rng.integers(0, 100000, chunk_rows)],
            dtype=object)
      elif f.input_type in ('FLOAT', 'DOUBLE'):
        chunk[f.input_name] = rng.random(chunk_rows).astype(np.float32)
      else:
        chunk[f.input_name] = rng.integers(0, 2, chunk_rows).astype(np.int64)
    while True:
      yield dict(chunk)


def create_reader(data_config, input_path: str, shard_index: int = 0,
                  shard_num: int = 1) -> BaseReader:
  type_name = data_config.input_type
  if type_name not in INPUTS:
    raise NotImplementedError('input_type %s is not ported' % type_name)
  return INPUTS.get(type_name)(data_config, input_path, shard_index,
                               shard_num)


class InputPipeline:
  """Reader -> shuffle -> transforms -> padded batches.

  `skip_rows` resumes a run by row count (the JAX package's data-offset
  resume, :705, :774-784): that many raw rows are dropped, across chunks
  and epochs, before any transform or shuffle. With shuffle on, the chunks
  after the skip are permuted with other seeds than in the run that was
  cut, so a resumed stream equals the uninterrupted one only unshuffled.
  `shard_index` / `shard_num` pick this reader's share of the input
  (CSVReader). The input fields `extra_fields` ride along as numeric
  field.<name> columns and, with `raw_extra_fields`, as raw.<name>
  strings. A sampler (data_config's `sampler`; none in predict mode)
  draws its negatives once a batch, after the batch is cut, from the
  batch's raw item and user ids, as the JAX pipeline's _finalize does.
  """

  def __init__(self,
               data_config,
               feature_configs,
               input_path: str,
               mode: str = 'train',
               batch_size: Optional[int] = None,
               drop_remainder: Optional[bool] = None,
               skip_rows: int = 0,
               shard_index: int = 0,
               shard_num: int = 1,
               extra_fields: Optional[List[str]] = None,
               raw_extra_fields: bool = False):
    self.data_config = data_config
    self.mode = mode
    if batch_size is None:
      batch_size = data_config.batch_size if mode == 'train' else \
          (data_config.eval_batch_size or data_config.batch_size)
    self.batch_size = int(batch_size)
    self.specs = fs.build_feature_specs(
        feature_configs, max_tag_len=data_config.max_tag_len or 16)
    self.transforms = tr.build_transforms(self.specs)
    self.reader = create_reader(data_config, input_path, shard_index,
                                shard_num)
    self.label_fields = list(data_config.label_fields)
    self.sample_weight_field = data_config.sample_weight or None
    if drop_remainder is None:
      drop_remainder = bool(data_config.drop_remainder) and mode == 'train'
    self.drop_remainder = drop_remainder
    self.num_epochs = data_config.num_epochs if mode == 'train' else 1
    self.shuffle = data_config.shuffle and mode == 'train'
    self._seed = 17
    self.skip_rows = int(skip_rows)
    field_types = {f.input_name: f.input_type
                   for f in data_config.input_fields}
    self.extra_fields = [(f, field_types[f]) for f in (extra_fields or [])
                         if f in field_types]
    self.raw_extra_fields = bool(raw_extra_fields)
    self.sampler = sampler_lib.build(data_config, mode)
    self._neg_transforms = []
    if self.sampler is not None:
      # the features whose inputs are all among the sampler's attrs
      attr_set = set(self.sampler.attr_fields) | {self.sampler.item_id_field}
      self._neg_transforms = tr.build_transforms({
          name: spec for name, spec in self.specs.items()
          if spec.config is not None and
          all(n in attr_set for n in spec.config.input_names)})

  def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
    epoch = 0
    carry: Optional[Dict[str, np.ndarray]] = None
    to_skip = self.skip_rows
    while True:
      epoch += 1
      for columns in self.reader.chunks(self._chunk_rows()):
        if to_skip > 0:
          n = len(next(iter(columns.values())))
          if n <= to_skip:
            to_skip -= n
            continue
          columns = {k: v[to_skip:] for k, v in columns.items()}
          to_skip = 0
        carry = self._concat(carry, self._process_chunk(columns, epoch))
        n = carry['sample_weight'].shape[0]
        while n >= self.batch_size:
          yield self._finalize(self._slice(carry, 0, self.batch_size))
          carry = self._slice(carry, self.batch_size, n)
          n = carry['sample_weight'].shape[0]
      if carry is not None and carry['sample_weight'].shape[0] > 0 and \
          not self.drop_remainder:
        yield self._finalize(self._pad(carry))
        carry = None
      if self.num_epochs and epoch >= self.num_epochs:
        return

  def _chunk_rows(self) -> int:
    mult = max(int(self.data_config.shuffle_buffer_size), 1) \
        if self.shuffle else 4
    return self.batch_size * min(mult, 64)

  def _process_chunk(self, columns, epoch) -> Dict[str, np.ndarray]:
    out = tr.apply_transforms(self.transforms, columns)
    n = next(iter(out.values())).shape[0] if out else \
        len(next(iter(columns.values())))
    for label in self.label_fields:
      out['label.%s' % label] = tr.to_float(columns[label]).astype(
          np.float32)
    if self.sample_weight_field:
      out['sample_weight'] = tr.to_float(columns[self.sample_weight_field])
    else:
      out['sample_weight'] = np.ones(n, dtype=np.float32)
    for fname, ftype in self.extra_fields:
      if self.raw_extra_fields:
        out['raw.%s' % fname] = tr.to_numpy_str(columns[fname])
      if ftype == 'STRING':
        out['field.%s' % fname] = hash_strings(
            columns[fname], 1 << 31).astype(np.int64)
      else:
        out['field.%s' % fname] = tr.to_float(columns[fname])
    if self.sampler is not None:
      # raw ids ride along for the batch's exclusion and hard edges
      out['_sid.item'] = tr.to_numpy_str(
          columns[self.sampler.item_id_field])
      user_field = getattr(self.sampler, 'user_id_field', None)
      if user_field and user_field in columns:
        out['_sid.user'] = tr.to_numpy_str(columns[user_field])
    if self.shuffle:
      rng = np.random.default_rng(self._seed * 1000003 + epoch)
      self._seed += 1
      perm = rng.permutation(n)
      out = {k: v[perm] for k, v in out.items()}
    return out

  @staticmethod
  def _concat(a, b):
    if a is None or a['sample_weight'].shape[0] == 0:
      return b
    return {k: np.concatenate([a[k], b[k]], axis=0) for k in b}

  @staticmethod
  def _slice(arrays, lo, hi):
    return {k: v[lo:hi] for k, v in arrays.items()}

  def _finalize(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Splice the sampler's negatives into the batch as neg.feat.* (and a
    hard-negative sampler's as hard_neg.feat.* with hard_neg_mask)."""
    if self.sampler is None:
      return batch
    item_ids = batch.pop('_sid.item', None)
    user_ids = batch.pop('_sid.user', None)
    cols = self.sampler.sample(batch_item_ids=item_ids,
                               batch_user_ids=user_ids)
    for k, v in tr.apply_transforms(self._neg_transforms, cols).items():
      batch['neg.%s' % k] = v
    if hasattr(self.sampler, 'sample_hard') and user_ids is not None:
      hcols = self.sampler.sample_hard(user_ids)
      hmask = hcols.pop('hard_neg_mask')
      for k, v in tr.apply_transforms(self._neg_transforms, hcols).items():
        batch['hard_neg.%s' % k] = v
      batch['hard_neg_mask'] = hmask
    return batch

  def _pad(self, arrays):
    pad = self.batch_size - arrays['sample_weight'].shape[0]
    # padded rows carry zero sample weight -> excluded from loss & metrics
    return {k: np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))
            for k, v in arrays.items()}
