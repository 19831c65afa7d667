"""Input pipeline: file readers -> feature transforms -> static batches.

Counterpart of easyrec_tpu/data/input_pipeline.py for the readers the port
runs: CSVReader (:101) and DummyReader (:658), under the same InputPipeline
(:685). Every batch has batch_size rows; a short tail is zero-padded with
sample_weight 0. Samplers and streaming readers are not ported.

Batches are flat dicts of numpy arrays:
  feat.<name>.ids / .weights / .dense : packed feature arrays
  label.<name>                        : float32 labels
  sample_weight                       : [B] f32 (0 on padding)
"""

from __future__ import annotations

import csv
import gzip
import logging
from typing import Dict, Iterator, Optional

import numpy as np

from easyrec_torch.config import config_util
from easyrec_torch.features import feature_spec as fs
from easyrec_torch.features import transforms as tr
from easyrec_torch.utils.registry import INPUTS


class BaseReader:
  """Yields column chunks: dict[input_name -> np.ndarray]."""

  def __init__(self, data_config, input_path: str):
    self.data_config = data_config
    self.input_path = input_path
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
  JAX package's CSV reader decompresses by suffix (:105-107).
  """

  def chunks(self, chunk_rows: int) -> Iterator[Dict[str, np.ndarray]]:
    paths = config_util.expand_input_paths(self.input_path)
    if not paths:
      raise FileNotFoundError('no input files match %s' % self.input_path)
    dc = self.data_config
    sep = dc.separator or ','
    names = self.field_names
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
        for row in reader:
          if not row:
            continue
          rows.append(row)
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


def create_reader(data_config, input_path: str) -> BaseReader:
  type_name = data_config.input_type
  if type_name not in INPUTS:
    raise NotImplementedError('input_type %s is not ported' % type_name)
  return INPUTS.get(type_name)(data_config, input_path)


class InputPipeline:
  """Reader -> shuffle -> transforms -> padded batches.

  `skip_rows` resumes a run by row count (the JAX package's data-offset
  resume, :705, :774-784): that many raw rows are dropped, across chunks
  and epochs, before any transform or shuffle. With shuffle on, the chunks
  after the skip are permuted with other seeds than in the run that was
  cut, so a resumed stream equals the uninterrupted one only unshuffled.
  """

  def __init__(self,
               data_config,
               feature_configs,
               input_path: str,
               mode: str = 'train',
               batch_size: Optional[int] = None,
               drop_remainder: Optional[bool] = None,
               skip_rows: int = 0):
    self.data_config = data_config
    self.mode = mode
    if batch_size is None:
      batch_size = data_config.batch_size if mode == 'train' else \
          (data_config.eval_batch_size or data_config.batch_size)
    self.batch_size = int(batch_size)
    self.specs = fs.build_feature_specs(feature_configs)
    self.transforms = tr.build_transforms(self.specs)
    self.reader = create_reader(data_config, input_path)
    self.label_fields = list(data_config.label_fields)
    self.sample_weight_field = data_config.sample_weight or None
    if drop_remainder is None:
      drop_remainder = bool(data_config.drop_remainder) and mode == 'train'
    self.drop_remainder = drop_remainder
    self.num_epochs = data_config.num_epochs if mode == 'train' else 1
    self.shuffle = data_config.shuffle and mode == 'train'
    self._seed = 17
    self.skip_rows = int(skip_rows)

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
          yield self._slice(carry, 0, self.batch_size)
          carry = self._slice(carry, self.batch_size, n)
          n = carry['sample_weight'].shape[0]
      if carry is not None and carry['sample_weight'].shape[0] > 0 and \
          not self.drop_remainder:
        yield self._pad(carry)
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

  def _pad(self, arrays):
    pad = self.batch_size - arrays['sample_weight'].shape[0]
    # padded rows carry zero sample weight -> excluded from loss & metrics
    return {k: np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))
            for k, v in arrays.items()}
