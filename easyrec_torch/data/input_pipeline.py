"""Input pipeline: file readers -> feature transforms -> static batches.

Counterpart of easyrec_tpu/data/input_pipeline.py: CSVReader (:101),
ParquetReader (:166-204, on the port's own decoder, data/parquet.py),
TFRecordReader (:206-276), RTPReader (:280-330), CriteoBinaryReader
(:333-363), the streaming KafkaReader (:366-484) and DataHubReader
(:487-596), the warehouse ExternalServiceReader (:599-654) and DummyReader
(:658), under the same InputPipeline (:685), with the negative samplers
spliced in (data/samplers.py; :757-766, :843-850, :872-905). Every batch
has batch_size rows; a short tail is zero-padded with sample_weight 0.

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
A streaming reader's rows carry their partition and offset
(`__stream_pid`, `__stream_off`) through the pipeline; they never reach a
batch, but set the pipeline's `last_batch_offsets` as each batch is cut.
"""

from __future__ import annotations

import csv
import gzip
import json
import logging
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from easyrec_torch.config import config_util
from easyrec_torch.data import samplers as sampler_lib
from easyrec_torch.features import feature_spec as fs
from easyrec_torch.features import transforms as tr
from easyrec_torch.ops.hashing import hash_strings
from easyrec_torch.utils.registry import INPUTS, load_by_path


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


# the cells the JAX package's CSV parse (pyarrow's ConvertOptions
# null_values) reads as null in a numeric or BOOL column, which then take
# the field's default_val; a STRING column reads them as they are
_CSV_NULLS = frozenset(('', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN',
                        '-NaN', '-nan', '1.#IND', '1.#QNAN', 'N/A', 'NA',
                        'NULL', 'NaN', 'n/a', 'nan', 'null'))


def _typed_column(raw, field) -> np.ndarray:
  """Strings of one CSV column -> a typed numpy column with the field's
  default_val for empty (in a numeric or BOOL column, null) cells."""
  t = field.input_type
  if t == 'STRING':
    col = np.array(raw, dtype=object)
    if field.HasField('default_val'):
      col[col == ''] = field.default_val
    return col
  if t in ('FLOAT', 'DOUBLE'):
    dflt = float(field.default_val or 0.0)
    return np.array([float(v) if v not in _CSV_NULLS else dflt
                     for v in raw], dtype=np.float64)
  if t == 'BOOL':
    dflt = (field.default_val or '').lower() in ('1', 'true')
    return np.array([v.lower() in ('1', 'true') if v not in _CSV_NULLS
                     else dflt for v in raw], dtype=np.bool_)
  dflt = int(float(field.default_val or 0))
  return np.array([int(v) if v not in _CSV_NULLS else dflt for v in raw],
                  dtype=np.int64)


def _fill_defaults(columns: Dict[str, tuple], dc,
                   lists=()) -> Dict[str, np.ndarray]:
  """(values, nulls) columns of data/parquet.py -> arrays, the nulls
  replaced by each input field's default_val as the JAX package's
  _fill_defaults (:61-95) replaces them: a STRING field with a default_val
  also replaces ''; a numeric or BOOL field's nulls take its default (0,
  False) in the column's own type; a list column (`lists`) is left as it
  is. Nulls no default fills stay None, in an object array."""
  out = {}
  for f in dc.input_fields:
    name = f.input_name
    vals, nulls = columns[name]
    if name in lists:
      out[name] = vals
      continue
    if f.input_type == 'STRING':
      if f.HasField('default_val'):
        if vals.dtype != object:
          # pyarrow cannot make a string default a number (ArrowInvalid)
          raise TypeError('parquet column %s holds %s, its STRING field a '
                          'default_val %r' % (name, vals.dtype,
                                              f.default_val))
        vals = vals.copy()
        vals[(vals == None) | (vals == '')] = f.default_val  # noqa: E711
    elif nulls is not None and vals.dtype != object:
      if f.input_type in ('FLOAT', 'DOUBLE'):
        fill = float(f.default_val or 0.0)
      elif f.input_type == 'BOOL':
        fill = (f.default_val or '').lower() in ('1', 'true')
      else:
        fill = int(float(f.default_val or 0))
      vals = vals.copy()
      vals[nulls] = np.asarray(fill).astype(vals.dtype)
      nulls = None
    if nulls is not None and vals.dtype != object:
      vals = vals.astype(object)
      vals[nulls] = None
    out[name] = vals
  return out


@INPUTS.register('ParquetInput')
@INPUTS.register('ParquetInputV2')
@INPUTS.register('ParquetInputV3')
@INPUTS.register('HiveParquetInput')
class ParquetReader(BaseReader):
  """Parquet files through the port's own decoder (data/parquet.py; no
  pyarrow). A file that lacks a configured field raises KeyError. Chunks
  are cut every `chunk_rows` rows across the row groups of each file, as
  the JAX package's pyarrow iter_batches cuts them, so the shuffle sees the
  same chunks; each column keeps the file's type (an int32 column stays
  int32), its nulls filled as _fill_defaults says. With shard_num > 1 a
  reader takes the files paths[i::n] under file_shard, else the rows
  whose index across all its files is i modulo n."""

  def chunks(self, chunk_rows: int) -> Iterator[Dict[str, np.ndarray]]:
    from easyrec_torch.data import parquet
    paths = config_util.expand_input_paths(self.input_path)
    if not paths:
      raise FileNotFoundError('no input files match %s' % self.input_path)
    dc = self.data_config
    if dc.file_shard and self.shard_num > 1:
      paths = paths[self.shard_index::self.shard_num]
    row_shard = self.shard_num > 1 and not dc.file_shard
    names = self.field_names
    row = 0
    for path in paths:
      pf = parquet.ParquetFile(path)
      missing = [n for n in names if n not in pf.names]
      if missing:
        raise KeyError('parquet file %s is missing configured '
                       'input_fields %s (has: %s)' % (path, missing,
                                                      pf.names))
      lists = {n for n in names if pf.columns[n].is_list}
      for batch in pf.iter_batches(chunk_rows, names):
        if row_shard:
          n = len(batch[names[0]][0])
          keep = np.flatnonzero(np.arange(row, row + n) % self.shard_num ==
                                self.shard_index)
          row += n
          if keep.size == 0:
            continue
          batch = {k: (v[keep], None if m is None else m[keep])
                   for k, (v, m) in batch.items()}
        yield _fill_defaults(batch, dc, lists)


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


@INPUTS.register('RTPInput')
@INPUTS.register('RTPInputV2')
@INPUTS.register('OdpsRTPInput')
@INPUTS.register('OdpsRTPInputV2')
class RTPReader(BaseReader):
  """The RTP sample format: the label fields, then one column of the
  features joined by data_config.separator (RTP writes '\\002'), the
  columns split by rtp_separator (';' by default): lbl;lbl;...;f1\\002f2.
  A label the line lacks reads 0.0 and a feature it lacks ''; labels come
  out float32, features as strings. Files and rows shard as CSVReader's
  do (rows counted across files, empty lines skipped uncounted)."""

  def chunks(self, chunk_rows: int) -> Iterator[Dict[str, np.ndarray]]:
    dc = self.data_config
    rtp_sep = dc.rtp_separator or ';'
    feat_sep = dc.separator or '\002'
    labels = list(dc.label_fields)
    feature_fields = [n for n in self.field_names if n not in labels]
    paths = config_util.expand_input_paths(self.input_path)
    if dc.file_shard and self.shard_num > 1:
      paths = paths[self.shard_index::self.shard_num]
    row_shard = self.shard_num > 1 and not dc.file_shard
    row = 0
    buf = {n: [] for n in self.field_names}

    def flush():
      out = {n: np.asarray(buf[n], np.float32) for n in labels}
      out.update({n: np.asarray(buf[n], object) for n in feature_fields})
      for n in self.field_names:
        buf[n] = []
      return out

    for path in paths:
      with open(path) as f:
        for line in f:
          line = line.rstrip('\n')
          if not line:
            continue
          row += 1
          if row_shard and (row - 1) % self.shard_num != self.shard_index:
            continue
          parts = line.split(rtp_sep)
          feats = parts[-1].split(feat_sep)
          for i, n in enumerate(labels):
            buf[n].append(float(parts[i]) if i < len(parts) - 1 else 0.0)
          for i, n in enumerate(feature_fields):
            buf[n].append(feats[i] if i < len(feats) else '')
          if len(buf[self.field_names[0]]) >= chunk_rows:
            yield flush()
    if buf[self.field_names[0]]:
      yield flush()


@INPUTS.register('CriteoInput')
class CriteoBinaryReader(BaseReader):
  """The packed binary Criteo layout (tools/criteo_convert.py writes it):
  records of 40 little-endian int32, the label and 13 dense features read
  as float32 and 26 categorical ids as int64, named by the first 40 input
  fields in order (their declared types are not read). With shard_num > 1
  a reader takes the files paths[i::n] under file_shard, else the records
  i::n of each file."""

  RECORD_INTS = 40

  def chunks(self, chunk_rows: int) -> Iterator[Dict[str, np.ndarray]]:
    paths = config_util.expand_input_paths(self.input_path)
    if self.data_config.file_shard and self.shard_num > 1:
      paths = paths[self.shard_index::self.shard_num]
    names = self.field_names[:self.RECORD_INTS]
    for path in paths:
      data = np.fromfile(path, dtype='<i4')
      n = data.size // self.RECORD_INTS
      recs = data[:n * self.RECORD_INTS].reshape(n, self.RECORD_INTS)
      if not self.data_config.file_shard and self.shard_num > 1:
        recs = recs[self.shard_index::self.shard_num]
      for lo in range(0, len(recs), chunk_rows):
        part = recs[lo:lo + chunk_rows]
        yield {name: part[:, i].astype(np.float32 if i <= 13 else np.int64)
               for i, name in enumerate(names)}


def _stream_columns(out: Dict[str, np.ndarray], rows, items,
                    current: Dict[int, int]) -> None:
  """The (partition, offset, value) `rows` as the __stream_pid and
  __stream_off columns of `out`, and each partition's next offset past
  `items` (rows and skipped ones) into `current`."""
  out['__stream_pid'] = np.array([p for p, _, _ in rows], np.int64)
  out['__stream_off'] = np.array([o for _, o, _ in rows], np.int64)
  for pid, off, _ in items:
    current[pid] = max(current.get(pid, 0), off + 1)


@INPUTS.register('KafkaInput')
class KafkaReader(BaseReader):
  """Kafka streaming input (data/kafka_client.py, standard library only):
  each message's value is one CSV line of the input fields, parsed as
  CSVReader parses a file (_typed_column's defaults and nulls; a line of
  another field count raises, as the JAX package's typed parse does; an
  empty message is skipped with its offset).

  The input path is the KafkaServer message (kafka_train_input /
  kafka_eval_input). Partitions (its `partitions`, else all the topic's,
  sorted) are assigned statically, [shard_index::shard_num]; each starts
  at its offset in the `offset_info` JSON (the trainer's data_offset.json
  resume), else at its `offset` paired with `partitions`, else at the
  earliest. Training polls on at the end of the stream, unless
  EASYREC_KAFKA_STOP_AT_END=1; eval and predict drain to the high
  watermark and stop. `start_offsets` holds where each partition began and
  `current_offsets` the next offset past the rows yielded so far (a fetch
  reads ahead of both).

  One fetch returns each partition's next records in turn, so the order of
  the rows after a resume from offsets is the uninterrupted run's only
  where the cut fell at the end of a fetch round (every partition at the
  end of its fetched records); the rows themselves are the same either
  way, none read twice or skipped."""

  supports_offsets = True    # the trainer saves and restores its offsets

  def chunks(self, chunk_rows: int) -> Iterator[Dict[str, np.ndarray]]:
    from easyrec_torch.data import kafka_client as kc
    cfg = self.input_path
    if cfg is None or isinstance(cfg, str):
      raise ValueError(
          'KafkaInput needs a kafka_train_input/kafka_eval_input '
          'KafkaServer config (got %r)' % (cfg,))
    consumer = kc.KafkaConsumer(cfg.server,
                                client_id=cfg.group or 'easy_rec')
    all_parts = sorted(cfg.partitions) or consumer.partitions_for(cfg.topic)
    parts = all_parts[self.shard_index::self.shard_num]
    if not parts:
      consumer.close()
      return
    offs: Dict[int, int] = {}
    if cfg.offset_info:
      for k, v in json.loads(cfg.offset_info).items():
        if int(k) in parts:
          offs[int(k)] = int(v)
    for i, p in enumerate(sorted(cfg.partitions)):
      if i < len(cfg.offset) and p in parts and p not in offs:
        offs[p] = int(cfg.offset[i])
    missing = [p for p in parts if p not in offs]
    if missing:
      offs.update(consumer.offsets(cfg.topic, missing, kc.EARLIEST))
    self.current_offsets = dict(offs)
    # a partition that gives no row to a run keeps its start offset in
    # the offsets saved after it
    self.start_offsets = dict(offs)
    stop_at_end = getattr(self, 'mode', 'train') != 'train' or \
        os.environ.get('EASYREC_KAFKA_STOP_AT_END') == '1'
    pending: List[tuple] = []                  # (pid, off, value)
    try:
      while True:
        records, hwm = consumer.fetch(cfg.topic, offs, max_wait_ms=500)
        for pid, off, _key, value in records:
          offs[pid] = max(offs[pid], off + 1)
          pending.append((pid, off, value))
        while len(pending) >= chunk_rows:
          chunk, pending = pending[:chunk_rows], pending[chunk_rows:]
          yield self._parse_records(chunk)
        if not records and all(offs[p] >= hwm.get(p, 0) for p in parts):
          if not stop_at_end:
            continue                           # a stream: poll on
          if pending:
            yield self._parse_records(pending)
          return
    finally:
      consumer.close()

  def _parse_records(self, items: List[tuple]) -> Dict[str, np.ndarray]:
    kept = [it for it in items if it[2]]
    out = self._parse_lines([v for _, _, v in kept])
    _stream_columns(out, kept, items, self.current_offsets)
    return out

  def _parse_lines(self, lines: List[bytes]) -> Dict[str, np.ndarray]:
    sep = self.data_config.separator or ','
    rows = list(csv.reader([v.decode('utf-8') for v in lines],
                           delimiter=sep))
    width = len(self.field_names)
    for i, r in enumerate(rows):
      if len(r) != width:
        raise ValueError('Kafka message %d of the chunk has %d CSV fields, '
                         'the input fields are %d: %r'
                         % (i, len(r), width, lines[i][:200]))
    return {f.input_name: _typed_column([r[c] for r in rows], f)
            for c, f in enumerate(self.data_config.input_fields)}


@INPUTS.register('DataHubInput')
class DataHubReader(BaseReader):
  """Aliyun DataHub streaming input over data/datahub_client.py (REST,
  standard library only): TUPLE records whose topic schema must name every
  input field (a missing one raises, naming it and the topic's fields).

  The input path is the DatahubServer message. Shards go round-robin,
  shard i to the reader i % shard_num; each starts at its sequence in the
  `offset_info` JSON, else at 0. Training polls on at the end (every
  shard at LATEST), unless EASYREC_DATAHUB_STOP_AT_END=1; eval and
  predict stop there. Values come typed by the input fields: STRING ''
  for null, FLOAT/DOUBLE and INT 0 for null or '', BOOL true for 'true',
  'True' or '1'. `start_offsets` and `current_offsets` as KafkaReader's."""

  supports_offsets = True

  def chunks(self, chunk_rows: int) -> Iterator[Dict[str, np.ndarray]]:
    from easyrec_torch.data import datahub_client as dhc
    cfg = self.input_path
    if cfg is None or isinstance(cfg, str):
      raise ValueError(
          'DataHubInput needs a datahub_train_input/datahub_eval_input '
          'DatahubServer config (got %r)' % (cfg,))
    client = dhc.DataHubClient(cfg.region, cfg.akId, cfg.akSecret)
    names = [n for n, _t in client.get_topic(cfg.project, cfg.topic)]
    col_idx = {}
    for f in self.data_config.input_fields:
      if f.input_name not in names:
        raise ValueError('input_field[%s] is not in datahub topic %s '
                         '(fields: %s)' % (f.input_name, cfg.topic, names))
      col_idx[f.input_name] = names.index(f.input_name)
    shards = [s for i, s in
              enumerate(client.list_shards(cfg.project, cfg.topic))
              if i % self.shard_num == self.shard_index]
    if not shards:
      client.close()
      return
    offs: Dict[int, int] = {}
    if cfg.offset_info:
      for k, v in json.loads(cfg.offset_info).items():
        if str(k) in shards:
          offs[int(k)] = int(v)
    for s in shards:
      offs.setdefault(int(s), 0)
    self.current_offsets = dict(offs)
    self.start_offsets = dict(offs)
    stop_at_end = getattr(self, 'mode', 'train') != 'train' or \
        os.environ.get('EASYREC_DATAHUB_STOP_AT_END') == '1'
    pending: List[tuple] = []                  # (shard, sequence, data)
    try:
      while True:
        got_any, at_end = False, True
        for s in shards:
          si = int(s)
          cursor, _ = client.get_cursor(cfg.project, cfg.topic, s,
                                        dhc.SEQUENCE, offs[si])
          records, _ = client.get_records(cfg.project, cfg.topic, s, cursor,
                                          limit=chunk_rows)
          for seq, data in records:
            offs[si] = max(offs[si], seq + 1)
            pending.append((si, seq, data))
            got_any = True
          _, latest = client.get_cursor(cfg.project, cfg.topic, s,
                                        dhc.LATEST)
          if offs[si] < latest:
            at_end = False
        while len(pending) >= chunk_rows:
          chunk, pending = pending[:chunk_rows], pending[chunk_rows:]
          yield self._columns(chunk, col_idx)
        if not got_any and at_end:
          if not stop_at_end:
            time.sleep(0.5)                    # an idle stream: back off
            continue
          if pending:
            yield self._columns(pending, col_idx)
          return
    finally:
      client.close()

  def _columns(self, items: List[tuple],
               col_idx: Dict[str, int]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for f in self.data_config.input_fields:
      vals = [it[2][col_idx[f.input_name]] for it in items]
      if f.input_type == 'STRING':
        out[f.input_name] = np.array(
            ['' if v is None else str(v) for v in vals], dtype=object)
      elif f.input_type in ('FLOAT', 'DOUBLE'):
        out[f.input_name] = np.array(
            [0.0 if v in (None, '') else float(v) for v in vals], np.float64)
      elif f.input_type in ('INT32', 'INT64'):
        out[f.input_name] = np.array(
            [0 if v in (None, '') else int(v) for v in vals], np.int64)
      else:
        out[f.input_name] = np.array([v in ('true', 'True', '1')
                                      for v in vals])
    _stream_columns(out, items, items, self.current_offsets)
    return out


@INPUTS.register('HiveInput')
@INPUTS.register('HiveRTPInput')
@INPUTS.register('OdpsInput')
@INPUTS.register('OdpsInputV2')
@INPUTS.register('OdpsInputV3')
class ExternalServiceReader(BaseReader):
  """Hive and MaxCompute (ODPS) tables read from an export: the table (the
  HiveConfig's table_name, or the last part of an odps://project/tables/
  name path) resolves to $EASYREC_WAREHOUSE_EXPORT_DIR/<table>/, whose
  *.parquet, *.csv, *.csv.gz or other files are read; a path that already
  names existing files is read as it is. CSV exports go through
  CSVReader, the others through ParquetReader (JAX :650); a table with no
  export raises, naming the input type and the table."""

  def _resolve(self) -> str:
    path = self.input_path
    table = None
    if not isinstance(path, str):              # a HiveConfig message
      table = path.table_name
    elif path.startswith('odps://'):
      table = path.rstrip('/').split('/')[-1]
    elif path:
      hits = config_util.expand_input_paths(path)
      if hits and all(os.path.exists(h) for h in hits):
        return path
      table = path
    root = os.environ.get('EASYREC_WAREHOUSE_EXPORT_DIR', '')
    if table and root:
      for pat in ('*.parquet', '*.csv', '*.csv.gz', '*'):
        hit = os.path.join(root, table, pat)
        if config_util.expand_input_paths(hit):
          return hit
    raise NotImplementedError(
        '%s has no live warehouse connectivity here. Export the table '
        'offline (e.g. INSERT OVERWRITE DIRECTORY ... STORED AS PARQUET '
        'or odpscmd tunnel download) and either point the input path at '
        'the exported files, or set EASYREC_WAREHOUSE_EXPORT_DIR so '
        '<dir>/%s/*.parquet resolves.'
        % (self.data_config.input_type, table or '<table_name>'))

  def chunks(self, chunk_rows: int) -> Iterator[Dict[str, np.ndarray]]:
    resolved = self._resolve()
    cls = ParquetReader if '.csv' not in resolved else CSVReader
    delegate = cls(self.data_config, resolved, self.shard_index,
                   self.shard_num)
    delegate.mode = getattr(self, 'mode', 'train')
    return delegate.chunks(chunk_rows)


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
  A streaming reader (Kafka, DataHub) is never shuffled and resumes by
  its offsets, not skip_rows; last_batch_offsets holds each partition's
  next offset past the last batch cut.
  `shard_index` / `shard_num` pick this reader's share of the input. The input fields `extra_fields` ride along as numeric
  field.<name> columns and, with `raw_extra_fields`, as raw.<name>
  strings. A sampler (data_config's `sampler`; none in predict mode)
  draws its negatives once a batch, after the batch is cut, from the
  batch's raw item and user ids, as the JAX pipeline's _finalize does.
  A label field's user_define_fn maps its f32 values; each of
  data_config.extra_label_func (but in predict mode) makes a label from
  the dict of the labels before it (JAX :732-736, :822-830). With
  `check_mode`, each raw chunk is validated first (data/check.py), with
  errors that name the feature, the row and the value.
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
               raw_extra_fields: bool = False,
               check_mode: bool = False):
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
    self.reader.mode = mode    # a streaming reader stops at the end off train
    # a streaming reader's next offset of each partition past the last
    # batch cut (_finalize); the trainer saves it as data_offset.json
    self.last_batch_offsets: Optional[Dict[int, int]] = None
    self.label_fields = list(data_config.label_fields)
    self.sample_weight_field = data_config.sample_weight or None
    self.check_mode = bool(check_mode)
    self._label_fns = {f.input_name: load_by_path(f.user_define_fn)
                       for f in data_config.input_fields
                       if f.user_define_fn and
                       f.input_name in self.label_fields}
    self._extra_label_fns = [(fc.label_name, load_by_path(fc.label_func))
                             for fc in data_config.extra_label_func]
    if drop_remainder is None:
      drop_remainder = bool(data_config.drop_remainder) and mode == 'train'
    self.drop_remainder = drop_remainder
    self.num_epochs = data_config.num_epochs if mode == 'train' else 1
    # a streaming source is never shuffled: its resume offsets would not
    # hold
    self.shuffle = data_config.shuffle and mode == 'train' and \
        not getattr(self.reader, 'supports_offsets', False)
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
    if self.check_mode:
      from easyrec_torch.data.check import validate_columns
      validate_columns(self.specs, columns,
                       label_fields=[l for l in self.label_fields
                                     if self.mode != 'predict'],
                       sample_weight_field=self.sample_weight_field)
    out = tr.apply_transforms(self.transforms, columns)
    n = next(iter(out.values())).shape[0] if out else \
        len(next(iter(columns.values())))
    for label in self.label_fields:
      vals = tr.to_float(columns[label])
      fn = self._label_fns.get(label)
      if fn is not None:
        vals = np.asarray(fn(vals), dtype=np.float32)
      out['label.%s' % label] = vals.astype(np.float32)
    if self._extra_label_fns and self.mode != 'predict':
      # each function gets the labels so far and makes one more
      label_dict = {k.split('.', 1)[1]: v for k, v in out.items()
                    if k.startswith('label.')}
      for name, fn in self._extra_label_fns:
        vals = np.asarray(fn(label_dict), dtype=np.float32)
        out['label.%s' % name] = vals
        label_dict[name] = vals
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
    if '__stream_pid' in columns:
      # each row's partition and offset ride along to _finalize
      out['_off.pid'] = np.asarray(columns['__stream_pid'])
      out['_off.val'] = np.asarray(columns['__stream_off'])
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
    """Fold a streaming batch's row offsets into last_batch_offsets: each
    partition with a live row (sample_weight > 0) in the batch moves past
    its last one, the others keep the offset they had (at first, the
    reader's start offset). Then splice the sampler's negatives into the
    batch as neg.feat.* (and a hard-negative sampler's as hard_neg.feat.*
    with hard_neg_mask)."""
    pid = batch.pop('_off.pid', None)
    off = batch.pop('_off.val', None)
    if pid is not None:
      live = batch['sample_weight'] > 0
      offsets = dict(self.last_batch_offsets
                     if self.last_batch_offsets is not None
                     else getattr(self.reader, 'start_offsets', {}))
      for p in np.unique(pid[live]):
        offsets[int(p)] = int(off[live][pid[live] == p].max()) + 1
      self.last_batch_offsets = offsets
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
