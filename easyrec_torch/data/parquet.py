"""A Parquet file decoder of the port's own: no pyarrow, no Thrift library.

It stands where pyarrow.parquet stands for the JAX package's ParquetReader
(easyrec_tpu/data/input_pipeline.py:166-204): ParquetFile(path) reads the
footer, and iter_batches(batch_size, columns) yields the named top-level
columns batch_size rows at a time, cut across row groups within the file
as pyarrow's iter_batches cuts them.

What it reads:
  - metadata: the footer (PAR1, FileMetaData) and every PageHeader,
    through a small Thrift compact-protocol reader (_Compact);
  - columns: flat ones, and one level of LIST (the three-level form
    pyarrow writes, the two-level legacy form, a repeated top-level leaf);
  - pages: DataPage V1 and V2 and the dictionary page, in any mix (a
    dictionary that falls back to PLAIN partway through a column chunk);
  - encodings: PLAIN, PLAIN_DICTIONARY / RLE_DICTIONARY, the RLE /
    bit-packed hybrid (levels and booleans), DELTA_BINARY_PACKED,
    DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY and BYTE_STREAM_SPLIT;
  - codecs: UNCOMPRESSED, SNAPPY and GZIP (zlib); ZSTD, LZ4, LZ4_RAW,
    BROTLI and LZO raise, naming the codec, the file and the column;
  - types: BOOLEAN, INT32, INT64, FLOAT, DOUBLE and BYTE_ARRAY, the
    signed and unsigned integer annotations of 8-64 bits, and UTF8 /
    STRING; INT96, FIXED_LEN_BYTE_ARRAY, DECIMAL and the date and time
    annotations raise, naming the column. Nulls come from the definition
    levels.

A batch maps each column name to (values, nulls): numeric and boolean
values in the numpy type of the file's column (nulls hold 0, and `nulls`
is a bool mask, or None where the batch has none); strings as an object
array of str (None at a null); a list column as an object array of Python
lists of Python values (None for a null row or element; [] for an empty
row) with nulls None. The loops that cost run in native code
(ops/parquet_ops.py).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from easyrec_torch.ops import parquet_ops as po
from easyrec_torch.ops.parquet_ops import ParquetFormatError

MAGIC = b'PAR1'

# Type (parquet.thrift)
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED = range(8)
TYPE_NAMES = ('BOOLEAN', 'INT32', 'INT64', 'INT96', 'FLOAT', 'DOUBLE',
              'BYTE_ARRAY', 'FIXED_LEN_BYTE_ARRAY')
# FieldRepetitionType
REQUIRED, OPTIONAL, REPEATED = range(3)
# Encoding
PLAIN, PLAIN_DICTIONARY, RLE, BIT_PACKED = 0, 2, 3, 4
DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY = 5, 6, 7
RLE_DICTIONARY, BYTE_STREAM_SPLIT = 8, 9
ENCODING_NAMES = {0: 'PLAIN', 2: 'PLAIN_DICTIONARY', 3: 'RLE',
                  4: 'BIT_PACKED', 5: 'DELTA_BINARY_PACKED',
                  6: 'DELTA_LENGTH_BYTE_ARRAY', 7: 'DELTA_BYTE_ARRAY',
                  8: 'RLE_DICTIONARY', 9: 'BYTE_STREAM_SPLIT'}
# CompressionCodec
CODEC_NAMES = ('UNCOMPRESSED', 'SNAPPY', 'GZIP', 'LZO', 'BROTLI', 'LZ4',
               'ZSTD', 'LZ4_RAW')
# PageType
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)
# ConvertedType: the integer annotations, as (numpy type), and the ones
# read as strings; LIST is 3
_CONVERTED_INTS = {11: np.uint8, 12: np.uint16, 13: np.uint32, 14: np.uint64,
                   15: np.int8, 16: np.int16, 17: np.int32, 18: np.int64}
_CONVERTED_REFUSED = {5: 'DECIMAL', 6: 'DATE', 7: 'TIME_MILLIS',
                      8: 'TIME_MICROS', 9: 'TIMESTAMP_MILLIS',
                      10: 'TIMESTAMP_MICROS', 21: 'INTERVAL', 1: 'MAP',
                      2: 'MAP_KEY_VALUE'}
_LOGICAL_REFUSED = {5: 'DECIMAL', 6: 'DATE', 7: 'TIME', 8: 'TIMESTAMP',
                    2: 'MAP', 15: 'FLOAT16'}
_PLAIN_DTYPES = {INT32: '<i4', INT64: '<i8', FLOAT: '<f4', DOUBLE: '<f8'}


# -- Thrift compact protocol ---------------------------------------------


class _Compact:
  """A Thrift compact-protocol reader over buf from pos: read_struct()
  returns a struct as {field id: value}, nested structs as dicts and lists
  as lists; binary fields stay bytes."""

  def __init__(self, buf, pos: int = 0):
    self.buf = memoryview(buf).cast('B')    # items read as Python ints
    self.pos = pos

  def _byte(self) -> int:
    if self.pos >= len(self.buf):
      raise ParquetFormatError('Thrift struct past the end of its buffer')
    b = self.buf[self.pos]
    self.pos += 1
    return b

  def _varint(self) -> int:
    v = shift = 0
    while True:
      b = self._byte()
      v |= (b & 0x7f) << shift
      if not b & 0x80:
        return v
      shift += 7
      if shift > 70:
        raise ParquetFormatError('malformed Thrift varint')

  def _zigzag(self) -> int:
    v = self._varint()
    return (v >> 1) ^ -(v & 1)

  def _value(self, t: int):
    if t in (1, 2):                     # a bool inside a list or map
      return self._byte() == 1
    if t == 3:
      b = self._byte()
      return b - 256 if b > 127 else b
    if t in (4, 5, 6):
      return self._zigzag()
    if t == 7:
      self.pos += 8
      return struct.unpack_from('<d', self.buf, self.pos - 8)[0]
    if t == 8:
      n = self._varint()
      self.pos += n
      if self.pos > len(self.buf):
        raise ParquetFormatError('Thrift binary past the end of its buffer')
      return bytes(self.buf[self.pos - n:self.pos])
    if t in (9, 10):
      h = self._byte()
      n, et = h >> 4, h & 0x0f
      if n == 15:
        n = self._varint()
      return [self._value(et) for _ in range(n)]
    if t == 11:
      n = self._varint()
      if not n:
        return {}
      kv = self._byte()
      return {self._value(kv >> 4): self._value(kv & 0x0f) for _ in range(n)}
    if t == 12:
      return self.read_struct()
    raise ParquetFormatError('unknown Thrift type %d' % t)

  def read_struct(self) -> dict:
    out = {}
    fid = 0
    while True:
      b = self._byte()
      if b == 0:
        return out
      t = b & 0x0f
      fid = fid + (b >> 4) if b >> 4 else self._zigzag()
      out[fid] = (t == 1) if t in (1, 2) else self._value(t)


# -- schema --------------------------------------------------------------


@dataclasses.dataclass
class _Node:
  name: str
  type: Optional[int]           # physical type of a leaf
  rep: int
  converted: Optional[int]
  logical: dict
  children: list


def _schema_tree(elems: List[dict]) -> _Node:
  pos = [0]

  def node():
    e = elems[pos[0]]
    pos[0] += 1
    n = _Node(name=e.get(4, b'').decode('utf-8'), type=e.get(1),
              rep=e.get(3, REQUIRED), converted=e.get(6),
              logical=e.get(10) or {}, children=[])
    n.children = [node() for _ in range(e.get(5, 0))]
    return n
  root = node()
  if pos[0] != len(elems):
    raise ParquetFormatError('the schema has elements outside its tree')
  return root


@dataclasses.dataclass
class Column:
  """A top-level column: its leaf's path and type, and the levels that
  tell its nulls (and, for a list, its rows) apart."""
  name: str
  path: Tuple[str, ...]
  leaf: _Node
  is_list: bool
  max_def: int
  max_rep: int
  def_row: int = 0        # a list row is null below this level
  def_elem: int = 0       # and empty below this one
  refused: str = ''       # why the port does not read it


def _columns(root: _Node) -> Dict[str, Column]:
  out = {}
  for top in root.children:
    nodes = [top]
    refused = ''
    is_list = False
    if top.children:
      rep_child = top.children[0] if len(top.children) == 1 else None
      if (top.converted == 3 or 3 in top.logical) and rep_child is not None \
          and rep_child.rep == REPEATED:
        is_list = True
        if not rep_child.children:                  # two-level list
          nodes.append(rep_child)
        elif len(rep_child.children) == 1 and \
            not rep_child.children[0].children:     # three-level list
          nodes += [rep_child, rep_child.children[0]]
        else:
          refused = 'a list of groups'
      else:
        refused = 'a group (struct or map)'
    elif top.rep == REPEATED:
      is_list = True
    if refused:
      out[top.name] = Column(top.name, (top.name,), top, False, 0, 0,
                             refused=refused)
      continue
    levels = [n.rep != REQUIRED for n in nodes]
    max_def, max_rep = sum(levels), sum(n.rep == REPEATED for n in nodes)
    col = Column(top.name, tuple(n.name for n in nodes), nodes[-1], is_list,
                 max_def, max_rep)
    if is_list:
      r = next(i for i, n in enumerate(nodes) if n.rep == REPEATED)
      col.def_row = sum(levels[:r])
      col.def_elem = sum(levels[:r + 1])
      if max_rep != 1:
        col.refused = 'a nested list'
    out[top.name] = col
  return out


def _value_kind(col: Column, path: str):
  """The numpy type of a leaf's values (object for strings); raises for
  the types the port does not read, naming the column."""
  leaf = col.leaf
  what = None
  if col.refused:
    what = col.refused
  elif leaf.type in (INT96, FIXED):
    what = 'physical type %s' % TYPE_NAMES[leaf.type]
  elif leaf.converted in _CONVERTED_REFUSED:
    what = 'annotation %s' % _CONVERTED_REFUSED[leaf.converted]
  elif any(k in leaf.logical for k in _LOGICAL_REFUSED):
    what = 'annotation %s' % next(_LOGICAL_REFUSED[k] for k in leaf.logical
                                  if k in _LOGICAL_REFUSED)
  if what is not None:
    raise NotImplementedError(
        'Parquet column %s of %s is %s, which the port does not read'
        % (col.name, path, what))
  if leaf.type == BYTE_ARRAY:
    return object
  if leaf.type == BOOLEAN:
    return np.bool_
  if leaf.type in (FLOAT, DOUBLE):
    return np.float32 if leaf.type == FLOAT else np.float64
  integer = leaf.logical.get(10)
  if integer:
    bits, signed = integer.get(1, 32), integer.get(2, True)
    return np.dtype('%s%d' % ('i' if signed else 'u', bits // 8)).type
  if leaf.converted in _CONVERTED_INTS:
    return _CONVERTED_INTS[leaf.converted]
  return np.int32 if leaf.type == INT32 else np.int64


# -- values --------------------------------------------------------------


@dataclasses.dataclass
class _Bytes:
  """Byte arrays: their bytes concatenated and offsets [n + 1]."""
  data: np.ndarray
  offsets: np.ndarray

  def __len__(self):
    return self.offsets.size - 1


def _concat_bytes(parts: Sequence[_Bytes]) -> _Bytes:
  """Byte arrays one after the other (each part's data is its values'
  bytes and no more, its offsets from 0)."""
  if len(parts) == 1:
    return parts[0]
  offs, base = [np.zeros(1, np.int64)], 0
  for p in parts:
    offs.append(p.offsets[1:] + base)
    base += int(p.offsets[-1])
  data = np.concatenate([p.data for p in parts]) if parts else \
      np.zeros(0, np.uint8)
  return _Bytes(data, np.concatenate(offs))


def _strings(b: _Bytes) -> np.ndarray:
  """Byte arrays -> an object array of str (UTF-8)."""
  raw = b.data.tobytes()
  o = b.offsets.tolist()
  out = np.empty(len(o) - 1, dtype=object)
  if raw.isascii():
    s = raw.decode('ascii')
    out[:] = [s[a:e] for a, e in zip(o[:-1], o[1:])]
  else:
    out[:] = [raw[a:e].decode('utf-8') for a, e in zip(o[:-1], o[1:])]
  return out


def _plain(buf: np.ndarray, pos: int, end: int, ptype: int, n: int):
  """n PLAIN values at buf[pos:end] -> (values, the position after)."""
  if ptype == BOOLEAN:
    nbytes = (n + 7) // 8
    if pos + nbytes > end:
      raise ParquetFormatError('PLAIN booleans past the page')
    bits = np.unpackbits(buf[pos:pos + nbytes], bitorder='little')
    return bits[:n].astype(np.bool_), pos + nbytes
  if ptype == BYTE_ARRAY:
    data, offsets, pos = po.split_byte_array(buf, pos, end, n)
    return _Bytes(data, offsets), pos
  dt = np.dtype(_PLAIN_DTYPES[ptype])
  if pos + n * dt.itemsize > end:
    raise ParquetFormatError('PLAIN values past the page')
  vals = np.frombuffer(buf, dtype=dt, count=n, offset=pos)
  return vals, pos + n * dt.itemsize


def _decompress(codec: int, data: np.ndarray, size: int, path: str,
                column: str) -> np.ndarray:
  if codec == 0:
    return data
  if codec == 1:
    return po.snappy_decompress(data, size)
  if codec == 2:
    out = zlib.decompressobj(47).decompress(data.tobytes())
    if len(out) != size:
      raise ParquetFormatError('GZIP page of %d bytes, its header says %d'
                               % (len(out), size))
    return np.frombuffer(out, np.uint8)
  name = CODEC_NAMES[codec] if 0 <= codec < len(CODEC_NAMES) else \
      'codec %d' % codec
  raise NotImplementedError(
      'Parquet codec %s (file %s, column %s) is not read by the port: '
      'write the file with SNAPPY, GZIP or no compression' % (name, path,
                                                               column))


class _ChunkDecoder:
  """The pages of one column chunk -> levels and values."""

  def __init__(self, col: Column, kind, codec: int, path: str):
    self.col = col
    self.kind = kind
    self.codec = codec
    self.path = path
    self.ptype = col.leaf.type
    self.dictionary = None
    self.values = []
    self.defs = []
    self.reps = []

  def _levels(self, buf, pos, end, max_level, n, prefixed):
    if max_level == 0:
      return None, pos
    if prefixed:
      if pos + 4 > end:
        raise ParquetFormatError('levels past the page')
      size = int.from_bytes(buf[pos:pos + 4].tobytes(), 'little')
      pos += 4
      end = pos + size
    width = int(max_level).bit_length()
    levels, _ = po.rle_bp_decode(buf, pos, end, width, n)
    return levels, end

  def _decode_values(self, buf, pos, end, encoding, n):
    ptype = self.ptype
    if encoding == PLAIN:
      return _plain(buf, pos, end, ptype, n)[0]
    if encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
      if self.dictionary is None:
        raise ParquetFormatError('dictionary indices before a dictionary')
      if n == 0:
        idx = np.zeros(0, np.int32)
      else:
        if pos >= end:
          raise ParquetFormatError('dictionary indices past the page')
        idx, _ = po.rle_bp_decode(buf, pos + 1, end, int(buf[pos]), n)
      d = self.dictionary
      if isinstance(d, _Bytes):
        return _Bytes(*po.gather_byte_array(d.data, d.offsets, idx))
      if n and (idx.min() < 0 or idx.max() >= len(d)):
        raise ParquetFormatError('dictionary index outside the dictionary')
      return d[idx]
    if encoding == RLE and ptype == BOOLEAN:
      size = int.from_bytes(buf[pos:pos + 4].tobytes(), 'little')
      vals, _ = po.rle_bp_decode(buf, pos + 4, min(end, pos + 4 + size), 1,
                                 n)
      return vals.astype(np.bool_)
    if encoding == DELTA_BINARY_PACKED and ptype in (INT32, INT64):
      vals, _ = po.delta_binary_packed(buf, pos, end,
                                       32 if ptype == INT32 else 64, n)
      return vals.astype(np.int32) if ptype == INT32 else vals
    if encoding == DELTA_LENGTH_BYTE_ARRAY and ptype == BYTE_ARRAY:
      data, offsets, _ = po.delta_length_byte_array(buf, pos, end, n)
      return _Bytes(data, offsets)
    if encoding == DELTA_BYTE_ARRAY and ptype == BYTE_ARRAY:
      data, offsets, _ = po.delta_byte_array(buf, pos, end, n)
      return _Bytes(data, offsets)
    if encoding == BYTE_STREAM_SPLIT and ptype in _PLAIN_DTYPES:
      dt = np.dtype(_PLAIN_DTYPES[ptype])
      if pos + n * dt.itemsize > end:
        raise ParquetFormatError('BYTE_STREAM_SPLIT values past the page')
      streams = buf[pos:pos + n * dt.itemsize].reshape(dt.itemsize, n)
      return np.ascontiguousarray(streams.T).view(dt).reshape(n)
    raise NotImplementedError(
        'Parquet encoding %s of a %s column (file %s, column %s) is not '
        'read by the port' % (ENCODING_NAMES.get(encoding, encoding),
                              TYPE_NAMES[ptype], self.path, self.col.name))

  def page(self, header: dict, raw: np.ndarray) -> None:
    """Decode one page (an index page is skipped)."""
    ptype_page = header.get(1)
    size = header.get(2, 0)
    col = self.col
    if ptype_page == DICTIONARY_PAGE:
      dh = header.get(7, {})
      buf = _decompress(self.codec, raw, size, self.path, col.name)
      if dh.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
        raise ParquetFormatError('a dictionary page not PLAIN-encoded')
      self.dictionary, _ = _plain(buf, 0, buf.size, self.ptype,
                                  dh.get(1, 0))
      return
    if ptype_page == DATA_PAGE:
      dh = header[5]
      n = dh[1]
      buf = _decompress(self.codec, raw, size, self.path, col.name)
      pos, end = 0, buf.size
      reps, pos = self._levels(buf, pos, end, col.max_rep, n, True)
      defs, pos = self._levels(buf, pos, end, col.max_def, n, True)
      encoding = dh[2]
    elif ptype_page == DATA_PAGE_V2:
      dh = header[8]
      n, encoding = dh[1], dh[4]
      def_len, rep_len = dh.get(5, 0), dh.get(6, 0)
      reps, _ = self._levels(raw, 0, rep_len, col.max_rep, n, False)
      defs, _ = self._levels(raw, rep_len, rep_len + def_len, col.max_def, n,
                             False)
      body = raw[rep_len + def_len:]
      if dh.get(7, True):
        body = _decompress(self.codec, body, size - rep_len - def_len,
                           self.path, col.name)
      buf, pos, end = body, 0, body.size
    else:
      return                            # an index page
    present = n if defs is None else int((defs == col.max_def).sum())
    self.values.append(self._decode_values(buf, pos, end, encoding, present))
    if defs is not None:
      self.defs.append(defs)
    if reps is not None:
      self.reps.append(reps)

  def column(self, n_rows: int):
    """The chunk's rows: (values, nulls) as iter_batches yields them."""
    col, kind = self.col, self.kind
    if self.ptype == BYTE_ARRAY:
      vals = _strings(_concat_bytes(self.values))
    elif self.values:
      vals = np.concatenate(self.values).astype(kind, copy=False)
    else:
      vals = np.zeros(0, kind)
    defs = np.concatenate(self.defs) if self.defs else None
    if not col.is_list:
      if defs is None or col.max_def == 0:
        return vals, None
      valid = defs == col.max_def
      if valid.all():
        return vals, None
      full = np.full(valid.size, None, object) if kind is object else \
          np.zeros(valid.size, kind)
      full[valid] = vals
      return full, ~valid
    reps = np.concatenate(self.reps)
    defs = defs if defs is not None else np.full(reps.size, col.max_def,
                                                 np.int32)
    starts = np.flatnonzero(reps == 0)
    if starts.size != n_rows:
      raise ParquetFormatError('column %s holds %d rows, its row group %d'
                               % (col.name, starts.size, n_rows))
    has = defs >= col.def_elem
    valid = defs == col.max_def
    elems = np.full(int(has.sum()), None, object)
    elems[valid[has]] = vals if kind is object else vals.tolist()
    elems = elems.tolist()
    row_of = np.cumsum(reps == 0) - 1
    bounds = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(row_of[has], minlength=n_rows), out=bounds[1:])
    null_row = defs[starts] < col.def_row
    out = np.empty(n_rows, object)
    b = bounds.tolist()
    for i in range(n_rows):
      out[i] = None if null_row[i] else elems[b[i]:b[i + 1]]
    return out, None


def _concat_columns(parts: List[tuple]) -> tuple:
  """(values, nulls) parts of one column, one after the other."""
  if len(parts) == 1:
    return parts[0]
  values = np.concatenate([p[0] for p in parts])
  if all(p[1] is None for p in parts):
    return values, None
  return values, np.concatenate([
      p[1] if p[1] is not None else np.zeros(len(p[0]), np.bool_)
      for p in parts])


class ParquetFile:
  """One Parquet file: its top-level columns (`names`, `columns`) and row
  groups; iter_batches reads them."""

  def __init__(self, path: str):
    self.path = path
    with open(path, 'rb') as f:
      head = f.read(4)
      f.seek(0, 2)
      size = f.tell()
      if size < 12 or head != MAGIC:
        raise ParquetFormatError('%s is not a Parquet file' % path)
      f.seek(size - 8)
      tail = f.read(8)
      if tail[4:] != MAGIC:
        raise ParquetFormatError('%s has no Parquet footer' % path)
      meta_len = int.from_bytes(tail[:4], 'little')
      f.seek(size - 8 - meta_len)
      meta = _Compact(f.read(meta_len)).read_struct()
    self.columns = _columns(_schema_tree(meta.get(2, [])))
    self.names = list(self.columns)
    self.row_groups = meta.get(4, [])

  def _chunk(self, i: int, name: str) -> dict:
    """The ColumnMetaData of column `name` in row group i."""
    path = self.columns[name].path
    for c in self.row_groups[i].get(1, []):
      if tuple(p.decode('utf-8') for p in c[3][3]) == path:
        return c[3]
    raise ParquetFormatError('row group %d of %s has no column %s'
                             % (i, self.path, name))

  def pages(self, i: int, name: str) -> Iterator[Tuple[dict, np.ndarray]]:
    """The pages of column `name` in row group i: (PageHeader as {field
    id: value}, the page's bytes as stored), until the chunk's values."""
    meta = self._chunk(i, name)
    start = meta[9]
    dict_off = meta.get(11)
    if dict_off and 0 < dict_off < start:
      start = dict_off
    with open(self.path, 'rb') as f:
      f.seek(start)
      raw = np.frombuffer(f.read(meta[7]), np.uint8)
    pos, left = 0, meta[5]
    while left > 0:
      c = _Compact(raw, pos)
      header = c.read_struct()
      size = header.get(3, 0)
      body = raw[c.pos:c.pos + size]
      if body.size != size:
        raise ParquetFormatError('a page of column %s runs past its chunk '
                                 'in %s' % (name, self.path))
      pos = c.pos + size
      if header.get(1) == DATA_PAGE:
        left -= header[5][1]
      elif header.get(1) == DATA_PAGE_V2:
        left -= header[8][1]
      yield header, body

  def read_row_group(self, i: int, names: Sequence[str]) -> Dict[str, tuple]:
    """Row group i's columns `names` -> {name: (values, nulls)}."""
    out = {}
    for name in names:
      col = self.columns[name]
      dec = _ChunkDecoder(col, _value_kind(col, self.path),
                          self._chunk(i, name).get(4, 0), self.path)
      for header, body in self.pages(i, name):
        dec.page(header, body)
      out[name] = dec.column(self.row_groups[i].get(3, 0))
    return out

  def iter_batches(self, batch_size: int,
                   columns: Sequence[str]) -> Iterator[Dict[str, tuple]]:
    """The columns batch_size rows at a time, across row groups (the last
    batch holds the rest)."""
    names = list(columns)
    pending: List[Dict[str, tuple]] = []
    have = 0
    for i, rg in enumerate(self.row_groups):
      if not rg.get(3, 0):
        continue
      pending.append(self.read_row_group(i, names))
      have += rg[3]
      while have >= batch_size:
        merged = {n: _concat_columns([p[n] for p in pending]) for n in names}
        yield {n: _rows(v, 0, batch_size) for n, v in merged.items()}
        pending = [{n: _rows(v, batch_size, have)
                    for n, v in merged.items()}]
        have -= batch_size
    if have:
      yield {n: _concat_columns([p[n] for p in pending]) for n in names}


def _rows(col: tuple, lo: int, hi: int) -> tuple:
  values, nulls = col
  return values[lo:hi], (None if nulls is None or not nulls[lo:hi].any()
                         else nulls[lo:hi])
