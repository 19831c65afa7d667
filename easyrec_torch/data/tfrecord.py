"""TFRecord reading without TensorFlow or protobuf.

A copy of the reader of easyrec_tpu/data/tfrecord.py (read_records and
its CRC32-C, with its pure-Python table where the `crc32c` package is
missing, as on the GPU machine), with tf.Example payloads decoded from the
protobuf wire format here, since the port imports no protobuf runtime.

Wire format (tensorflow/core/lib/io/record_writer.h):
  uint64 length | uint32 masked_crc32(length) | bytes data |
  uint32 masked_crc32(data)
The CRCs are CRC32-C (Castagnoli) with TF's rotation mask.

tf.Example (tensorflow/core/example/{example,feature}.proto):
  Example { Features features = 1; }
  Features { map<string, Feature> feature = 1; }
  Feature { oneof kind { BytesList bytes_list = 1; FloatList float_list = 2;
                         Int64List int64_list = 3; } }
  BytesList { repeated bytes value = 1; }
  FloatList { repeated float value = 1 [packed = true]; }
  Int64List { repeated int64 value = 1 [packed = true]; }
"""

from __future__ import annotations

import gzip
import struct
from typing import Dict, Iterator, List, Tuple

_MASK_DELTA = 0xa282ead8

_CRC_TABLE = []
_POLY = 0x82F63B78  # CRC32-C reversed polynomial
for _i in range(256):
  _c = _i
  for _ in range(8):
    _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
  _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
  crc = 0xFFFFFFFF
  for b in data:
    crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


try:  # zlib's crc32 is not Castagnoli; the crc32c package may be missing
  import crc32c as _crc32c_mod

  def _crc32c(data: bytes) -> int:  # noqa: F811
    return _crc32c_mod.crc32c(data)
except ImportError:
  pass


def _masked_crc(data: bytes) -> int:
  crc = _crc32c(data)
  return ((((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF)


def read_records(path: str, verify_crc: bool = False,
                 compression: str = '') -> Iterator[bytes]:
  """Yield the record payloads of a TFRecord file; GZIP by
  `compression` (data_config.data_compression_type) or a .gz suffix."""
  opener = gzip.open if (compression.upper() == 'GZIP' or
                         path.endswith('.gz')) else open
  with opener(path, 'rb') as f:
    while True:
      header = f.read(12)
      if len(header) < 12:
        return
      length, len_crc = struct.unpack('<QI', header)
      if verify_crc and _masked_crc(header[:8]) != len_crc:
        raise IOError('corrupt TFRecord length crc in %s' % path)
      data = f.read(length)
      crc = f.read(4)
      if len(data) < length or len(crc) < 4:
        return  # truncated tail
      if verify_crc and _masked_crc(data) != struct.unpack('<I', crc)[0]:
        raise IOError('corrupt TFRecord data crc in %s' % path)
      yield data


# -- protobuf wire format ------------------------------------------------


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
  result = shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
  """(field number, wire type, value) of a message: an int for varints,
  bytes for length-delimited fields, the raw bytes of fixed ones."""
  pos, end = 0, len(buf)
  while pos < end:
    key, pos = _varint(buf, pos)
    number, wire = key >> 3, key & 7
    if wire == 0:
      value, pos = _varint(buf, pos)
    elif wire == 2:
      n, pos = _varint(buf, pos)
      value, pos = buf[pos:pos + n], pos + n
    elif wire == 5:
      value, pos = buf[pos:pos + 4], pos + 4
    elif wire == 1:
      value, pos = buf[pos:pos + 8], pos + 8
    else:
      raise ValueError('unsupported protobuf wire type %d' % wire)
    yield number, wire, value


def _int64(v: int) -> int:
  return v - (1 << 64) if v >= 1 << 63 else v


def _feature(buf: bytes):
  """A Feature -> (kind, values): 'bytes_list' with bytes values,
  'float_list' with floats, 'int64_list' with ints, or (None, [])."""
  for number, _, value in _fields(buf):
    if number not in (1, 2, 3):
      continue
    values: List[object] = []
    for n, wire, v in _fields(value):
      if n != 1:
        continue
      if number == 1:
        values.append(bytes(v))
      elif number == 2:
        if wire == 2:            # packed
          values.extend(struct.unpack('<%df' % (len(v) // 4), v))
        else:
          values.append(struct.unpack('<f', v)[0])
      elif wire == 2:            # packed int64
        pos = 0
        while pos < len(v):
          x, pos = _varint(v, pos)
          values.append(_int64(x))
      else:
        values.append(_int64(v))
    return ('bytes_list', 'float_list', 'int64_list')[number - 1], values
  return None, []


def parse_example(payload: bytes) -> Dict[str, Tuple[object, list]]:
  """A serialized tf.Example -> {feature name: (kind, values)}."""
  out = {}
  for number, _, features in _fields(payload):
    if number != 1:
      continue
    for n, _, entry in _fields(features):
      if n != 1:
        continue
      key, feat = '', b''
      for m, _, v in _fields(entry):
        if m == 1:
          key = bytes(v).decode('utf-8')
        elif m == 2:
          feat = v
      out[key] = _feature(feat)
  return out


def example_to_columns(payloads, field_names):
  """tf.Example payloads -> {name: list} columns, each value as the JAX
  package's example_to_columns gives it: a bytes list decoded and joined
  by '|', one number as itself, several as a list, '' where the feature
  is missing or empty."""
  cols = {name: [] for name in field_names}
  for payload in payloads:
    feats = parse_example(payload)
    for name in field_names:
      kind, vals = feats.get(name, (None, []))
      if kind == 'bytes_list':
        vals = [v.decode('utf-8', 'replace') for v in vals]
        cols[name].append(vals[0] if len(vals) == 1 else '|'.join(vals))
      elif kind in ('float_list', 'int64_list'):
        cols[name].append(vals[0] if len(vals) == 1 else vals)
      else:
        cols[name].append('')
  return cols
