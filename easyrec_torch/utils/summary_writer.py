"""TensorBoard event-file writer without TensorFlow.

A copy of easyrec_tpu/utils/summary_writer.py: the trainer writes
`events.out.tfevents.*` files by hand, each record a serialized
`tensorflow.Event` proto framed like a TFRecord (length + masked crc32c,
the port's data/tfrecord.py). Only the subset TensorBoard needs for
scalars is encoded:

  Event   { double wall_time=1; int64 step=2;
            string file_version=3; Summary summary=5; }
  Summary { repeated Value value=1; }
  Value   { string tag=1; float simple_value=2; }

so the files open in stock TensorBoard / tbparse with zero TF deps here.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, Optional, Tuple

from easyrec_torch.data.tfrecord import _masked_crc, read_records


# -- minimal protobuf wire encoding ------------------------------------------


def _varint(n: int) -> bytes:
  out = bytearray()
  while True:
    b = n & 0x7F
    n >>= 7
    if n:
      out.append(b | 0x80)
    else:
      out.append(b)
      return bytes(out)


def _key(field: int, wire: int) -> bytes:
  return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
  return _key(field, 1) + struct.pack('<d', v)


def _f_float(field: int, v: float) -> bytes:
  return _key(field, 5) + struct.pack('<f', float(v))


def _f_int64(field: int, v: int) -> bytes:
  return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, b: bytes) -> bytes:
  return _key(field, 2) + _varint(len(b)) + b


def encode_event(wall_time: float, step: int = 0,
                 file_version: Optional[str] = None,
                 scalars: Optional[Dict[str, float]] = None) -> bytes:
  msg = _f_double(1, wall_time) + _f_int64(2, step)
  if file_version is not None:
    msg += _f_bytes(3, file_version.encode())
  if scalars:
    summary = b''.join(
        _f_bytes(1, _f_bytes(1, tag.encode()) + _f_float(2, val))
        for tag, val in scalars.items())
    msg += _f_bytes(5, summary)
  return msg


# -- minimal decoding (for tests / tooling) -----------------------------------


def _iter_fields(data: bytes):
  i, n = 0, len(data)
  while i < n:
    key, shift = 0, 0
    while True:
      b = data[i]
      i += 1
      key |= (b & 0x7F) << shift
      shift += 7
      if not b & 0x80:
        break
    field, wire = key >> 3, key & 7
    if wire == 0:
      v, shift = 0, 0
      while True:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
          break
      yield field, v
    elif wire == 1:
      yield field, data[i:i + 8]
      i += 8
    elif wire == 5:
      yield field, data[i:i + 4]
      i += 4
    elif wire == 2:
      ln, shift = 0, 0
      while True:
        b = data[i]
        i += 1
        ln |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
          break
      yield field, data[i:i + ln]
      i += ln
    else:
      raise ValueError('unsupported wire type %d' % wire)


def iter_events(path: str) -> Iterator[Tuple[int, Dict[str, float]]]:
  """Yield (step, {tag: value}) for every scalar-carrying event."""
  for rec in read_records(path, verify_crc=True):
    step, scalars = 0, {}
    for field, val in _iter_fields(rec):
      if field == 2:
        step = val
      elif field == 5:
        for f2, v2 in _iter_fields(val):
          if f2 != 1:
            continue
          tag, simple = None, None
          for f3, v3 in _iter_fields(v2):
            if f3 == 1:
              tag = v3.decode()
            elif f3 == 2:
              simple = struct.unpack('<f', v3)[0]
          if tag is not None and simple is not None:
            scalars[tag] = simple
    if scalars:
      yield step, scalars


# -- the writer ----------------------------------------------------------------


class SummaryWriter:
  """Appends scalar events to `<logdir>/events.out.tfevents.<ts>.<host>`."""

  def __init__(self, logdir: str):
    os.makedirs(logdir, exist_ok=True)
    name = 'events.out.tfevents.%d.%s' % (int(time.time()),
                                          socket.gethostname())
    self.path = os.path.join(logdir, name)
    self._f = open(self.path, 'ab')
    self._write(encode_event(time.time(), file_version='brain.Event:2'))

  def _write(self, payload: bytes):
    header = struct.pack('<Q', len(payload))
    self._f.write(header)
    self._f.write(struct.pack('<I', _masked_crc(header)))
    self._f.write(payload)
    self._f.write(struct.pack('<I', _masked_crc(payload)))

  def add_scalar(self, tag: str, value: float, step: int):
    self.add_scalars({tag: value}, step)

  def add_scalars(self, scalars: Dict[str, float], step: int):
    clean = {k: float(v) for k, v in scalars.items()}
    self._write(encode_event(time.time(), step=int(step), scalars=clean))

  def flush(self):
    self._f.flush()

  def close(self):
    if not self._f.closed:
      self._f.flush()
      self._f.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
