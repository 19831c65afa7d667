"""The hot loops of the Parquet decoder (data/parquet.py), native and plain.

Snappy decompression, the RLE / bit-packed hybrid, the split of PLAIN
BYTE_ARRAY values, a dictionary's byte arrays gathered by index and the
DELTA decoders run in ops/native/parquet_ops.cc, built with g++ at first
use into build/easyrec_torch/. A failed build raises: there is no quiet
fallback to the plain versions (`plain_*`), pure Python and numpy with the
same semantics, which the tests hold the native functions to bit for bit.

Buffers are numpy uint8 arrays; byte arrays travel as (data uint8,
offsets int64 [n + 1]). Malformed input raises ParquetFormatError.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Tuple

import numpy as np

from easyrec_torch.ops.native_build import GXX_FLAGS, NativeBuild

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'native',
                       'parquet_ops.cc')
_lock = threading.Lock()
_lib = None

_U8 = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_i64 = ctypes.c_int64


class ParquetFormatError(ValueError):
  """A Parquet file's bytes do not decode."""


def native() -> ctypes.CDLL:
  """The native library, built with g++ at the first call (a failed build
  raises with the compiler's output)."""
  global _lib
  with _lock:
    if _lib is None:
      lib = NativeBuild(_SOURCE, ['g++'], GXX_FLAGS).load()
      for name, args in (
          ('pq_snappy_decompress', [_U8, _i64, _U8, _i64]),
          ('pq_rle_bp_decode', [_U8, _i64, _i64, ctypes.c_int, _i64, _I32]),
          ('pq_split_byte_array', [_U8, _i64, _i64, _i64, _U8, _I64]),
          ('pq_gather_byte_array', [_U8, _I64, _i64, _I32, _i64, _U8, _i64,
                                    _I64]),
          ('pq_delta_binary_packed', [_U8, _i64, _i64, ctypes.c_int, _i64,
                                      _I64]),
          ('pq_delta_byte_array_build', [_I64, _U8, _I64, _i64, _U8, _i64,
                                         _I64])):
        fn = getattr(lib, name)
        fn.restype = _i64
        fn.argtypes = args
      _lib = lib
  return _lib


def _p(arr: np.ndarray, ctype):
  return arr.ctypes.data_as(ctype)


def _as_buffer(data) -> np.ndarray:
  """bytes, bytearray, memoryview or uint8 array -> a uint8 array (no
  copy where the input allows)."""
  if isinstance(data, np.ndarray):
    return data.view(np.uint8).reshape(-1)
  return np.frombuffer(data, dtype=np.uint8)


def _span(buf: np.ndarray, pos: int, end: int) -> None:
  """pos and end must lie within buf: native code reads buf[pos:end]."""
  if not 0 <= pos <= end <= buf.size:
    raise ParquetFormatError('bytes [%d, %d) outside a buffer of %d'
                             % (pos, end, buf.size))


def _check(ret: int, what: str) -> int:
  if ret < 0:
    raise ParquetFormatError('malformed %s' % what)
  return int(ret)


# -- native --------------------------------------------------------------


def snappy_decompress(src, size: int) -> np.ndarray:
  """A Snappy raw-format block -> its `size` bytes."""
  src = _as_buffer(src)
  out = np.empty(size, np.uint8)
  _check(native().pq_snappy_decompress(_p(src, _U8), src.size,
                                        _p(out, _U8), size),
         'snappy block')
  return out


def rle_bp_decode(buf, pos: int, end: int, bit_width: int,
                  n: int) -> Tuple[np.ndarray, int]:
  """n values of the RLE / bit-packed hybrid at buf[pos:end] -> (int32
  values, the position after the last run read)."""
  buf = _as_buffer(buf)
  _span(buf, pos, end)
  out = np.empty(n, np.int32)
  ret = native().pq_rle_bp_decode(_p(buf, _U8), pos, end, bit_width, n,
                                   _p(out, _I32))
  return out, _check(ret, 'RLE/bit-packed run')


def split_byte_array(buf, pos: int, end: int,
                     n: int) -> Tuple[np.ndarray, np.ndarray, int]:
  """n PLAIN BYTE_ARRAY values at buf[pos:end] -> (data, offsets, the
  position after them)."""
  buf = _as_buffer(buf)
  _span(buf, pos, end)
  data = np.empty(end - pos, np.uint8)
  offsets = np.empty(n + 1, np.int64)
  ret = native().pq_split_byte_array(_p(buf, _U8), pos, end, n,
                                      _p(data, _U8), _p(offsets, _I64))
  ret = _check(ret, 'PLAIN BYTE_ARRAY values')
  return data[:offsets[-1]], offsets, ret


def gather_byte_array(data: np.ndarray, offsets: np.ndarray,
                      idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  """The byte arrays (data, offsets) at the indices idx -> (data,
  offsets)."""
  idx = np.ascontiguousarray(idx, dtype=np.int32)
  data, offsets = _as_buffer(data), np.ascontiguousarray(offsets, np.int64)
  n_dict = offsets.size - 1
  lens = np.diff(offsets)
  cap = int(lens[np.clip(idx, 0, max(n_dict - 1, 0))].sum()) if n_dict \
      else 0
  out = np.empty(cap, np.uint8)
  out_offsets = np.empty(idx.size + 1, np.int64)
  _check(native().pq_gather_byte_array(
      _p(data, _U8), _p(offsets, _I64), n_dict, _p(idx, _I32), idx.size,
      _p(out, _U8), cap, _p(out_offsets, _I64)), 'dictionary index')
  return out, out_offsets


def delta_binary_packed(buf, pos: int, end: int, width: int,
                        n: int) -> Tuple[np.ndarray, int]:
  """One DELTA_BINARY_PACKED stream of n `width` (32 or 64) bit integers
  at buf[pos:end] -> (int64 values, the position after the stream)."""
  buf = _as_buffer(buf)
  _span(buf, pos, end)
  out = np.empty(n, np.int64)
  ret = native().pq_delta_binary_packed(_p(buf, _U8), pos, end, width, n,
                                         _p(out, _I64))
  return out, _check(ret, 'DELTA_BINARY_PACKED stream')


def delta_byte_array_build(prefix: np.ndarray, sdata: np.ndarray,
                           soff: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  """DELTA_BYTE_ARRAY's prefix lengths and suffixes (sdata, soff) -> the
  values (data, offsets)."""
  prefix = np.ascontiguousarray(prefix, np.int64)
  sdata, soff = _as_buffer(sdata), np.ascontiguousarray(soff, np.int64)
  n = prefix.size
  cap = int(np.clip(prefix, 0, None).sum()) + int(soff[-1] - soff[0])
  out = np.empty(cap, np.uint8)
  out_offsets = np.empty(n + 1, np.int64)
  _check(native().pq_delta_byte_array_build(
      _p(prefix, _I64), _p(sdata, _U8), _p(soff, _I64), n, _p(out, _U8), cap,
      _p(out_offsets, _I64)), 'DELTA_BYTE_ARRAY prefix')
  return out, out_offsets


def delta_length_byte_array(buf, pos: int, end: int, n: int,
                            dbp=None) -> Tuple[np.ndarray, np.ndarray, int]:
  """n DELTA_LENGTH_BYTE_ARRAY values at buf[pos:end]: their lengths as
  one DELTA_BINARY_PACKED stream, then their bytes -> (data, offsets, the
  position after them)."""
  buf = _as_buffer(buf)
  lens, pos = (dbp or delta_binary_packed)(buf, pos, end, 32, n)
  if (lens < 0).any():
    raise ParquetFormatError('malformed DELTA_LENGTH_BYTE_ARRAY lengths')
  offsets = np.zeros(n + 1, np.int64)
  np.cumsum(lens, out=offsets[1:])
  if pos + offsets[-1] > end:
    raise ParquetFormatError('DELTA_LENGTH_BYTE_ARRAY values past the page')
  return buf[pos:pos + offsets[-1]], offsets, int(pos + offsets[-1])


def delta_byte_array(buf, pos: int, end: int, n: int, dbp=None,
                     build=None) -> Tuple[np.ndarray, np.ndarray, int]:
  """n DELTA_BYTE_ARRAY values at buf[pos:end]: their prefix lengths as
  one DELTA_BINARY_PACKED stream, then their suffixes as
  DELTA_LENGTH_BYTE_ARRAY -> (data, offsets, the position after them)."""
  buf = _as_buffer(buf)
  dbp = dbp or delta_binary_packed
  prefix, pos = dbp(buf, pos, end, 32, n)
  sdata, soff, pos = delta_length_byte_array(buf, pos, end, n, dbp)
  data, offsets = (build or delta_byte_array_build)(prefix, sdata, soff)
  return data, offsets, pos


# -- plain ---------------------------------------------------------------


def _uleb(buf: bytes, pos: int, end: int) -> Tuple[int, int]:
  v = shift = 0
  while True:
    if pos >= end or shift > 63:
      raise ParquetFormatError('malformed varint')
    b = buf[pos]
    pos += 1
    v |= (b & 0x7f) << shift
    if not b & 0x80:
      return v & 0xffffffffffffffff, pos
    shift += 7


def _unzigzag(v: int) -> int:
  return (v >> 1) ^ -(v & 1)


def plain_snappy_decompress(src, size: int) -> np.ndarray:
  src = bytes(_as_buffer(src))
  n = len(src)
  length, i = _uleb(src, 0, n)
  if length != size:
    raise ParquetFormatError('malformed snappy block')
  out = bytearray()
  while i < n:
    tag = src[i]
    i += 1
    kind = tag & 3
    if kind == 0:
      size_ = tag >> 2
      if size_ >= 60:
        nb = size_ - 59
        if i + nb > n:
          raise ParquetFormatError('malformed snappy block')
        size_ = int.from_bytes(src[i:i + nb], 'little')
        i += nb
      size_ += 1
      if size_ > n - i or size_ > size - len(out):
        raise ParquetFormatError('malformed snappy block')
      out += src[i:i + size_]
      i += size_
      continue
    if kind == 1:
      if i >= n:
        raise ParquetFormatError('malformed snappy block')
      size_, off = 4 + ((tag >> 2) & 7), ((tag >> 5) << 8) | src[i]
      i += 1
    else:
      nb = 2 if kind == 2 else 4
      if i + nb > n:
        raise ParquetFormatError('malformed snappy block')
      size_, off = 1 + (tag >> 2), int.from_bytes(src[i:i + nb], 'little')
      i += nb
    if off == 0 or off > len(out) or size_ > size - len(out):
      raise ParquetFormatError('malformed snappy block')
    for _ in range(size_):
      out.append(out[-off])
  if len(out) != size:
    raise ParquetFormatError('malformed snappy block')
  return np.frombuffer(bytes(out), np.uint8)


def plain_rle_bp_decode(buf, pos: int, end: int, bit_width: int,
                        n: int) -> Tuple[np.ndarray, int]:
  _span(_as_buffer(buf), pos, end)
  buf = bytes(_as_buffer(buf))
  if not 0 <= bit_width <= 32:
    raise ParquetFormatError('malformed RLE/bit-packed run')
  mask = (1 << bit_width) - 1
  vbytes = (bit_width + 7) // 8
  out = []
  while len(out) < n:
    h, pos = _uleb(buf, pos, end)
    if h & 1:
      count, nbytes = (h >> 1) * 8, (h >> 1) * bit_width
      need = min(count, n - len(out))
      if (need * bit_width + 7) // 8 > end - pos:
        raise ParquetFormatError('malformed RLE/bit-packed run')
      bits = int.from_bytes(buf[pos:pos + (need * bit_width + 7) // 8],
                            'little')
      out.extend((bits >> (k * bit_width)) & mask for k in range(need))
      pos = min(pos + nbytes, end)
    else:
      if vbytes > end - pos:
        raise ParquetFormatError('malformed RLE/bit-packed run')
      v = int.from_bytes(buf[pos:pos + vbytes], 'little')
      pos += vbytes
      out.extend([v] * min(h >> 1, n - len(out)))
  return np.array(out, np.uint32).view(np.int32), pos


def plain_split_byte_array(buf, pos: int, end: int,
                           n: int) -> Tuple[np.ndarray, np.ndarray, int]:
  _span(_as_buffer(buf), pos, end)
  buf = bytes(_as_buffer(buf))
  parts, offsets = [], [0]
  for _ in range(n):
    if end - pos < 4:
      raise ParquetFormatError('malformed PLAIN BYTE_ARRAY values')
    size = int.from_bytes(buf[pos:pos + 4], 'little')
    pos += 4
    if size > end - pos:
      raise ParquetFormatError('malformed PLAIN BYTE_ARRAY values')
    parts.append(buf[pos:pos + size])
    pos += size
    offsets.append(offsets[-1] + size)
  return (np.frombuffer(b''.join(parts), np.uint8),
          np.array(offsets, np.int64), pos)


def plain_gather_byte_array(data, offsets,
                            idx) -> Tuple[np.ndarray, np.ndarray]:
  data = bytes(_as_buffer(data))
  offsets = [int(o) for o in offsets]
  parts, out_offsets = [], [0]
  for j in np.asarray(idx).tolist():
    if not 0 <= j < len(offsets) - 1:
      raise ParquetFormatError('malformed dictionary index')
    parts.append(data[offsets[j]:offsets[j + 1]])
    out_offsets.append(out_offsets[-1] + offsets[j + 1] - offsets[j])
  return (np.frombuffer(b''.join(parts), np.uint8),
          np.array(out_offsets, np.int64))


def plain_delta_binary_packed(buf, pos: int, end: int, width: int,
                              n: int) -> Tuple[np.ndarray, int]:
  _span(_as_buffer(buf), pos, end)
  buf = bytes(_as_buffer(buf))
  if width not in (32, 64):
    raise ParquetFormatError('malformed DELTA_BINARY_PACKED stream')
  block, pos = _uleb(buf, pos, end)
  minis, pos = _uleb(buf, pos, end)
  total, pos = _uleb(buf, pos, end)
  first, pos = _uleb(buf, pos, end)
  if not minis or not block or block % minis or (block // minis) % 8 or \
      block > 1 << 20 or total != n:
    raise ParquetFormatError('malformed DELTA_BINARY_PACKED stream')
  wmask = (1 << width) - 1
  out = []
  if total:
    prev = _unzigzag(first) & wmask
    out.append(prev)
  per_mini = block // minis
  while len(out) < total:
    zz, pos = _uleb(buf, pos, end)
    min_delta = _unzigzag(zz)
    if minis > end - pos:
      raise ParquetFormatError('malformed DELTA_BINARY_PACKED stream')
    widths = buf[pos:pos + minis]
    pos += minis
    for bw in widths:
      if len(out) >= total:
        break
      if bw > width:
        raise ParquetFormatError('malformed DELTA_BINARY_PACKED stream')
      nbytes = per_mini * bw // 8
      if nbytes > end - pos:
        raise ParquetFormatError('malformed DELTA_BINARY_PACKED stream')
      bits = int.from_bytes(buf[pos:pos + nbytes], 'little')
      mask = (1 << bw) - 1
      for k in range(min(per_mini, total - len(out))):
        prev = (prev + min_delta + ((bits >> (k * bw)) & mask)) & wmask
        out.append(prev)
      pos += nbytes
  vals = np.array(out, np.uint64)
  vals = vals.astype(np.uint32).view(np.int32).astype(np.int64) \
      if width == 32 else vals.view(np.int64)
  return vals, pos


def plain_delta_byte_array_build(prefix, sdata,
                                 soff) -> Tuple[np.ndarray, np.ndarray]:
  sdata = bytes(_as_buffer(sdata))
  prev, parts, offsets = b'', [], [0]
  for k, pre in enumerate(np.asarray(prefix).tolist()):
    if not 0 <= pre <= len(prev):
      raise ParquetFormatError('malformed DELTA_BYTE_ARRAY prefix')
    prev = prev[:pre] + sdata[int(soff[k]):int(soff[k + 1])]
    parts.append(prev)
    offsets.append(offsets[-1] + len(prev))
  return (np.frombuffer(b''.join(parts), np.uint8),
          np.array(offsets, np.int64))


def plain_delta_length_byte_array(buf, pos: int, end: int, n: int):
  return delta_length_byte_array(buf, pos, end, n,
                                 dbp=plain_delta_binary_packed)


def plain_delta_byte_array(buf, pos: int, end: int, n: int):
  return delta_byte_array(buf, pos, end, n, dbp=plain_delta_binary_packed,
                          build=plain_delta_byte_array_build)
