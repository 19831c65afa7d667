"""Host-side text features: the string functions of the ExprFeature DSL.

Counterpart of easyrec_tpu/ops/text_ops.py. Normalisation, edit distance
and term overlap run in the port's native library (ops/native/hash_ops.cc,
a copy of the JAX package's native_ops.cc:121-206, built with g++ at first
use); a failed build raises, there is no quiet fallback. Each has a plain
Python version, `plain_*`, with the native code's byte-wise semantics
(strings are their UTF-8 bytes; edit distance over the first 256 bytes of
each; term overlap over the first 64 terms of a), which the tests hold the
native functions to. mapped_dot_product is Python in both packages.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np

from easyrec_torch.ops import hashing

_lock = threading.Lock()
_declared = False

_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)


def _lib() -> ctypes.CDLL:
  global _declared
  lib = hashing._native()
  with _lock:
    if not _declared:
      lib.text_normalize_inplace.restype = None
      lib.text_normalize_inplace.argtypes = [ctypes.c_char_p,
                                             ctypes.c_int64]
      lib.edit_distance_batch.restype = None
      lib.edit_distance_batch.argtypes = [
          ctypes.c_char_p, _P64, ctypes.c_char_p, _P64, ctypes.c_int64,
          _P32]
      lib.term_overlap_batch.restype = None
      lib.term_overlap_batch.argtypes = [
          ctypes.c_char_p, _P64, ctypes.c_char_p, _P64, ctypes.c_int64,
          ctypes.c_char, _P32, _P32, _P32]
      _declared = True
  return lib


def _encoded(col) -> list:
  """Each value's UTF-8 bytes (None as b'')."""
  return [str(v).encode('utf-8', 'replace') if v is not None else b''
          for v in np.asarray(col, dtype=object)]


def _offsets(parts) -> Tuple[bytes, np.ndarray]:
  """Byte strings -> (one buffer, int64 offsets [n+1])."""
  offsets = np.zeros(len(parts) + 1, np.int64)
  np.cumsum([len(p) for p in parts], out=offsets[1:])
  return b''.join(parts), offsets


def _sep_byte(sep: str) -> bytes:
  b = sep.encode('utf-8')
  if len(b) != 1:
    raise ValueError('term separator %r is not one byte' % sep)
  return b


# -- native ------------------------------------------------------------------


def text_normalize(col) -> np.ndarray:
  """Lowercase ASCII letters, ASCII punctuation to spaces; multibyte
  characters pass through."""
  buf, offsets = _offsets(_encoded(col))
  arr = bytearray(buf)
  if arr:
    c_buf = (ctypes.c_char * len(arr)).from_buffer(arr)
    _lib().text_normalize_inplace(c_buf, len(arr))
  data = bytes(arr)
  return np.asarray([data[offsets[i]:offsets[i + 1]].decode('utf-8',
                                                            'replace')
                     for i in range(len(offsets) - 1)], dtype=object)


def edit_distance(col_a, col_b) -> np.ndarray:
  """Per-row Levenshtein distance (int32) over bytes, each string cut to
  256 bytes."""
  buf_a, off_a = _offsets(_encoded(col_a))
  buf_b, off_b = _offsets(_encoded(col_b))
  out = np.zeros(len(off_a) - 1, np.int32)
  _lib().edit_distance_batch(buf_a, off_a.ctypes.data_as(_P64), buf_b,
                             off_b.ctypes.data_as(_P64), len(out),
                             out.ctypes.data_as(_P32))
  return out


def overlap_counts(col_a, col_b, sep: str = ' '):
  """(common, |a|, |b|) int32 a row: the non-empty terms of b found among
  the first 64 non-empty terms of a, and the two term counts."""
  sep_b = _sep_byte(sep)
  buf_a, off_a = _offsets(_encoded(col_a))
  buf_b, off_b = _offsets(_encoded(col_b))
  n = len(off_a) - 1
  common, na, nb = (np.zeros(n, np.int32) for _ in range(3))
  _lib().term_overlap_batch(buf_a, off_a.ctypes.data_as(_P64), buf_b,
                            off_b.ctypes.data_as(_P64), n, sep_b,
                            common.ctypes.data_as(_P32),
                            na.ctypes.data_as(_P32),
                            nb.ctypes.data_as(_P32))
  return common, na, nb


# -- plain versions -------------------------------------------------------------


def plain_text_normalize(col) -> np.ndarray:
  out = []
  for b in _encoded(col):
    norm = bytes(c + 32 if 65 <= c <= 90 else
                 32 if c < 0x80 and not (97 <= c <= 122 or 48 <= c <= 57)
                 else c for c in b)
    out.append(norm.decode('utf-8', 'replace'))
  return np.asarray(out, dtype=object)


def plain_edit_distance(col_a, col_b) -> np.ndarray:
  out = []
  for a, b in zip(_encoded(col_a), _encoded(col_b)):
    a, b = a[:256], b[:256]
    dp = list(range(len(b) + 1))
    for ia in range(1, len(a) + 1):
      prev, dp[0] = dp[0], ia
      for jb in range(1, len(b) + 1):
        cur = dp[jb]
        dp[jb] = min(prev + (a[ia - 1] != b[jb - 1]), dp[jb] + 1,
                     dp[jb - 1] + 1)
        prev = cur
    out.append(dp[len(b)])
  return np.asarray(out, np.int32)


def plain_overlap_counts(col_a, col_b, sep: str = ' '):
  sep_b = _sep_byte(sep)
  rows = []
  for a, b in zip(_encoded(col_a), _encoded(col_b)):
    ta = [t for t in a.split(sep_b) if t][:64]
    tb = [t for t in b.split(sep_b) if t]
    terms = set(ta)
    rows.append((sum(1 for t in tb if t in terms), len(ta), len(tb)))
  arr = np.asarray(rows, np.int32).reshape(-1, 3)
  return arr[:, 0], arr[:, 1], arr[:, 2]


# -- the DSL's functions -----------------------------------------------------------


def query_common_ratio(col_a, col_b, sep: str = ' ') -> np.ndarray:
  """common terms / |a|."""
  common, na, _ = overlap_counts(col_a, col_b, sep)
  return (common / np.maximum(na, 1)).astype(np.float32)


def title_common_ratio(col_a, col_b, sep: str = ' ') -> np.ndarray:
  """common terms / |b|."""
  common, _, nb = overlap_counts(col_a, col_b, sep)
  return (common / np.maximum(nb, 1)).astype(np.float32)


def is_contain(col_a, col_b, sep: str = ' ') -> np.ndarray:
  """1.0 where every term of a appears in b."""
  common, na, _ = overlap_counts(col_a, col_b, sep)
  return (common >= na).astype(np.float32)


def common_word(col_a, col_b, sep: str = ' ') -> np.ndarray:
  common, _, _ = overlap_counts(col_a, col_b, sep)
  return common.astype(np.float32)


def mapped_dot_product(map_col, key_col, kv_sep: str = ':',
                       item_sep: str = ',') -> np.ndarray:
  """Sum of the values in `map_col` (k:v list) whose keys appear in
  `key_col`."""
  map_col = np.asarray(map_col, dtype=object)
  key_col = np.asarray(key_col, dtype=object)
  out = np.zeros(len(map_col), np.float32)
  for i, (m, k) in enumerate(zip(map_col, key_col)):
    kv = {}
    for item in str(m).split(item_sep):
      if kv_sep in item:
        key, val = item.split(kv_sep, 1)
        try:
          kv[key] = float(val)
        except ValueError:
          pass
    total = 0.0
    for key in str(k).split(item_sep):
      total += kv.get(key, 0.0)
    out[i] = total
  return out
