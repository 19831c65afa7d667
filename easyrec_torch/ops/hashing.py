"""String -> bucket hashing for categorical features.

Counterpart of easyrec_tpu/ops/hashing.py. The same MurmurHash64A as the JAX
package (a copy of its source lives in ops/native/hash_ops.cc), so every
string lands in the same bucket in both packages. The library is built with
g++ at first use into build/easyrec_torch/; there is no other backend.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from easyrec_torch.ops.native_build import GXX_FLAGS, NativeBuild

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'native',
                       'hash_ops.cc')
_lock = threading.Lock()
_lib = None


def _native() -> ctypes.CDLL:
  global _lib
  with _lock:
    if _lib is None:
      lib = NativeBuild(_SOURCE, ['g++'], GXX_FLAGS).load()
      lib.hash_strings_mod.restype = None
      lib.hash_strings_mod.argtypes = [
          ctypes.c_char_p,                  # concatenated utf-8 bytes
          ctypes.POINTER(ctypes.c_int64),   # offsets [n+1]
          ctypes.c_int64,                   # n
          ctypes.c_uint64,                  # num_buckets
          ctypes.POINTER(ctypes.c_int64),   # out [n]
      ]
      lib.split_hash_strings.restype = None
      lib.split_hash_strings.argtypes = [
          ctypes.c_char_p,                  # concatenated utf-8 bytes
          ctypes.POINTER(ctypes.c_int64),   # offsets [n+1]
          ctypes.c_int64,                   # n
          ctypes.c_char,                    # separator byte
          ctypes.c_uint64,                  # num_buckets
          ctypes.c_int64,                   # max_k
          ctypes.c_int64,                   # pad_id
          ctypes.POINTER(ctypes.c_int64),   # ids [n*max_k]
          ctypes.POINTER(ctypes.c_int32),   # counts [n]
      ]
      _lib = lib
  return _lib


def _encode(flat):
  """Strings -> one utf-8 buffer and offsets [n+1]; non-string values
  encode their `str()` form, None as ''."""
  enc = [('' if s is None else str(s)).encode('utf-8') for s in flat]
  offsets = np.zeros(len(enc) + 1, dtype=np.int64)
  np.cumsum([len(b) for b in enc], out=offsets[1:])
  return b''.join(enc), offsets


def _ptr(arr: np.ndarray, ctype):
  return arr.ctypes.data_as(ctypes.POINTER(ctype))


def hash_strings(values, num_buckets: int) -> np.ndarray:
  """Hash an array of strings into [0, num_buckets) as int64 (same shape).

  Non-string values hash their `str()` form; None hashes as ''.
  """
  arr = np.asarray(values, dtype=object)
  buf, offsets = _encode(arr.ravel())
  n = offsets.shape[0] - 1
  out = np.empty(n, dtype=np.int64)
  if n:
    _native().hash_strings_mod(
        buf, _ptr(offsets, ctypes.c_int64), ctypes.c_int64(n),
        ctypes.c_uint64(int(num_buckets)), _ptr(out, ctypes.c_int64))
  return out.reshape(arr.shape)


def split_hash(values, sep: str, num_buckets: int, max_k: int,
               pad_id: int = 0):
  """Split delimited strings on `sep` and hash each non-empty piece into
  [0, num_buckets): (ids [n, max_k] int64 padded with pad_id, counts [n]
  int32). Pieces past max_k are dropped. Counterpart of the JAX package's
  split_hash (ops/hashing.py:114); the separator is one byte, as in its
  native kernel."""
  sep_b = sep.encode('utf-8')
  if len(sep_b) != 1:
    raise NotImplementedError('sequence separator %r is not one byte' % sep)
  buf, offsets = _encode(np.asarray(values, dtype=object).ravel())
  n = offsets.shape[0] - 1
  ids = np.empty((n, max_k), dtype=np.int64)
  counts = np.empty(n, dtype=np.int32)
  if n:
    _native().split_hash_strings(
        buf, _ptr(offsets, ctypes.c_int64), ctypes.c_int64(n),
        ctypes.c_char(sep_b), ctypes.c_uint64(int(num_buckets)),
        ctypes.c_int64(int(max_k)), ctypes.c_int64(int(pad_id)),
        _ptr(ids, ctypes.c_int64), _ptr(counts, ctypes.c_int32))
  return ids, counts
