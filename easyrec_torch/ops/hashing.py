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
      _lib = lib
  return _lib


def hash_strings(values, num_buckets: int) -> np.ndarray:
  """Hash an array of strings into [0, num_buckets) as int64 (same shape).

  Non-string values hash their `str()` form; None hashes as ''.
  """
  arr = np.asarray(values, dtype=object)
  flat = arr.ravel()
  enc = [('' if s is None else str(s)).encode('utf-8') for s in flat]
  offsets = np.zeros(len(enc) + 1, dtype=np.int64)
  np.cumsum([len(b) for b in enc], out=offsets[1:])
  buf = b''.join(enc)
  out = np.empty(len(enc), dtype=np.int64)
  if len(enc):
    _native().hash_strings_mod(
        buf, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(enc)), ctypes.c_uint64(int(num_buckets)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
  return out.reshape(arr.shape)
