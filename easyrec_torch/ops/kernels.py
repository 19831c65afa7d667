"""The port's hand-written CUDA kernels: build, load and launch counts.

Each kernel is one source under easyrec_torch/csrc/ with a plain C entry
point that launches on the stream it is given and returns
cudaGetLastError(). It is built with nvcc for sm_90a into
build/easyrec_torch/ at first use and loaded with ctypes; nothing is built
or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List

import torch

from easyrec_torch.ops.native_build import (NVCC_FLAGS, PACKAGE_DIR,
                                            NativeBuild, find_nvcc)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float


class CudaKernel:
  """One CUDA source, its C entry point and a count of its launches.

  `launches` goes up by one at each launch of the kernel and nowhere else.
  """

  def __init__(self, name: str, source: str, entry: str, argtypes: List):
    self.name = name
    self.source = os.path.join(PACKAGE_DIR, 'csrc', source)
    self.entry = entry
    self.argtypes = argtypes
    self.launches = 0
    self._fn = None
    self._lock = threading.Lock()

  def builder(self) -> NativeBuild:
    return NativeBuild(self.source, [find_nvcc()], NVCC_FLAGS)

  def _load(self):
    with self._lock:
      if self._fn is None:
        fn = getattr(self.builder().load(), self.entry)
        fn.restype = ctypes.c_int
        fn.argtypes = self.argtypes
        self._fn = fn
    return self._fn

  def launch(self, device: torch.device, *args) -> None:
    """Launch on `device`'s current stream; raise on a nonzero return."""
    fn = self._fn or self._load()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
      raise RuntimeError('%s launch failed: CUDA error %d' % (self.name, rc))
    self.launches += 1


SEG_SUM = CudaKernel(
    'seg_sum', 'seg_sum.cu', 'easyrec_seg_sum',
    # sids, order, starts, grads, uids, sums, n, dim, sentinel, mode, stream
    [_P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I32, _P])

RMW_ADAM = CudaKernel(
    'rmw_adam', 'rmw_adam.cu', 'easyrec_rmw_adam',
    # table, uids, gsum, hypers, n, rows, dim, b1, 1-b1, b2, 1-b2, eps,
    # stream
    [_P, _P, _P, _P, _I64, _I64, _I32, _F32, _F32, _F32, _F32, _F32, _P])

RMW_FUSED_ADAM = CudaKernel(
    'rmw_fused_adam', 'rmw_fused_adam.cu', 'easyrec_rmw_fused_adam',
    # table, sids, order, starts, grads, hypers, chunk_seg, chunk_base,
    # partial, n, n_chunks, rows, dim, b1, 1-b1, b2, 1-b2, eps, stream
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I32, _F32, _F32,
     _F32, _F32, _F32, _P])

ALL = (SEG_SUM, RMW_ADAM, RMW_FUSED_ADAM)


def build_all(verbose: bool = False) -> Dict[str, str]:
  """Build every kernel with one nvcc each, all started together; returns
  each kernel's compiler output (ptxas register/spill report with
  verbose)."""
  builds = {k.name: k.builder() for k in ALL}
  for b in builds.values():
    b.start(verbose=verbose)
  return {name: b.wait() for name, b in builds.items()}


def reset_launches() -> None:
  for k in ALL:
    k.launches = 0


def launch_counts() -> Dict[str, int]:
  return {k.name: k.launches for k in ALL}
