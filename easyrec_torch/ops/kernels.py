"""The port's hand-written CUDA kernels: build, load and launch counts.

Each kernel is a plain C entry point of a source under easyrec_torch/csrc/
(one a source, but K7's forward and backward share bag_pool.cu) that
launches on the stream it is given and returns cudaGetLastError(). It is
built with nvcc for sm_90a into build/easyrec_torch/ at first use and
loaded with ctypes; nothing is built or imported when this module is
imported.
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

  `launches` goes up by one at each launch of the kernel and nowhere else;
  `tagged` counts the launches by the tag a wrapper gives (K2 and K3: the
  block math).
  """

  def __init__(self, name: str, source: str, entry: str, argtypes: List):
    self.name = name
    self.source = os.path.join(PACKAGE_DIR, 'csrc', source)
    self.entry = entry
    self.argtypes = argtypes
    self.launches = 0
    self.tagged: Dict[str, int] = {}
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

  def launch(self, device: torch.device, *args, tag: str = None) -> None:
    """Launch on `device`'s current stream; raise on a nonzero return."""
    fn = self._fn or self._load()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
      raise RuntimeError('%s launch failed: CUDA error %d' % (self.name, rc))
    self.launches += 1
    if tag is not None:
      self.tagged[tag] = self.tagged.get(tag, 0) + 1


SEG_SUM = CudaKernel(
    'seg_sum', 'seg_sum.cu', 'easyrec_seg_sum',
    # sids, order, starts, grads, uids, sums, partial, n, dim, sentinel,
    # mode, vec, stream
    [_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I32, _I32, _P])

RMW_ROWS = CudaKernel(
    'rmw_rows', 'rmw_rows.cu', 'easyrec_rmw_rows',
    # math, table, uids, gsum, hypers, consts (host float[8]), n, rows,
    # dim, vec, stream
    [_I32, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _P])

RMW_FUSED = CudaKernel(
    'rmw_fused', 'rmw_fused.cu', 'easyrec_rmw_fused',
    # math, table, sids, order, starts, grads, hypers, partial, consts
    # (host float[8]), n, rows, dim, vec, stream
    [_I32, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _P])

BAG_POOL = CudaKernel(
    'bag_pool', 'bag_pool.cu', 'easyrec_bag_pool',
    # rows, w, table (host int[3 * nbags]), out, batch, tot_k, nbags, dim,
    # stream
    [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _P])

BAG_POOL_GRAD = CudaKernel(
    'bag_pool_grad', 'bag_pool.cu', 'easyrec_bag_pool_grad',
    # g, w, table (host int[3 * nbags]), grad_rows, batch, tot_k, nbags,
    # dim, stream
    [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _P])

GROUP_PUSH = CudaKernel(
    'group_push', 'group_push.cu', 'easyrec_group_push',
    # table, gids, rows, bad, n, groups, elems, idx64, stream
    [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _P])

GROUP_RMW = CudaKernel(
    'group_rmw', 'group_rmw.cu', 'easyrec_group_rmw',
    # table, gids, gg (None: no gradient term), bad, n, groups, elems,
    # idx64, a, b, c, threads, per_block, stream
    [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _F32, _F32, _F32, _I32, _I32,
     _P])

ALL = (SEG_SUM, RMW_ROWS, RMW_FUSED, BAG_POOL, BAG_POOL_GRAD, GROUP_PUSH,
       GROUP_RMW)


def build_all(verbose: bool = False) -> Dict[str, str]:
  """Build every kernel source with one nvcc each, all started together;
  returns each source's compiler output (ptxas register/spill report with
  verbose) under the name of its first kernel."""
  builds = {}
  for k in ALL:
    if all(b.source != k.source for b in builds.values()):
      builds[k.name] = k.builder()
  for b in builds.values():
    b.start(verbose=verbose)
  return {name: b.wait() for name, b in builds.items()}


def reset_launches() -> None:
  for k in ALL:
    k.launches = 0
    k.tagged = {}


def launch_counts() -> Dict[str, int]:
  return {k.name: k.launches for k in ALL}


def tagged_counts() -> Dict[str, int]:
  """Launches by kernel and tag, as 'kernel/tag'."""
  return {'%s/%s' % (k.name, tag): c for k in ALL
          for tag, c in k.tagged.items()}
