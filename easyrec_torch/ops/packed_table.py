"""The port's combined embedding table and its sparse update.

Counterpart of easyrec_tpu/ops/packed_table.py. One row per logical row:
a table is [rows, 2*dim] f32 holding w[0:dim] | mv[0:dim], where each mv
element is the Adam moment pair (m, v) as bf16 halves of one float32 (m in
the top 16 bits). On the flagship that is dim 32, 256 B a row, 6.7 GB.
The TPU layout's 8-row, 128-lane groups exist only for Mosaic DMA alignment
and are not carried over; `convert.py` maps between the two.

The update of one step, for raw (duplicated) ids [N] and their pulled-row
gradients [N, dim]:
  1. `sort_segments` (PyTorch ops, as JAX leaves sort and cumsum to XLA):
     sort the ids, mark segment starts. N is a static capacity: unused
     segment slots are a sentinel tail, so no step syncs the host on the
     number of unique ids.
  2. `seg_sum` -> kernel K1 (csrc/seg_sum.cu): unique ids and per-id
     gradient sums, by the chunk tree of csrc/seg_chunk_sum.cuh.
  3. `rmw_adam` -> kernel K2 (csrc/rmw_adam.cu): in-place lazy Adam on the
     touched rows.
Under EASYREC_PACKED_FUSED=1 steps 2 and 3 are one call instead,
`rmw_fused_adam` -> kernel K3 (csrc/rmw_fused_adam.cu), which keeps the
[N, dim] gradient sums out of device memory (the JAX package's
_rmw_fused_pallas) and sums by the same chunk tree as K1.
Each kernel wrapper runs its plain PyTorch version when its tensors lie on
the CPU and launches its kernel when they lie on a CUDA device; there is no
other switch between the two.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from easyrec_torch.ops import kernels
from easyrec_torch.optim.sparse import SparseAdam

GG_MODES = {'0': 0, '1': 1, 'mix': 2}

# K1 and K3 cut every segment into chunks of this many sorted slots, and
# sum a chunk as this many strided chains (csrc/seg_chunk_sum.cuh kChunk,
# kSlotLanes)
FUSED_CHUNK = 256
SLOT_LANES = 8


def gg_mode() -> str:
  """Gradient-sum precision policy, EASYREC_GG_BF16 as in the JAX package:
  '1' (default) bf16 payload and bf16 sums, 'mix' bf16 payload and f32
  sums, '0' f32 throughout."""
  mode = os.environ.get('EASYREC_GG_BF16', '1')
  if mode not in GG_MODES:
    raise ValueError('EASYREC_GG_BF16=%r: expected one of %s'
                     % (mode, sorted(GG_MODES)))
  return mode


class TableMeta:
  """Geometry of one combined table."""

  def __init__(self, rows: int, dim: int):
    self.rows = int(rows)       # logical rows incl. the scratch row
    self.dim = int(dim)         # physical weight columns
    self.width = 2 * self.dim   # w | mv
    self.sentinel = self.rows   # id of unused update slots (out of range)

  def __repr__(self):
    return 'TableMeta(rows=%d, dim=%d)' % (self.rows, self.dim)


# ------------------------------------------------------ host pack / unpack

def np_bf16_bits(x: np.ndarray) -> np.ndarray:
  """f32 -> round-to-nearest-even bf16 bits in the TOP 16 of a u32."""
  u = np.ascontiguousarray(x, np.float32).view(np.uint32)
  u = u + 0x7FFF + ((u >> 16) & 1)
  return u & np.uint32(0xFFFF0000)


def np_pack_pair(m: np.ndarray, v: np.ndarray) -> np.ndarray:
  return (np_bf16_bits(m) | (np_bf16_bits(v) >> 16)).view(np.float32)


def np_unpack_pair(mv: np.ndarray):
  u = np.ascontiguousarray(mv, np.float32).view(np.uint32)
  return ((u & np.uint32(0xFFFF0000)).view(np.float32),
          (u << np.uint32(16)).view(np.float32))


def pack_host(w: np.ndarray, m: np.ndarray, v: np.ndarray) -> np.ndarray:
  """Logical (w, m, v) [rows, dim] -> combined [rows, 2*dim] f32."""
  return np.concatenate([np.asarray(w, np.float32), np_pack_pair(m, v)],
                        axis=1)


def unpack_host(table: np.ndarray):
  """Combined [rows, 2*dim] -> logical (w, m, v)."""
  dim = table.shape[1] // 2
  m, v = np_unpack_pair(table[:, dim:])
  return np.ascontiguousarray(table[:, :dim]), m, v


# ---------------------------------------------------------------- forward

def pull(table: torch.Tensor, ids: torch.Tensor,
         meta: TableMeta) -> torch.Tensor:
  """Gather logical WEIGHT rows [..., dim]: index_select on the weight
  columns (no autograd on the table; the caller differentiates the
  pulled rows)."""
  rows = torch.index_select(table[:, :meta.dim], 0, ids.reshape(-1))
  return rows.reshape(tuple(ids.shape) + (meta.dim,))


# ----------------------------------------------------------- update prep

def sort_segments(ids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """ids [N] int64 -> (sids [N] sorted ids, order [N] sorted slot ->
  original slot, starts [N+1]: first sorted slot of segment k, N for
  unused k and for starts[N]). No host sync."""
  n = ids.shape[0]
  sids, order = torch.sort(ids)
  first = torch.ones(n, dtype=torch.bool, device=ids.device)
  first[1:] = sids[1:] != sids[:-1]
  seg = torch.cumsum(first, 0) - 1
  # non-first slots scatter into the dump slot n, reset right after
  slot = torch.where(first, seg, torch.full_like(seg, n))
  starts = torch.full((n + 1,), n, dtype=torch.int64, device=ids.device)
  starts.scatter_(0, slot, torch.arange(n, device=ids.device))
  starts[n] = n
  return sids, order, starts


# ------------------------------------ the chunk tree shared by K1 and K3

def _tree_sums(src: torch.Tensor, lo: torch.Tensor, cnt: torch.Tensor,
               index: torch.Tensor = None) -> torch.Tensor:
  """Per group g, the sum of rows src[index[lo[g] + i]] (src[lo[g] + i]
  without `index`) for i < cnt[g], in the tree of csrc/seg_chunk_sum.cuh:
  slot-lane p < SLOT_LANES adds positions p, p + 8, p + 16, ... in order
  to +0.0, then the lane sums combine as v[:o] + v[o:2o] for o = 4, 2, 1.
  Missing positions add +0.0, which changes no bit of a sum that started
  at +0.0. The loop runs ceil(max(cnt) / SLOT_LANES) times."""
  groups, dim = lo.shape[0], src.shape[1]
  acc = torch.zeros((groups, SLOT_LANES, dim), dtype=torch.float32,
                    device=src.device)
  lane = torch.arange(SLOT_LANES, device=src.device)
  steps = (int(cnt.max()) + SLOT_LANES - 1) // SLOT_LANES if groups else 0
  for i in range(steps):
    act = torch.nonzero(cnt > i * SLOT_LANES)[:, 0]
    off = i * SLOT_LANES + lane
    ok = off[None, :] < cnt[act, None]
    pos = lo[act, None] + torch.where(ok, off[None, :], 0)
    vals = src[pos if index is None else index[pos]]
    acc[act] = acc[act] + torch.where(ok[:, :, None], vals, 0.0)
  o = SLOT_LANES // 2
  while o:
    acc = acc[:, :o] + acc[:, o:2 * o]
    o //= 2
  return acc[:, 0]


def segment_sums_by_chunk(order: torch.Tensor, starts: torch.Tensor,
                          grads: torch.Tensor, mode: str = '0'
                          ) -> torch.Tensor:
  """Per-segment gradient sums [N, dim] (zero rows for unused segments) in
  the order of additions of K1 and K3, the chunk tree of
  csrc/seg_chunk_sum.cuh, which is fixed by a segment's length alone:
  level 1 cuts the segment's sorted slots into chunks of FUSED_CHUNK and
  sums each by _tree_sums; level 2 gives a one-chunk segment its chunk's
  sum and sums a longer segment's chunk sums by _tree_sums again. `mode`
  is EASYREC_GG_BF16's: '0' f32 payload; 'mix' payload rounded to bf16;
  '1' that, and each final sum rounded to bf16 once."""
  n, dim = grads.shape
  dev = grads.device
  payload = grads if mode == '0' else bf16_round(grads)
  lens = starts[1:] - starts[:n]                 # 0 for unused segments
  n_ch = (lens + FUSED_CHUNK - 1) // FUSED_CHUNK
  seg = torch.repeat_interleave(torch.arange(n, device=dev), n_ch)
  first = torch.cumsum(n_ch, 0) - n_ch           # first chunk of a segment
  j = torch.arange(seg.shape[0], device=dev) - first[seg]
  lo = starts[seg] + j * FUSED_CHUNK
  csum = _tree_sums(payload, lo,
                    torch.clamp(starts[seg + 1] - lo, max=FUSED_CHUNK),
                    order)
  sums = torch.zeros((n, dim), dtype=torch.float32, device=dev)
  one = torch.nonzero(n_ch == 1)[:, 0]
  sums[one] = csum[first[one]]
  many = torch.nonzero(n_ch > 1)[:, 0]
  if many.shape[0]:
    sums[many] = _tree_sums(csum, first[many], n_ch[many])
  return bf16_round(sums) if mode == '1' else sums


def long_chunk_bound(n: int) -> int:
  """Rows of the kernels' chunk scratch: two a window of FUSED_CHUNK sorted
  slots (csrc/seg_chunk_sum.cuh, chunk_row)."""
  return 2 * (-(-n // FUSED_CHUNK))


def _rows_vectorizable(grads: torch.Tensor) -> bool:
  """The kernels load 16-byte float4s where every row starts 16-byte
  aligned, else scalars; the sums are the same."""
  return grads.shape[1] % 4 == 0 and grads.data_ptr() % 16 == 0


# ------------------------------------------------- K1: segmented grad sum

def _check(t: torch.Tensor, name: str, dtype, shape, device):
  if t.dtype != dtype:
    raise TypeError('%s: dtype %s, expected %s' % (name, t.dtype, dtype))
  if tuple(t.shape) != tuple(shape):
    raise ValueError('%s: shape %s, expected %s'
                     % (name, tuple(t.shape), tuple(shape)))
  if t.device != device:
    raise ValueError('%s on %s, expected %s' % (name, t.device, device))
  if not t.is_contiguous():
    raise ValueError('%s is not contiguous' % name)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
  """Round f32 to the nearest bf16 (ties to even), kept in f32: the integer
  rounding of the JAX package's _np_bf16_bits, which the kernels repeat."""
  u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
  u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
  return u.to(torch.int32).view(torch.float32)


def seg_sum_plain(sids, order, starts, grads, sentinel: int, mode: str):
  """Plain PyTorch K1: unique ids (sentinel tail) and the chunk-tree sums
  of segment_sums_by_chunk in `mode`, the kernel's tree, so the two agree
  bit for bit."""
  n = grads.shape[0]
  sums = segment_sums_by_chunk(order, starts, grads, mode)
  live = starts[:n] < n
  uids = torch.where(live, sids[starts[:n].clamp(max=n - 1)],
                     torch.full_like(sids, sentinel))
  return uids, sums


def seg_sum(sids: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
            grads: torch.Tensor, sentinel: int, mode: str = None):
  """Unique ids [N] (sentinel tail) and per-id gradient sums [N, dim]
  (zero rows on the tail). CPU tensors: plain version; CUDA: kernel K1."""
  mode = gg_mode() if mode is None else mode
  if mode not in GG_MODES:
    raise ValueError('unknown gradient-sum mode %r' % mode)
  n, dim = grads.shape
  dev = grads.device
  _check(sids, 'sids', torch.int64, (n,), dev)
  _check(order, 'order', torch.int64, (n,), dev)
  _check(starts, 'starts', torch.int64, (n + 1,), dev)
  _check(grads, 'grads', torch.float32, (n, dim), dev)
  if dev.type == 'cpu':
    return seg_sum_plain(sids, order, starts, grads, sentinel, mode)
  if dev.type != 'cuda':
    raise ValueError('seg_sum: unsupported device %s' % dev)
  uids = torch.empty(n, dtype=torch.int64, device=dev)
  sums = torch.empty((n, dim), dtype=torch.float32, device=dev)
  partial = torch.empty((long_chunk_bound(n), dim), dtype=torch.float32,
                        device=dev)
  kernels.SEG_SUM.launch(
      dev, sids.data_ptr(), order.data_ptr(), starts.data_ptr(),
      grads.data_ptr(), uids.data_ptr(), sums.data_ptr(), partial.data_ptr(),
      n, dim, int(sentinel), GG_MODES[mode], int(_rows_vectorizable(grads)))
  return uids, sums


# ----------------------------------------- K2: row RMW with compact Adam

def rmw_adam_plain(table: torch.Tensor, uids: torch.Tensor,
                   gsum: torch.Tensor, hypers: torch.Tensor,
                   opt: SparseAdam) -> torch.Tensor:
  """Plain PyTorch K2: updates `table` in place and returns it."""
  rows, width = table.shape
  dim = width // 2
  live = (uids >= 0) & (uids < rows)
  touched = live & (gsum != 0).any(dim=1)
  idx = uids[touched]
  old = table.index_select(0, idx)
  w, mv = opt.compact_block(old[:, :dim], old[:, dim:], gsum[touched],
                            hypers)
  table.index_copy_(0, idx, torch.cat([w, mv], dim=1))
  return table


def rmw_adam(table: torch.Tensor, uids: torch.Tensor, gsum: torch.Tensor,
             hypers: torch.Tensor, opt: SparseAdam) -> torch.Tensor:
  """Lazy Adam on the rows `uids` names (sentinels skipped, untouched rows
  keep their bytes), in place. CPU tensors: plain version; CUDA: K2."""
  if not isinstance(opt, SparseAdam):
    raise NotImplementedError(
        'sparse optimizer %r has no port: only compact Adam runs on the '
        'combined table' % (opt,))
  rows, width = table.shape
  n, dim = gsum.shape
  dev = table.device
  _check(table, 'table', torch.float32, (rows, 2 * dim), dev)
  _check(uids, 'uids', torch.int64, (n,), dev)
  _check(gsum, 'gsum', torch.float32, (n, dim), dev)
  _check(hypers, 'hypers', torch.float32, (3,), dev)
  if dev.type == 'cpu':
    return rmw_adam_plain(table, uids, gsum, hypers, opt)
  if dev.type != 'cuda':
    raise ValueError('rmw_adam: unsupported device %s' % dev)
  b1, omb1, b2, omb2, eps = opt.constants
  kernels.RMW_ADAM.launch(
      dev, table.data_ptr(), uids.data_ptr(), gsum.data_ptr(),
      hypers.data_ptr(), n, rows, dim, b1, omb1, b2, omb2, eps)
  return table


# ------------------------- K3: fused segmented sum + row RMW, compact Adam

def rmw_fused_adam_plain(table: torch.Tensor, sids: torch.Tensor,
                         order: torch.Tensor, starts: torch.Tensor,
                         grads: torch.Tensor, hypers: torch.Tensor,
                         opt: SparseAdam) -> torch.Tensor:
  """Plain PyTorch K3: the kernel's chunk tree (segment_sums_by_chunk, f32),
  then K2's plain update; `table` is updated in place and returned."""
  n = grads.shape[0]
  sums = segment_sums_by_chunk(order, starts, grads)
  live = starts[:n] < n
  uids = torch.where(live, sids[starts[:n].clamp(max=n - 1)],
                     torch.full_like(sids, -1))
  return rmw_adam_plain(table, uids, sums, hypers, opt)


def rmw_fused_adam(table: torch.Tensor, sids: torch.Tensor,
                   order: torch.Tensor, starts: torch.Tensor,
                   grads: torch.Tensor, hypers: torch.Tensor,
                   opt: SparseAdam) -> torch.Tensor:
  """Sum each segment's gradients and run lazy Adam on its row, in place,
  with no [N, dim] sums in between (unused segments and ids outside the
  table skipped, untouched rows keep their bytes). CPU tensors: plain
  version; CUDA: K3."""
  if not isinstance(opt, SparseAdam):
    raise NotImplementedError(
        'sparse optimizer %r has no port: only compact Adam runs on the '
        'combined table' % (opt,))
  rows, width = table.shape
  n, dim = grads.shape
  dev = table.device
  _check(table, 'table', torch.float32, (rows, 2 * dim), dev)
  _check(sids, 'sids', torch.int64, (n,), dev)
  _check(order, 'order', torch.int64, (n,), dev)
  _check(starts, 'starts', torch.int64, (n + 1,), dev)
  _check(grads, 'grads', torch.float32, (n, dim), dev)
  _check(hypers, 'hypers', torch.float32, (3,), dev)
  if dev.type == 'cpu':
    return rmw_fused_adam_plain(table, sids, order, starts, grads, hypers,
                                opt)
  if dev.type != 'cuda':
    raise ValueError('rmw_fused_adam: unsupported device %s' % dev)
  if dim > 128:
    raise ValueError('rmw_fused_adam: dim %d above the kernel\'s 128' % dim)
  partial = torch.empty((long_chunk_bound(n), dim), dtype=torch.float32,
                        device=dev)
  b1, omb1, b2, omb2, eps = opt.constants
  kernels.RMW_FUSED_ADAM.launch(
      dev, table.data_ptr(), sids.data_ptr(), order.data_ptr(),
      starts.data_ptr(), grads.data_ptr(), hypers.data_ptr(),
      partial.data_ptr(), n, rows, dim, b1, omb1, b2, omb2, eps,
      int(_rows_vectorizable(grads)))
  return table


def fused_mode() -> bool:
  """EASYREC_PACKED_FUSED as in the JAX package: '1' takes K3, anything
  else K1 + K2."""
  return os.environ.get('EASYREC_PACKED_FUSED', '0') == '1'


def apply_packed_update(table: torch.Tensor, ids: torch.Tensor,
                        grads: torch.Tensor, hypers: torch.Tensor,
                        opt: SparseAdam, meta: TableMeta) -> torch.Tensor:
  """Sparse-update one combined table, in place, from raw (duplicated)
  ids [N] and their gradients [N, dim]: K3 under EASYREC_PACKED_FUSED=1,
  else K1 then K2."""
  sids, order, starts = sort_segments(ids.reshape(-1).to(torch.int64))
  grads = grads.reshape(-1, meta.dim).to(torch.float32).contiguous()
  if fused_mode():
    return rmw_fused_adam(table, sids, order, starts, grads, hypers, opt)
  uids, gsum = seg_sum(sids, order, starts, grads, meta.sentinel)
  return rmw_adam(table, uids, gsum, hypers, opt)
