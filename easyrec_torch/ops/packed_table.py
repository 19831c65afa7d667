"""The port's combined embedding table and its sparse update.

Counterpart of easyrec_tpu/ops/packed_table.py. One row per logical row,
holding the weights and every optimizer slot side by side, in the part
order of the JAX package's combined row (:9-18): [w | s1 | s2], each part
`dim` f32 columns, so a row is n_parts * dim wide (sgd 1 part, momentum
and Adagrad 2, 3-part Adam and FTRL 3). Adam's compact layout keeps the
two moments as one part of bf16 pairs (m in the top 16 bits of each f32):
[w | mv], 2 * dim wide. The flagship's compact Adam table is dim 32, 256 B
a row, 6.7 GB; its Adagrad table the same width. The TPU layout's 8-row,
128-lane groups exist only for Mosaic DMA alignment and are not carried
over; `convert.py` maps between the two.

The update of one step, for raw (duplicated) ids [N] and their pulled-row
gradients [N, dim]:
  1. `sort_segments` (PyTorch ops, as JAX leaves sort and cumsum to XLA):
     sort the ids, mark segment starts. N is a static capacity: unused
     segment slots are a sentinel tail, so no step syncs the host on the
     number of unique ids.
  2. `seg_sum` -> kernel K1 (csrc/seg_sum.cu): unique ids and per-id
     gradient sums, by the chunk tree of csrc/seg_chunk_sum.cuh.
  3. `rmw_rows` -> kernel K2 (csrc/rmw_rows.cu): the optimizer's block math
     in place on the touched rows.
Under EASYREC_PACKED_FUSED=1 steps 2 and 3 are one call instead,
`rmw_fused` -> kernel K3 (csrc/rmw_fused.cu), which keeps the [N, dim]
gradient sums out of device memory (the JAX package's _rmw_fused_pallas)
and sums by the same chunk tree as K1. K2 and K3 run every block math of
the sparse optimizers (optim/sparse.py), from csrc/block_math.cuh.
Each kernel wrapper runs its plain PyTorch version when its tensors lie on
the CPU and launches its kernel when they lie on a CUDA device; there is no
other switch between the two.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from easyrec_torch.ops import kernels
from easyrec_torch.optim.sparse import (MATH_NAMES, MAX_CONSTS,
                                        SparseOptimizer)

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
  """Geometry of one combined table: n_parts = 1 + the optimizer's slots;
  compact (Adam only, n_parts 3) packs the two moments as bf16 pairs, so
  the row holds 2 physical parts, as the JAX package's PackMeta."""

  def __init__(self, rows: int, dim: int, n_parts: int = 1,
               compact: bool = False):
    if compact and n_parts != 3:
      raise ValueError('compact layout packs exactly 2 slots (n_parts=3)')
    self.rows = int(rows)       # logical rows incl. the scratch row
    self.dim = int(dim)         # physical weight columns
    self.compact = bool(compact)
    self.logical_parts = int(n_parts)
    self.n_parts = 2 if compact else int(n_parts)   # physical parts
    self.width = self.n_parts * self.dim
    self.sentinel = self.rows   # id of unused update slots (out of range)

  def __repr__(self):
    return 'TableMeta(rows=%d, dim=%d, parts=%d%s)' % (
        self.rows, self.dim, self.n_parts, ', compact' if self.compact
        else '')


def compact_mode() -> bool:
  """EASYREC_PACKED_COMPACT as in the JAX trainer (trainer.py:126-129):
  anything but '0' keeps Adam's moments as bf16 pairs."""
  return os.environ.get('EASYREC_PACKED_COMPACT', '1') != '0'


def table_meta(rows: int, dim: int, opt: SparseOptimizer) -> TableMeta:
  """The layout the trainer gives a table under `opt`: one part for the
  weights and one per slot, compact for Adam under compact_mode() where
  dim > 1 (the JAX package keeps dim-1 tables 3-part, embedding_layout
  pack_metas)."""
  return TableMeta(rows, dim, opt.n_parts,
                   compact=(compact_mode() and opt.has_compact and
                            opt.n_parts == 3 and dim > 1))


def row_layout(opt: SparseOptimizer, width: int, dim: int) -> bool:
  """Whether a table row of `width` columns at `dim` is `opt`'s compact
  layout (True) or its n_parts * dim layout (False); ValueError for any
  other width."""
  if width == opt.n_parts * dim:
    return False
  if opt.has_compact and width == 2 * dim:
    return True
  raise ValueError('table width %d is not a %s layout of dim %d (%d parts%s)'
                   % (width, opt.name, dim, opt.n_parts,
                      ', or 2 compact' if opt.has_compact else ''))


def slot_fill(meta: TableMeta, slot_init: Sequence[float]) -> List[float]:
  """The initial value of each physical slot part (init_packed_tables_on_
  device, embedding_layout.py:293-303): slot_init, or for a compact table
  its two values packed as one bf16 pair."""
  si = list(slot_init) + [0.0] * (meta.logical_parts - 1 - len(slot_init))
  if meta.compact:
    return [float(np_pack_pair(np.float32([si[0]]), np.float32([si[1]]))[0])]
  return si


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


def pack_host(weights: np.ndarray, slots: Sequence[np.ndarray],
              meta: TableMeta) -> np.ndarray:
  """(w [rows, dim], LOGICAL slot arrays [rows, dim]...) -> combined
  [rows, width] f32; compact metas pack the two slots into bf16 pairs (the
  JAX package's pack_host, without its groups)."""
  if meta.compact:
    assert len(slots) == 2, len(slots)
    slots = [np_pack_pair(slots[0], slots[1])]
  parts = [weights] + list(slots)
  assert len(parts) == meta.n_parts, (len(parts), meta.n_parts)
  return np.concatenate([np.asarray(p, np.float32) for p in parts], axis=1)


def unpack_host(table: np.ndarray, meta: TableMeta):
  """Combined [rows, width] -> (weights [rows, dim], LOGICAL slot arrays);
  compact metas decode the bf16 pair part back into two slots."""
  d = meta.dim
  parts = [np.ascontiguousarray(table[:, p * d:(p + 1) * d])
           for p in range(meta.n_parts)]
  if meta.compact:
    return parts[0], list(np_unpack_pair(parts[1]))
  return parts[0], parts[1:]


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
  unused k and for starts[N]). No host sync. The sort is stable, as the
  JAX package's argsort: a segment's slots keep their batch order, which
  fixes the order of its gradient sum on every device (PyTorch's unstable
  sort of up to 4,096 keys on the card is a bitonic network that orders
  equal keys otherwise than the CPU's)."""
  n = ids.shape[0]
  sids, order = torch.sort(ids, stable=True)
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


def _rows_vectorizable(*ts: torch.Tensor) -> bool:
  """The kernels load 16-byte float4s where every row of each tensor starts
  16-byte aligned (and, for a table, every dim-wide part with it), else
  scalars; the results are the same."""
  return all(t.shape[1] % 4 == 0 and t.data_ptr() % 16 == 0 for t in ts)


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


# ------------------------------------ K2: row RMW with any block math

@functools.lru_cache(maxsize=None)
def _opt_math(opt: SparseOptimizer, compact: bool):
  """(math name, math id, ctypes float array of its constants) for the
  kernels; kept per optimizer (a frozen dataclass), as the wrapper's host
  time falls inside a step's launch gaps."""
  math, consts = opt.kernel_math(compact)
  arr = (ctypes.c_float * MAX_CONSTS)(*(consts + [0.0] * (MAX_CONSTS -
                                                          len(consts))))
  return MATH_NAMES[math], math, arr


def _check_opt(opt, hypers, dev):
  if not isinstance(opt, SparseOptimizer):
    raise TypeError('%r is not a sparse optimizer of easyrec_torch.optim'
                    % (opt,))
  _check(hypers, 'hypers', torch.float32, (opt.n_hypers,), dev)


def _block(opt: SparseOptimizer, compact: bool, old: torch.Tensor,
           g: torch.Tensor, hyp: torch.Tensor) -> torch.Tensor:
  """The optimizer's block math on rows `old` [k, width]: its parts are
  dim-wide column slices, as the kernels read them."""
  dim = g.shape[1]
  parts = [old[:, p * dim:(p + 1) * dim] for p in range(old.shape[1] // dim)]
  new = opt.compact_block(*parts, g, hyp) if compact else \
      opt.block(parts, g, hyp)
  return torch.cat(list(new), dim=1)


def rmw_rows_plain(table: torch.Tensor, uids: torch.Tensor,
                   gsum: torch.Tensor, hypers: torch.Tensor,
                   opt: SparseOptimizer) -> torch.Tensor:
  """Plain PyTorch K2: the block math on each touched row (live id, some
  summed gradient nonzero: an all-zero row keeps its bytes, as in the JAX
  package's _math_and_mask), in place; returns `table`."""
  rows, width = table.shape
  compact = row_layout(opt, width, gsum.shape[1])
  live = (uids >= 0) & (uids < rows)
  touched = live & (gsum != 0).any(dim=1)
  idx = uids[touched]
  new = _block(opt, compact, table.index_select(0, idx), gsum[touched],
               hypers)
  table.index_copy_(0, idx, new)
  return table


def rmw_rows(table: torch.Tensor, uids: torch.Tensor, gsum: torch.Tensor,
             hypers: torch.Tensor, opt: SparseOptimizer) -> torch.Tensor:
  """`opt`'s block math on the rows `uids` names, in place: slots whose id
  lies outside [0, rows) are skipped and untouched rows keep their bytes.
  The table's width picks the layout (row_layout). CPU tensors: plain
  version; CUDA: K2."""
  rows, width = table.shape
  n, dim = gsum.shape
  dev = table.device
  _check_opt(opt, hypers, dev)
  compact = row_layout(opt, width, dim)
  _check(table, 'table', torch.float32, (rows, width), dev)
  _check(uids, 'uids', torch.int64, (n,), dev)
  _check(gsum, 'gsum', torch.float32, (n, dim), dev)
  if dev.type == 'cpu':
    return rmw_rows_plain(table, uids, gsum, hypers, opt)
  if dev.type != 'cuda':
    raise ValueError('rmw_rows: unsupported device %s' % dev)
  name, math, consts = _opt_math(opt, compact)
  kernels.RMW_ROWS.launch(
      dev, math, table.data_ptr(), uids.data_ptr(), gsum.data_ptr(),
      hypers.data_ptr(), consts, n, rows, dim,
      int(_rows_vectorizable(table, gsum)), tag=name)
  return table


# ------------------------- K3: fused segmented sum + row RMW, any math

def rmw_fused_plain(table: torch.Tensor, sids: torch.Tensor,
                    order: torch.Tensor, starts: torch.Tensor,
                    grads: torch.Tensor, hypers: torch.Tensor,
                    opt: SparseOptimizer) -> torch.Tensor:
  """Plain PyTorch K3: the kernel's chunk tree (segment_sums_by_chunk,
  f32), then K2's plain update; `table` is updated in place and
  returned."""
  n = grads.shape[0]
  sums = segment_sums_by_chunk(order, starts, grads)
  live = starts[:n] < n
  uids = torch.where(live, sids[starts[:n].clamp(max=n - 1)],
                     torch.full_like(sids, -1))
  return rmw_rows_plain(table, uids, sums, hypers, opt)


def rmw_fused(table: torch.Tensor, sids: torch.Tensor, order: torch.Tensor,
              starts: torch.Tensor, grads: torch.Tensor,
              hypers: torch.Tensor, opt: SparseOptimizer) -> torch.Tensor:
  """Sum each segment's gradients and run `opt`'s block math on its row,
  in place, with no [N, dim] sums in between (unused segments and ids
  outside the table skipped, untouched rows keep their bytes). Any dim and
  layout; the table's width picks the layout (row_layout). CPU tensors:
  plain version; CUDA: K3."""
  rows, width = table.shape
  n, dim = grads.shape
  dev = table.device
  _check_opt(opt, hypers, dev)
  compact = row_layout(opt, width, dim)
  _check(table, 'table', torch.float32, (rows, width), dev)
  _check(sids, 'sids', torch.int64, (n,), dev)
  _check(order, 'order', torch.int64, (n,), dev)
  _check(starts, 'starts', torch.int64, (n + 1,), dev)
  _check(grads, 'grads', torch.float32, (n, dim), dev)
  if dev.type == 'cpu':
    return rmw_fused_plain(table, sids, order, starts, grads, hypers, opt)
  if dev.type != 'cuda':
    raise ValueError('rmw_fused: unsupported device %s' % dev)
  partial = torch.empty((long_chunk_bound(n), dim), dtype=torch.float32,
                        device=dev)
  name, math, consts = _opt_math(opt, compact)
  kernels.RMW_FUSED.launch(
      dev, math, table.data_ptr(), sids.data_ptr(), order.data_ptr(),
      starts.data_ptr(), grads.data_ptr(), hypers.data_ptr(),
      partial.data_ptr(), consts, n, rows, dim,
      int(_rows_vectorizable(grads)), tag=name)
  return table


def fused_mode() -> bool:
  """EASYREC_PACKED_FUSED as in the JAX package: '1' takes K3, anything
  else K1 + K2."""
  return os.environ.get('EASYREC_PACKED_FUSED', '0') == '1'


def apply_packed_update(table: torch.Tensor, ids: torch.Tensor,
                        grads: torch.Tensor, hypers: torch.Tensor,
                        opt: SparseOptimizer, meta: TableMeta
                        ) -> torch.Tensor:
  """Sparse-update one combined table, in place, from raw (duplicated)
  ids [N] and their gradients [N, dim] with `opt`'s block math: K3 under
  EASYREC_PACKED_FUSED=1, else K1 then K2."""
  sids, order, starts = sort_segments(ids.reshape(-1).to(torch.int64))
  grads = grads.reshape(-1, meta.dim).to(torch.float32).contiguous()
  if fused_mode():
    return rmw_fused(table, sids, order, starts, grads, hypers, opt)
  uids, gsum = seg_sum(sids, order, starts, grads, meta.sentinel)
  return rmw_rows(table, uids, gsum, hypers, opt)
