"""Whole-group write-back and read-modify-write on a packed table.

Counterpart of the five Pallas kernels of the JAX package's packed-group
prototypes (benchmarks/), which compute two functions on a [G, 8, W] f32
table, one [8, W] group per slot:
  - `group_push` -> kernel K4 (csrc/group_push.cu): the scattered
    write-back table3[gids[i]] = rows[i] of push_variant
    (bench_packed_stages.py:52), _pallas_apply
    (experimental_packed_update.py:169) and push_groups_pallas
    (bench_packed_v2.py:127);
  - `group_rmw` -> kernel K5 (csrc/group_rmw.cu): the in-place affine RMW
    of kernel (bench_pallas_group_dma.py:22), make_kernel
    (bench_dma_issue.py:34) and rmw_variant (bench_packed_stages.py:96).
Each wrapper runs its plain PyTorch version when its tensors lie on the
CPU and launches its kernel when they lie on a CUDA device; there is no
other switch between the two.

Slot ids are unique except for pad slots naming the scratch group. A push
gives those slots the scratch group's current bytes, so it is
deterministic; after an RMW the scratch group's bytes are unspecified on
the card (its slots race), as they are on the TPU.

An id outside [0, G) raises IndexError on both paths: at the call in the
plain versions (index_copy_, index_select), and at the next `check_ids`
on the card, where the kernel leaves that slot out and sets a flag on the
device so that no call waits for the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from easyrec_torch.ops import kernels

# K5's default launch shape: threads a group, groups a block (K4's fixed
# shape, kThreads and kPerBlock of csrc/group_push.cu, is the same)
THREADS = 64
PER_BLOCK = 4

# a device's flags of ids outside the table: [K4, K5], int32, set to 1 by
# the kernel, read and cleared by check_ids
_BAD_IDS: Dict[torch.device, torch.Tensor] = {}
_FLAG_NAMES = ('group_push', 'group_rmw')


def _bad_id_flag(device: torch.device, which: int) -> int:
  """Device address of one kernel's out-of-range flag on `device`."""
  flags = _BAD_IDS.get(device)
  if flags is None:
    flags = _BAD_IDS[device] = torch.zeros(2, dtype=torch.int32,
                                           device=device)
  return flags.data_ptr() + 4 * which


def check_ids(device: Union[str, torch.device]) -> None:
  """Raise IndexError if K4 or K5 met a slot id outside its table on
  `device` since the last check (the slot was left out), and clear the
  flags. Waits for the work queued on the device's current stream. A CPU
  device has nothing to check: the plain versions raise at the call."""
  device = torch.device(device)
  if device.type == 'cuda' and device.index is None:
    device = torch.device('cuda', torch.cuda.current_device())
  flags = _BAD_IDS.get(device)
  if flags is None:
    return
  bad = flags.tolist()
  if any(bad):
    flags.zero_()
    raise IndexError('%s: a slot id lay outside the table; the slot was '
                     'left out' % ' and '.join(
                         n for n, b in zip(_FLAG_NAMES, bad) if b))


def _f32(x: float) -> float:
  """A Python float rounded to the float32 the kernels compute with."""
  return float(np.float32(x))


def _check_group_args(table3: torch.Tensor, gids: torch.Tensor,
                      slot_rows: Optional[torch.Tensor], what: str):
  """Validate a [G, ...] f32 table, [n] int ids and an optional [n, ...]
  per-slot tensor of the table's group shape; returns (groups, n, elems)."""
  dev = table3.device
  if table3.dtype != torch.float32 or table3.dim() < 2:
    raise TypeError('%s: table must be f32 [groups, ...], got %s %s'
                    % (what, table3.dtype, tuple(table3.shape)))
  if gids.dtype not in (torch.int32, torch.int64) or gids.dim() != 1:
    raise TypeError('%s: gids must be int32 or int64 [n], got %s %s'
                    % (what, gids.dtype, tuple(gids.shape)))
  groups, n = table3.shape[0], gids.shape[0]
  elems = int(np.prod(table3.shape[1:]))
  for name, t in (('table', table3), ('gids', gids), ('rows', slot_rows)):
    if t is None:
      continue
    if t.device != dev:
      raise ValueError('%s: %s on %s, table on %s' % (what, name, t.device,
                                                      dev))
    if not t.is_contiguous():
      raise ValueError('%s: %s is not contiguous' % (what, name))
  if slot_rows is not None:
    if slot_rows.dtype != torch.float32 or \
        tuple(slot_rows.shape) != (n,) + tuple(table3.shape[1:]):
      raise ValueError('%s: per-slot rows must be f32 %s, got %s %s'
                       % (what, (n,) + tuple(table3.shape[1:]),
                          slot_rows.dtype, tuple(slot_rows.shape)))
  if dev.type == 'cuda':
    if elems % 4:
      raise ValueError('%s: a group of %d floats is not a whole number of '
                       'float4' % (what, elems))
    for name, t in (('table', table3), ('rows', slot_rows)):
      if t is not None and t.data_ptr() % 16:
        raise ValueError('%s: %s is not 16-byte aligned' % (what, name))
  elif dev.type != 'cpu':
    raise ValueError('%s: unsupported device %s' % (what, dev))
  return groups, n, elems


# ---------------------------------------------- K4: group write-back

def group_push_plain(table3: torch.Tensor, gids: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch K4: one index_copy_ over the flattened groups. It
  raises IndexError on an id outside the table (K4 flags it for
  check_ids)."""
  groups, n = table3.shape[0], gids.shape[0]
  table3.view(groups, -1).index_copy_(0, gids.to(torch.int64),
                                      rows.reshape(n, -1))
  return table3


def group_push(table3: torch.Tensor, gids: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
  """table3[gids[i]] = rows[i] for every slot, in place; returns table3.
  Ids lie in [0, G) and are unique except for slots naming one group with
  identical rows. CPU tensors: plain version; CUDA: K4."""
  groups, n, elems = _check_group_args(table3, gids, rows, 'group_push')
  if table3.device.type == 'cpu':
    return group_push_plain(table3, gids, rows)
  kernels.GROUP_PUSH.launch(
      table3.device, table3.data_ptr(), gids.data_ptr(), rows.data_ptr(),
      _bad_id_flag(table3.device, 0), n, groups, elems,
      int(gids.dtype == torch.int64))
  return table3


# --------------------------------------- K5: affine group RMW, in place

def group_rmw_plain(table3: torch.Tensor, gids: torch.Tensor, a: float,
                    b: float, gg: Optional[torch.Tensor] = None,
                    c: float = 0.0) -> torch.Tensor:
  """Plain PyTorch K5: index_select, then round(a*x) + b (or + round(c*gg))
  as separate f32 ops, in the kernel's order, then index_copy_. Pad slots
  naming one group each see its bytes from before the call. It raises
  IndexError on an id outside the table (K5 flags it for check_ids)."""
  groups, n = table3.shape[0], gids.shape[0]
  flat = table3.view(groups, -1)
  idx = gids.to(torch.int64)
  x = flat.index_select(0, idx) * _f32(a)
  x = x + (_f32(b) if gg is None else gg.reshape(n, -1) * _f32(c))
  flat.index_copy_(0, idx, x)
  return table3


def group_rmw(table3: torch.Tensor, gids: torch.Tensor, a: float, b: float,
              gg: Optional[torch.Tensor] = None, c: float = 0.0, *,
              threads: int = THREADS,
              per_block: int = PER_BLOCK) -> torch.Tensor:
  """In place, for every slot i and element x of group gids[i]:
  x' = a*x + b, or with gg, x' = a*x + c*gg[i] (b must then be 0), each
  product and sum rounded to f32 on its own. Returns table3.

  `threads` (a power of two in [32, 1024]) and `per_block` (threads *
  per_block <= 1024) are K5's launch shape: threads a group and groups a
  block. CPU tensors: plain version (the shape is only checked); CUDA: K5.
  """
  groups, n, elems = _check_group_args(table3, gids, gg, 'group_rmw')
  if gg is not None and b != 0.0:
    raise ValueError('group_rmw: with gg the added term is c*gg; b must be '
                     '0, got %r' % (b,))
  if threads < 32 or threads > 1024 or threads & (threads - 1) or \
      per_block < 1 or threads * per_block > 1024:
    raise ValueError('group_rmw: launch shape threads=%d per_block=%d: '
                     'threads a power of two in [32, 1024], threads * '
                     'per_block <= 1024' % (threads, per_block))
  if table3.device.type == 'cpu':
    return group_rmw_plain(table3, gids, a, b, gg, c)
  kernels.GROUP_RMW.launch(
      table3.device, table3.data_ptr(), gids.data_ptr(),
      None if gg is None else gg.data_ptr(), _bad_id_flag(table3.device, 1),
      n, groups, elems, int(gids.dtype == torch.int64), _f32(a), _f32(b),
      _f32(c), threads, per_block)
  return table3
