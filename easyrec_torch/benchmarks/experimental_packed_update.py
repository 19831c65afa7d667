"""EXPERIMENTAL (not wired): sparse update over a packed [groups, 8, width]
combined table.

Counterpart of benchmarks/experimental_packed_update.py, which is not
wired into the JAX package's training either; nothing of the port calls
this module outside its benchmarks and tests. The update:

  1. dedups ids at the GROUP level (one group = 8 physical rows = pack*8
     logical rows; groups are the unit the write-back moves),
  2. turns per-id gradients into per-group dense gradient blocks with a
     sorted segment sum (no scatter),
  3. gathers the groups, runs the optimizer math on lane-aligned views
     (touched lanes only: untouched lanes keep their bytes), and writes
     the groups back in place: `_kernel_apply` through kernel K4
     (ops/group_dma.py `group_push`), `_plain_apply` with index_copy_.

Contract of the callers, as in the JAX module: `optimizer` has
`update_parts(w, slots, g, lr, step) -> (w_new, slots_new)` over
[n*8, pack*dim] views, and `meta` has rows, dim, pack, width,
group_rows, scratch and combined_cols (weight plus slot columns a
logical row). The JAX package defines neither such an optimizer nor
`combined_cols`; the port adds none.

Correctness:
  - group ids are unique except the padding tail, which names the
    scratch group with zero gradients, so its rows come back unchanged
    and duplicate writes carry identical bytes;
  - "touched" lanes are lanes with a nonzero summed gradient; a touched
    row whose gradients cancel to exactly 0 keeps its bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from easyrec_torch.benchmarks.bench_packed_v2 import pad_to_chunk
from easyrec_torch.ops.group_dma import group_push


def _group_prep(uids: torch.Tensor, ug: torch.Tensor, meta):
  """(sorted unique logical uids, grads [n, dim]) -> (unique group ids
  [n], dense group grads [n, 8, pack*dim]). Two lanes of one physical row
  sum into disjoint lane slots, so the index_add_ is exact."""
  n = uids.shape[0]
  dev = uids.device
  group_rows = meta.group_rows
  pack, dim = meta.pack, meta.dim
  gids = uids // group_rows
  within = uids % group_rows
  sub = within // pack                       # physical sublane [0, 8)
  lane = within % pack                       # logical lane in the row
  first = torch.ones(n, dtype=torch.bool, device=dev)
  first[1:] = gids[1:] != gids[:-1]
  gseg = torch.cumsum(first, 0) - 1
  scratch_gid = meta.scratch // group_rows
  ugids = torch.full((n,), scratch_gid, dtype=gids.dtype,
                     device=dev).scatter_(0, gseg, gids)
  # expand each update's grad into its lane slot of a [pack*dim] row
  tiled = ug.to(torch.float32).repeat(1, pack)            # [n, pack*dim]
  col = torch.arange(pack * dim, device=dev)
  expanded = torch.where((col // dim)[None, :] == lane[:, None], tiled,
                         torch.zeros((), device=dev))
  flat = gseg * 8 + sub
  group_g = torch.zeros((n * 8, pack * dim), device=dev).index_add_(
      0, flat, expanded)
  return ugids, group_g.reshape(n, 8, pack * dim)


def _part_columns(meta):
  """Static lane-index vectors: columns of part s (0 = weights, 1.. =
  slots) inside one physical row, plus the inverse permutation that
  reassembles a physical row from the concatenated parts."""
  c, pack, dim = meta.combined_cols, meta.pack, meta.dim
  n_parts = c // dim
  parts = []
  for s in range(n_parts):
    cols = np.add.outer(np.arange(pack) * c + s * dim,
                        np.arange(dim)).reshape(-1)
    parts.append(cols)
  order = np.concatenate(parts)                # part-major column order
  inverse = np.argsort(order)
  return parts, inverse


def _update_groups(rows, group_g, optimizer, lr, step, meta):
  """rows [n, 8, width] pulled groups -> updated groups (same shape).

  group_g: [n, 8, pack*dim] dense per-physical-row gradients (zero =
  untouched lane). The math runs on [n*8, pack*dim] views."""
  n = rows.shape[0]
  dev = rows.device
  parts_idx, inverse_idx = _part_columns(meta)
  rows2 = rows.reshape(n * 8, meta.width).to(torch.float32)
  g = group_g.reshape(n * 8, meta.pack * meta.dim)
  w = rows2.index_select(1, torch.from_numpy(parts_idx[0]).to(dev))
  slots = [rows2.index_select(1, torch.from_numpy(idx).to(dev))
           for idx in parts_idx[1:]]
  w_new, slots_new = optimizer.update_parts(w, slots, g, lr, step)
  # touched lane = any nonzero grad component in its dim-block, through a
  # static block-diagonal product
  block = torch.from_numpy(np.kron(
      np.eye(meta.pack, dtype=np.float32),
      np.ones((meta.dim, meta.dim), np.float32))).to(dev)
  touched = ((g != 0.0).to(torch.float32) @ block) > 0.0
  w_new = torch.where(touched, w_new, w)
  slots_new = [torch.where(touched, s_new, s_old)
               for s_new, s_old in zip(slots_new, slots)]
  merged = torch.cat([w_new] + slots_new, dim=1)
  out = merged.index_select(1, torch.from_numpy(inverse_idx).to(dev))
  return out.reshape(n, 8, meta.width).to(rows.dtype)


def _take_groups(table: torch.Tensor, ugids: torch.Tensor, meta):
  """[n] group ids -> [n, 8, width] groups."""
  return table.reshape(-1, 8, meta.width).index_select(0, ugids)


def _plain_apply(table, ugids, group_g, optimizer, lr, step, meta):
  """Gather, optimizer math, index_copy_ write-back, in place (the
  counterpart of _xla_apply :162)."""
  rows = _take_groups(table, ugids, meta)          # [n, 8, width]
  new_rows = _update_groups(rows, group_g, optimizer, lr, step, meta)
  return table.index_copy_(0, ugids.to(torch.int64), new_rows)


def _kernel_apply(table, ugids, group_g, optimizer, lr, step, meta):
  """Gather and optimizer math in PyTorch, then the scattered write-back
  through K4 (the counterpart of _pallas_apply :169). As there, the slots
  are padded to the TPU kernel's chunk with scratch-group slots carrying
  its current bytes."""
  rows = _take_groups(table, ugids, meta)          # [n, 8, width]
  new_rows = _update_groups(rows, group_g, optimizer, lr, step, meta)
  return group_push(table, *pad_to_chunk(table, ugids, new_rows,
                                         meta.scratch // meta.group_rows))


def apply_group_updates(table, uids, ug, optimizer, lr, step, meta):
  """Update the touched logical rows of one packed combined table
  [groups, 8, width], in place; returns it.

  uids: sorted, deduplicated logical ids (scratch-row padded); ug their
  summed gradients [n, dim]. The write-back goes through group_push: K4
  for a CUDA table, its plain version for a CPU one.
  """
  ugids, group_g = _group_prep(uids, ug, meta)
  return _kernel_apply(table, ugids, group_g, optimizer, lr, step, meta)
