"""Row-sparse (lazy) Adam for the embedding tables.

Counterpart of easyrec_tpu/optim/sparse.py: `dedup_sum` (:22), Adam's
separate-array `update_rows` (:155-167), `SparseAdam.hypers` and
`compact_block` (:146-203) and the bf16-pair moment encoding `pack_pair` /
`unpack_pair` (:41-59). Moments decay and update only on rows the batch
touched (the reference's AdamAsync semantics); bias correction uses the
global step. Only Adam is ported: it is the flagship's optimizer, and the
CUDA kernel K2 (csrc/rmw_adam.cu) runs exactly this block math.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_HI16 = 0xFFFF0000


def dedup_sum(ids: torch.Tensor, grads: torch.Tensor, scratch_row: int):
  """Combine duplicate row ids: returns (uids [N], ugrads [N, D]), the
  unique ids in sorted order and their summed gradients. Slots beyond the
  number of unique ids name `scratch_row` with a zero gradient. The sums
  are index_add_ in sorted slot order on the CPU, as XLA's sorted
  segment_sum; on the card index_add_ adds with atomics in no fixed
  order."""
  n = ids.shape[0]
  order = torch.argsort(ids, stable=True)
  sids = ids.index_select(0, order)
  sgrads = grads.index_select(0, order)
  first = torch.ones(n, dtype=torch.bool, device=ids.device)
  first[1:] = sids[1:] != sids[:-1]
  seg = torch.cumsum(first, 0) - 1
  ugrads = torch.zeros_like(grads).index_add_(0, seg, sgrads)
  uids = torch.full((n,), scratch_row, dtype=ids.dtype,
                    device=ids.device).scatter_(0, seg, sids)
  return uids, ugrads


def bf16_bits(x: torch.Tensor) -> torch.Tensor:
  """f32 -> round-to-nearest-even bf16 bits in the top 16 of a u32, as an
  int64 tensor."""
  u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
  return (u + 0x7FFF + ((u >> 16) & 1)) & _HI16


def pack_pair(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Two f32 -> one f32 carrying (bf16(m) << 16 | bf16(v))."""
  u = bf16_bits(m) | (bf16_bits(v) >> 16)
  return u.to(torch.int32).view(torch.float32)   # wraps to the same bits


def unpack_pair(mv: torch.Tensor):
  u = mv.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
  m = (u & _HI16).to(torch.int32).view(torch.float32)
  v = ((u << 16) & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
  return m, v


@dataclasses.dataclass(frozen=True)
class SparseAdam:
  """Lazy Adam over the compact table layout (moments as bf16 pairs)."""
  b1: float = 0.9
  b2: float = 0.999
  eps: float = 1e-8
  name: str = 'adam'

  @property
  def constants(self):
    """(b1, 1-b1, b2, 1-b2, eps) as the float32 values the JAX package's
    float32 arithmetic uses (Python floats round once to float32)."""
    return tuple(float(np.float32(x)) for x in
                 (self.b1, 1 - self.b1, self.b2, 1 - self.b2, self.eps))

  def hypers(self, lr: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """[lr, 1/(1-b1^t), 1/(1-b2^t)] f32 with t = step + 1, on lr's device;
    the bias corrections are precomputed so the kernel has no pow."""
    t = (step + 1).to(torch.float32)
    return torch.stack([lr.to(torch.float32),
                        1.0 / (1 - torch.pow(self.b1, t)),
                        1.0 / (1 - torch.pow(self.b2, t))])

  def compact_block(self, w: torch.Tensor, mv: torch.Tensor,
                    g: torch.Tensor, hyp: torch.Tensor):
    """New (w, mv) rows from old rows and summed gradients. The weight
    update uses the PRE-rounding f32 moments; only the carried state is
    bf16. One torch op per rounding, in the kernel's order."""
    b1, omb1, b2, omb2, eps = self.constants
    lr, c1, c2 = hyp[0], hyp[1], hyp[2]
    m, v = unpack_pair(mv)
    m_new = b1 * m + omb1 * g
    v_new = b2 * v + omb2 * (g * g)
    upd = (-lr) * (m_new * c1) / (torch.sqrt(v_new * c2) + eps)
    return w + upd, pack_pair(m_new, v_new)

  def update_rows(self, table: torch.Tensor, state, uids: torch.Tensor,
                  ug: torch.Tensor, lr, step: torch.Tensor,
                  weight_decay: float = 0.0):
    """Lazy Adam on separate f32 arrays: `table` and `state['m']`,
    `state['v']` are [rows, D]; `uids` [N] (duplicates only where their
    gradients are zero, as dedup_sum pads) and `ug` [N, D] their summed
    gradients. Updates the three arrays in place and returns (table,
    state). `weight_decay` is sparse_adam(weight_decay=...)'s. One torch
    op per JAX op, in its order."""
    idx = uids.to(torch.int64)
    m, v = state['m'], state['v']
    b1, omb1, b2, omb2, eps = self.constants
    t = (step + 1).to(torch.float32)
    m_rows = b1 * m.index_select(0, idx) + omb1 * ug
    v_rows = b2 * v.index_select(0, idx) + omb2 * (ug * ug)
    m.index_copy_(0, idx, m_rows)
    v.index_copy_(0, idx, v_rows)
    mhat = m_rows / (1 - torch.pow(self.b1, t))
    vhat = v_rows / (1 - torch.pow(self.b2, t))
    upd = -lr * mhat / (torch.sqrt(vhat) + eps)
    if weight_decay:
      upd = upd - lr * weight_decay * table.index_select(0, idx)
    table.index_add_(0, idx, upd)
    return table, {'m': m, 'v': v}
