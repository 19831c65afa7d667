"""Row-sparse (lazy) Adam for the embedding tables.

Counterpart of easyrec_tpu/optim/sparse.py: `SparseAdam.hypers` and
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
