"""Row-sparse (lazy) optimizers for the embedding tables.

Counterpart of easyrec_tpu/optim/sparse.py (:89-251): `dedup_sum` (:22),
the bf16-pair moment encoding `pack_pair` / `unpack_pair` (:41-59) and the
five sparse optimizers, SparseSGD, SparseMomentum, SparseAdagrad,
SparseAdam (compact and 3-part, with weight_decay) and SparseFtrl, and the
two block maths of the EV aux tables (easyrec_tpu/features/ev.py:202-206),
EvAdd and EvSet. Each carries what the JAX package's SparseOptimizer
carries:
  - `name`, `slot_names` and `slot_init` (the fill of each slot column);
  - `hypers(lr, step)`, the device tensor the kernels read: [lr], or
    [lr, 1/(1-b1^t), 1/(1-b2^t)] for Adam;
  - `block(parts, g, hyp)`, the block math on a row's parts [w, slot...]
    and its summed gradient: one torch op per JAX op, in the JAX order,
    with the static constants rounded to float32 as JAX's weak-typed
    Python floats are. The plain versions of the kernels K2 and K3
    (ops/packed_table.py) call it; the kernels run the same roundings in
    csrc/block_math.cuh;
  - `update_rows`, the plain-layout reference on separate [rows, D] arrays;
  - `kernel_math(compact)`, the math id and constants of block_math.cuh.
Moments and accumulators change only on rows the batch touched (the
reference's lazy/async semantics); Adam's bias correction uses the global
step.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, List, Sequence, Tuple

import numpy as np
import torch

_HI16 = 0xFFFF0000

# math ids of csrc/block_math.cuh
MATH_SGD, MATH_MOMENTUM, MATH_ADAGRAD, MATH_ADAM, MATH_COMPACT_ADAM, \
    MATH_FTRL, MATH_EV_ADD, MATH_EV_SET = range(8)
MATH_NAMES = ('sgd', 'momentum', 'adagrad', 'adam', 'compact_adam', 'ftrl',
              'ev_add', 'ev_set')
MAX_CONSTS = 8        # block_math.cuh kMaxConsts


def f32(x: float) -> float:
  """x rounded to float32, as JAX rounds a Python float it multiplies
  with a float32 array."""
  return float(np.float32(x))


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


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
  """1 / sqrt(x) with two correct roundings: the form block_math.cuh
  repeats (__fdiv_rn(1, __fsqrt_rn(x))), where torch.rsqrt would leave the
  rounding to the device's library."""
  return torch.reciprocal(torch.sqrt(x))


class SparseOptimizer:
  """Base of the row-sparse optimizers. Subclasses are frozen dataclasses
  of their static hyperparameters."""
  name: ClassVar[str] = ''
  slot_names: ClassVar[Tuple[str, ...]] = ()
  n_hypers: ClassVar[int] = 1

  @property
  def n_parts(self) -> int:
    """Logical parts of a combined row: the weights and each slot."""
    return 1 + len(self.slot_names)

  @property
  def slot_init(self) -> Tuple[float, ...]:
    return (0.0,) * len(self.slot_names)

  @property
  def has_compact(self) -> bool:
    """Whether the optimizer has a compact bf16-pair form (Adam only)."""
    return False

  def hypers(self, lr, step: torch.Tensor) -> torch.Tensor:
    """[lr] f32 on lr's device."""
    return torch.as_tensor(lr, dtype=torch.float32).reshape(1)

  def block(self, parts: Sequence[torch.Tensor], g: torch.Tensor,
            hyp: torch.Tensor) -> List[torch.Tensor]:
    raise NotImplementedError

  def kernel_math(self, compact: bool = False) -> Tuple[int, List[float]]:
    """(math id, constants) of csrc/block_math.cuh."""
    raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SparseSGD(SparseOptimizer):
  """sparse_sgd (:89-101): w - lr g."""
  name: ClassVar[str] = 'sgd'

  def block(self, parts, g, hyp):
    return [parts[0] - hyp[0] * g]

  def update_rows(self, table, state, uids, ug, lr, step):
    table.index_add_(0, uids.to(torch.int64), -lr * ug)
    return table, state

  def kernel_math(self, compact=False):
    return MATH_SGD, []


@dataclasses.dataclass(frozen=True)
class SparseMomentum(SparseOptimizer):
  """sparse_momentum (:104-121): m = momentum m + g; w - lr m."""
  momentum: float = 0.9
  name: ClassVar[str] = 'momentum'
  slot_names: ClassVar[Tuple[str, ...]] = ('m',)

  def block(self, parts, g, hyp):
    w, m = parts
    m_new = f32(self.momentum) * m + g
    return [w - hyp[0] * m_new, m_new]

  def update_rows(self, table, state, uids, ug, lr, step):
    idx = uids.to(torch.int64)
    m_rows = f32(self.momentum) * state['m'].index_select(0, idx) + ug
    state['m'].index_copy_(0, idx, m_rows)
    table.index_add_(0, idx, -lr * m_rows)
    return table, state

  def kernel_math(self, compact=False):
    return MATH_MOMENTUM, [f32(self.momentum)]


@dataclasses.dataclass(frozen=True)
class SparseAdagrad(SparseOptimizer):
  """sparse_adagrad (:124-143): acc += g^2; w - lr g rsqrt(acc + eps)."""
  initial_accumulator: float = 0.1
  eps: float = 1e-10
  name: ClassVar[str] = 'adagrad'
  slot_names: ClassVar[Tuple[str, ...]] = ('accum',)

  @property
  def slot_init(self):
    return (self.initial_accumulator,)

  def block(self, parts, g, hyp):
    w, acc = parts
    acc_new = acc + g * g
    return [w - hyp[0] * g * _rsqrt(acc_new + f32(self.eps)), acc_new]

  def update_rows(self, table, state, uids, ug, lr, step):
    idx = uids.to(torch.int64)
    acc_rows = state['accum'].index_select(0, idx) + ug * ug
    state['accum'].index_copy_(0, idx, acc_rows)
    table.index_add_(0, idx, -lr * ug * _rsqrt(acc_rows + f32(self.eps)))
    return table, state

  def kernel_math(self, compact=False):
    return MATH_ADAGRAD, [f32(self.eps)]


@dataclasses.dataclass(frozen=True)
class SparseAdam(SparseOptimizer):
  """sparse_adam (:146-203): lazy Adam, with `weight_decay` as AdamW's
  decoupled decay. Two layouts: 3-part [w | m | v] f32 (`block`) and the
  compact [w | mv], moments as bf16 pairs (`compact_block`)."""
  b1: float = 0.9
  b2: float = 0.999
  eps: float = 1e-8
  weight_decay: float = 0.0
  name: ClassVar[str] = 'adam'
  slot_names: ClassVar[Tuple[str, ...]] = ('m', 'v')
  n_hypers: ClassVar[int] = 3

  @property
  def has_compact(self) -> bool:
    return True

  @property
  def constants(self):
    """(b1, 1-b1, b2, 1-b2, eps) as the float32 values the JAX package's
    float32 arithmetic uses (Python floats round once to float32)."""
    return tuple(f32(x) for x in
                 (self.b1, 1 - self.b1, self.b2, 1 - self.b2, self.eps))

  def hypers(self, lr: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """[lr, 1/(1-b1^t), 1/(1-b2^t)] f32 with t = step + 1, on lr's device;
    the bias corrections are precomputed so the kernel has no pow."""
    t = (step + 1).to(torch.float32)
    return torch.stack([torch.as_tensor(lr, dtype=torch.float32),
                        1.0 / (1 - torch.pow(self.b1, t)),
                        1.0 / (1 - torch.pow(self.b2, t))])

  def _moments(self, m, v, g, hyp):
    b1, omb1, b2, omb2, eps = self.constants
    lr, c1, c2 = hyp[0], hyp[1], hyp[2]
    m_new = b1 * m + omb1 * g
    v_new = b2 * v + omb2 * (g * g)
    upd = (-lr) * (m_new * c1) / (torch.sqrt(v_new * c2) + eps)
    return m_new, v_new, upd

  def _decay(self, upd, w, hyp):
    if self.weight_decay:
      upd = upd - hyp[0] * f32(self.weight_decay) * w
    return upd

  def block(self, parts, g, hyp):
    w, m, v = parts
    m_new, v_new, upd = self._moments(m, v, g, hyp)
    return [w + self._decay(upd, w, hyp), m_new, v_new]

  def compact_block(self, w: torch.Tensor, mv: torch.Tensor,
                    g: torch.Tensor, hyp: torch.Tensor):
    """New (w, mv) rows from old rows and summed gradients. The weight
    update uses the PRE-rounding f32 moments; only the carried state is
    bf16. One torch op per rounding, in the kernel's order."""
    m, v = unpack_pair(mv)
    m_new, v_new, upd = self._moments(m, v, g, hyp)
    return w + self._decay(upd, w, hyp), pack_pair(m_new, v_new)

  def update_rows(self, table: torch.Tensor, state, uids: torch.Tensor,
                  ug: torch.Tensor, lr, step: torch.Tensor):
    """Lazy Adam on separate f32 arrays: `table` and `state['m']`,
    `state['v']` are [rows, D]; `uids` [N] (duplicates only where their
    gradients are zero, as dedup_sum pads) and `ug` [N, D] their summed
    gradients. Updates the three arrays in place and returns (table,
    state). One torch op per JAX op, in its order."""
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
    if self.weight_decay:
      upd = upd - lr * f32(self.weight_decay) * table.index_select(0, idx)
    table.index_add_(0, idx, upd)
    return table, {'m': m, 'v': v}

  def kernel_math(self, compact=False):
    return (MATH_COMPACT_ADAM if compact else MATH_ADAM,
            list(self.constants) + [f32(self.weight_decay)])


def ftrl_pow(x: torch.Tensor, p: float) -> torch.Tensor:
  """x^p as block_math.cuh's ftrl_pow computes it: the exponents ATen's pow
  special-cases are written out (0.5 is a correctly rounded sqrt), so the
  kernel and this plain version round alike; any other p is pow on both
  sides (powf in the kernel)."""
  if p == 0.5:
    return torch.sqrt(x)
  if p == -0.5:
    return _rsqrt(x)
  if p == 1.0:
    return x
  if p == 2.0:
    return x * x
  if p == -1.0:
    return torch.reciprocal(x)
  return torch.pow(x, p)


@dataclasses.dataclass(frozen=True)
class SparseFtrl(SparseOptimizer):
  """sparse_ftrl (:206-251), TF's FTRL with l2_shrinkage; slots (accum,
  z)."""
  learning_rate_power: float = -0.5
  initial_accumulator: float = 0.1
  l1: float = 0.0
  l2: float = 0.0
  l2_shrinkage: float = 0.0
  name: ClassVar[str] = 'ftrl'
  slot_names: ClassVar[Tuple[str, ...]] = ('accum', 'z')

  @property
  def slot_init(self):
    return (self.initial_accumulator, 0.0)

  @property
  def constants(self):
    """(p, l1, 2*l2, 2*l2_shrinkage) in float32, p = -learning_rate_power."""
    return (f32(-self.learning_rate_power), f32(self.l1), f32(2 * self.l2),
            f32(2.0 * self.l2_shrinkage))

  def _ftrl(self, w, acc, z, g, lr):
    p, l1, two_l2, two_l2s = self.constants
    acc_new = acc + g * g
    pow_new = ftrl_pow(acc_new, p)
    sigma = (pow_new - ftrl_pow(acc, p)) / lr
    gz = g + two_l2s * w if self.l2_shrinkage else g
    z_new = z + gz - sigma * w
    w_new = torch.where(z_new.abs() <= l1, 0.0,
                        -(z_new - torch.sign(z_new) * l1) /
                        (pow_new / lr + two_l2))
    return w_new, acc_new, z_new

  def block(self, parts, g, hyp):
    w, acc, z = parts
    return list(self._ftrl(w, acc, z, g, hyp[0]))

  def update_rows(self, table, state, uids, ug, lr, step):
    idx = uids.to(torch.int64)
    w_new, acc_new, z_new = self._ftrl(
        table.index_select(0, idx), state['accum'].index_select(0, idx),
        state['z'].index_select(0, idx), ug, lr)
    state['accum'].index_copy_(0, idx, acc_new)
    state['z'].index_copy_(0, idx, z_new)
    table.index_copy_(0, idx, w_new)
    return table, state

  def kernel_math(self, compact=False):
    return MATH_FTRL, list(self.constants) + \
        [1.0 if self.l2_shrinkage else 0.0]


class _EvMath(SparseOptimizer):
  """An EV aux table's block math: one part, dim 1, hypers [step as f32]."""

  def hypers(self, lr, step: torch.Tensor) -> torch.Tensor:
    return step.to(torch.float32).reshape(1)


@dataclasses.dataclass(frozen=True)
class EvAdd(_EvMath):
  """The admission count's block math, ev.py's add_math: c + g, the summed
  gradient being the row's occurrences in the batch (a gradient of
  ones)."""
  name: ClassVar[str] = 'ev_add'

  def block(self, parts, g, hyp):
    return [parts[0] + g]

  def kernel_math(self, compact=False):
    return MATH_EV_ADD, []


@dataclasses.dataclass(frozen=True)
class EvSet(_EvMath):
  """The last-seen step's block math, ev.py's set_math: every touched row
  set to hypers[0], the step as f32 (exact up to 2^24 steps)."""
  name: ClassVar[str] = 'ev_set'

  def block(self, parts, g, hyp):
    return [torch.zeros_like(parts[0]) + hyp[0]]

  def kernel_math(self, compact=False):
    return MATH_EV_SET, []
