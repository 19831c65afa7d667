"""Optimizer construction from the Optimizer message (Adam only).

Counterpart of easyrec_tpu/optim/builder.py (:117-156): one configured
optimizer drives both the dense parameters (DenseAdam, optax.adam's
arithmetic) and the embedding tables (optim/sparse.SparseAdam) off one
schedule; with two, the FIRST drives the tables and the SECOND the dense
parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from easyrec_torch.config.text_format import Message
from easyrec_torch.optim import schedules
from easyrec_torch.optim.sparse import SparseAdam


class DenseAdam:
  """optax.adam over a list of parameters, in place.

  Per parameter: mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu; with
  c = count + 1, update = (mu / (1 - b1^c)) / (sqrt(nu / (1 - b2^c)) + eps)
  and p += -lr * update, where lr = schedule(count) is read BEFORE count is
  incremented — the order of optax's scale_by_adam and scale_by_schedule.
  count lives on the parameters' device, so a step syncs nothing.
  """

  def __init__(self, params: List[torch.Tensor], schedule: Callable,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    self.params = list(params)
    self.schedule = schedule
    self.b1, self.b2, self.eps = b1, b2, eps
    self.mu = [torch.zeros_like(p) for p in self.params]
    self.nu = [torch.zeros_like(p) for p in self.params]
    dev = self.params[0].device if self.params else torch.device('cpu')
    self.count = torch.zeros((), dtype=torch.int32, device=dev)

  @torch.no_grad()
  def step(self) -> None:
    b1, b2, eps = self.b1, self.b2, self.eps
    lr = self.schedule(self.count)
    count_inc = self.count + 1
    bc1 = 1 - torch.pow(b1, count_inc.to(torch.float32))
    bc2 = 1 - torch.pow(b2, count_inc.to(torch.float32))
    neg_lr = -lr
    for p, mu, nu in zip(self.params, self.mu, self.nu):
      g = p.grad if p.grad is not None else torch.zeros_like(p)
      mu.copy_((1 - b1) * g + b1 * mu)
      nu.copy_((1 - b2) * (g * g) + b2 * nu)
      upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
      p.add_(neg_lr * upd)
    self.count = count_inc


@dataclasses.dataclass
class OptimizerPair:
  sparse: SparseAdam
  schedule: Callable
  b1: float
  b2: float
  embedding_lr_multiplier: float = 1.0

  def dense(self, params) -> DenseAdam:
    return DenseAdam(params, self.schedule, self.b1, self.b2)


def build_optimizer(opt_config: Optional[Message]) -> OptimizerPair:
  which = opt_config.WhichOneof('optimizer') if opt_config is not None \
      else None
  if which is None:
    cfg = Message('AdamOptimizer')
  elif which == 'adam_optimizer':
    cfg = opt_config.adam_optimizer
  else:
    raise NotImplementedError('optimizer %s is not ported' % which)
  if opt_config is not None and opt_config.use_moving_average:
    raise NotImplementedError('use_moving_average is not ported')
  schedule = schedules.build_schedule(
      cfg.learning_rate if cfg.HasField('learning_rate') else None)
  mult = opt_config.embedding_learning_rate_multiplier \
      if opt_config is not None and \
      opt_config.HasField('embedding_learning_rate_multiplier') else 1.0
  return OptimizerPair(sparse=SparseAdam(b1=cfg.beta1, b2=cfg.beta2),
                       schedule=schedule, b1=cfg.beta1, b2=cfg.beta2,
                       embedding_lr_multiplier=mult)


def build_optimizers(train_config) -> Tuple[OptimizerPair,
                                            Optional[OptimizerPair]]:
  """(primary, embedding_override), as the JAX package groups them."""
  opts = list(train_config.optimizer_config)
  if not opts:
    return build_optimizer(None), None
  if len(opts) == 1:
    return build_optimizer(opts[0]), None
  return build_optimizer(opts[1]), build_optimizer(opts[0])
