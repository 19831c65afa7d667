"""Optimizer construction from the Optimizer message.

Counterpart of easyrec_tpu/optim/builder.py (:33-137): each configured
optimizer gives a PAIR, a dense optimizer over the model's parameters and a
row-sparse twin for the embedding tables (optim/sparse.py), driven by one
schedule. With two configured optimizers the FIRST drives the tables and
the SECOND the dense parameters. The dense optimizers repeat optax 0.2.6's
arithmetic in place, one torch op per optax op:
  adam / adam_async / lazy_adam  scale_by_adam, then -lr
  adamw / adam_asyncw            scale_by_adam, add_decayed_weights, -lr
  adagrad, ftrl                  scale_by_rss(initial_accumulator_value,
                                 eps 1e-7), then -lr (optax has no FTRL: the
                                 JAX package takes adagrad for it)
  momentum                       trace(momentum), then -lr
  momentumw                      add_decayed_weights, trace, then -lr
  rms_prop                       scale_by_rms(decay, eps), -lr, then
                                 trace(momentum)
`gradient_clipping_by_norm` puts clip_by_global_norm ahead of the dense
transform. `use_moving_average` is not ported and raises. A dense
optimizer's state (`state_dict`: the update count and each slot, keyed by
parameter name) goes into checkpoints; convert.optax_to_dense_state maps the
JAX package's optax state onto it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, List, Mapping, Optional, Tuple

import torch

from easyrec_torch.config.text_format import Message
from easyrec_torch.optim import schedules
from easyrec_torch.optim import sparse as sparse_lib


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
  """optax.clip_by_global_norm: every gradient scaled by max_norm / norm
  where the global norm reaches max_norm. No host sync."""
  g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
  keep = g_norm < max_norm
  return [torch.where(keep, g, (g / g_norm) * max_norm) for g in grads]


class DenseOptimizer:
  """An optax chain over parameters, updated in place. The update count
  lives on the parameters' device, and the learning rate is
  schedule(count) read BEFORE count is incremented, as optax's
  scale_by_schedule reads it, so a step syncs nothing.

  `params` is a mapping name -> parameter (model.named_parameters()), or a
  list where no state_dict is needed: the state is keyed by name, never by
  position. `slot_names` are the per-parameter state lists, each named as
  the optax state field it repeats."""
  slot_names: ClassVar[Tuple[str, ...]] = ()

  def __init__(self, params, schedule: Callable, clip_norm: float = 0.0):
    if isinstance(params, Mapping):
      self.names: Optional[List[str]] = list(params)
      params = params.values()
    else:
      self.names = None
    self.params = list(params)
    self.schedule = schedule
    self.clip_norm = float(clip_norm)
    dev = self.params[0].device if self.params else torch.device('cpu')
    self.count = torch.zeros((), dtype=torch.int32, device=dev)

  def _zeros(self):
    return [torch.zeros_like(p) for p in self.params]

  @torch.no_grad()
  def step(self) -> None:
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in self.params]
    if self.clip_norm > 0:
      grads = clip_by_global_norm(grads, self.clip_norm)
    self._update(grads, -self.schedule(self.count))
    self.count = self.count + 1

  def _update(self, grads, neg_lr) -> None:
    raise NotImplementedError

  def _named(self) -> List[str]:
    if self.names is None:
      raise ValueError('%s was built from a list of parameters: its state '
                       'is keyed by name, so build it from a mapping'
                       % type(self).__name__)
    return self.names

  def state_dict(self) -> Dict[str, object]:
    """{'count': int32 scalar, slot: {parameter name: tensor}} for each of
    slot_names; the tensors are the optimizer's own (not copies)."""
    names = self._named()
    out: Dict[str, object] = {'count': self.count}
    for slot in self.slot_names:
      out[slot] = dict(zip(names, getattr(self, slot)))
    return out

  @torch.no_grad()
  def load_state_dict(self, state: Mapping[str, object]) -> None:
    """Copy a state_dict in, by parameter name; KeyError names a missing
    parameter, ValueError a shape that differs."""
    names = self._named()
    self.count = torch.as_tensor(state['count']).to(
        device=self.count.device, dtype=torch.int32).clone()
    for slot in self.slot_names:
      saved = state[slot]
      for name, t in zip(names, getattr(self, slot)):
        if name not in saved:
          raise KeyError('optimizer state %s has no parameter %r'
                         % (slot, name))
        if tuple(saved[name].shape) != tuple(t.shape):
          raise ValueError('optimizer state %s[%r]: shape %s, parameter %s'
                           % (slot, name, tuple(saved[name].shape),
                              tuple(t.shape)))
        t.copy_(saved[name])


class DenseAdam(DenseOptimizer):
  """optax.adam, or optax.adamw with weight_decay. Per parameter:
  mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu; with c = count + 1,
  u = (mu / (1 - b1^c)) / (sqrt(nu / (1 - b2^c)) + eps), plus
  weight_decay * p for adamw; p += -lr * u."""
  slot_names = ('mu', 'nu')

  def __init__(self, params, schedule, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: Optional[float] = None,
               clip_norm: float = 0.0):
    super().__init__(params, schedule, clip_norm)
    self.b1, self.b2, self.eps = b1, b2, eps
    self.weight_decay = weight_decay
    self.mu, self.nu = self._zeros(), self._zeros()

  def _update(self, grads, neg_lr):
    b1, b2, eps = self.b1, self.b2, self.eps
    count_inc = (self.count + 1).to(torch.float32)
    bc1 = 1 - torch.pow(b1, count_inc)
    bc2 = 1 - torch.pow(b2, count_inc)
    for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
      mu.copy_((1 - b1) * g + b1 * mu)
      nu.copy_((1 - b2) * (g * g) + b2 * nu)
      upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
      if self.weight_decay is not None:
        upd = upd + self.weight_decay * p
      p.add_(neg_lr * upd)


class DenseAdagrad(DenseOptimizer):
  """optax.adagrad: s = g^2 + s; u = rsqrt(s + eps) g where s > 0, else 0;
  p += -lr * u."""
  slot_names = ('sum_of_squares',)

  def __init__(self, params, schedule, initial_accumulator_value=0.1,
               eps: float = 1e-7, clip_norm: float = 0.0):
    super().__init__(params, schedule, clip_norm)
    self.eps = eps
    self.sum_of_squares = [torch.full_like(p, initial_accumulator_value)
                           for p in self.params]

  def _update(self, grads, neg_lr):
    for p, g, s in zip(self.params, grads, self.sum_of_squares):
      s.copy_(g * g + s)
      inv = torch.where(s > 0, torch.rsqrt(s + self.eps), 0.0)
      p.add_(neg_lr * (inv * g))


class DenseMomentum(DenseOptimizer):
  """optax.sgd with momentum: t = g + momentum t; p += -lr * t. With
  weight_decay (momentumw) g + weight_decay * p takes g's place first."""
  slot_names = ('trace',)

  def __init__(self, params, schedule, momentum: float = 0.9,
               weight_decay: Optional[float] = None, clip_norm: float = 0.0):
    super().__init__(params, schedule, clip_norm)
    self.momentum = momentum
    self.weight_decay = weight_decay
    self.trace = self._zeros()

  def _update(self, grads, neg_lr):
    for p, g, t in zip(self.params, grads, self.trace):
      if self.weight_decay is not None:
        g = g + self.weight_decay * p
      t.copy_(g + self.momentum * t)
      p.add_(neg_lr * t)


class DenseRMSProp(DenseOptimizer):
  """optax.rmsprop(decay, eps, momentum), eps inside the root: nu =
  (1-decay) g^2 + decay nu; u = -lr * (rsqrt(nu + eps) g); t = u +
  momentum t; p += t."""
  slot_names = ('nu', 'trace')

  def __init__(self, params, schedule, decay: float = 0.9,
               eps: float = 1e-8, momentum: float = 0.0,
               clip_norm: float = 0.0):
    super().__init__(params, schedule, clip_norm)
    self.decay, self.eps, self.momentum = decay, eps, momentum
    self.nu, self.trace = self._zeros(), self._zeros()

  def _update(self, grads, neg_lr):
    for p, g, nu, t in zip(self.params, grads, self.nu, self.trace):
      nu.copy_((1 - self.decay) * (g * g) + self.decay * nu)
      u = neg_lr * (torch.rsqrt(nu + self.eps) * g)
      t.copy_(u + self.momentum * t)
      p.add_(t)


_ADAM = ('adam_optimizer', 'adam_async_optimizer', 'lazy_adam_optimizer')
_ADAMW = ('adamw_optimizer', 'adam_asyncw_optimizer')


def _dense_from_config(which: str, cfg, schedule,
                       clip_norm: float) -> Callable:
  """A factory params -> DenseOptimizer for the message kind `which`."""
  if which in _ADAM:
    return lambda ps: DenseAdam(ps, schedule, cfg.beta1, cfg.beta2,
                                clip_norm=clip_norm)
  if which in _ADAMW:
    return lambda ps: DenseAdam(ps, schedule, cfg.beta1, cfg.beta2,
                                weight_decay=cfg.weight_decay,
                                clip_norm=clip_norm)
  if which in ('adagrad_optimizer', 'ftrl_optimizer'):
    return lambda ps: DenseAdagrad(ps, schedule,
                                   cfg.initial_accumulator_value,
                                   clip_norm=clip_norm)
  if which == 'momentum_optimizer':
    return lambda ps: DenseMomentum(ps, schedule,
                                    cfg.momentum_optimizer_value,
                                    clip_norm=clip_norm)
  if which == 'momentumw_optimizer':
    return lambda ps: DenseMomentum(ps, schedule,
                                    cfg.momentum_optimizer_value,
                                    weight_decay=cfg.weight_decay,
                                    clip_norm=clip_norm)
  if which == 'rms_prop_optimizer':
    return lambda ps: DenseRMSProp(ps, schedule, cfg.decay, cfg.epsilon,
                                   cfg.momentum_optimizer_value,
                                   clip_norm=clip_norm)
  raise ValueError('unsupported optimizer %s' % which)


def _sparse_from_config(which: str, cfg) -> sparse_lib.SparseOptimizer:
  """The JAX package's choices (:60-82), odd ones included: momentumw's
  tables take plain sparse momentum, rms_prop's sparse Adagrad with its
  defaults."""
  if which in _ADAM:
    return sparse_lib.SparseAdam(b1=cfg.beta1, b2=cfg.beta2)
  if which in _ADAMW:
    return sparse_lib.SparseAdam(b1=cfg.beta1, b2=cfg.beta2,
                                 weight_decay=cfg.weight_decay)
  if which == 'adagrad_optimizer':
    return sparse_lib.SparseAdagrad(
        initial_accumulator=cfg.initial_accumulator_value)
  if which in ('momentum_optimizer', 'momentumw_optimizer'):
    return sparse_lib.SparseMomentum(momentum=cfg.momentum_optimizer_value)
  if which == 'rms_prop_optimizer':
    return sparse_lib.SparseAdagrad()
  if which == 'ftrl_optimizer':
    return sparse_lib.SparseFtrl(
        learning_rate_power=cfg.learning_rate_power,
        initial_accumulator=cfg.initial_accumulator_value,
        l1=cfg.l1_reg, l2=cfg.l2_reg, l2_shrinkage=cfg.l2_shrinkage_reg)
  raise ValueError('unsupported optimizer %s' % which)


@dataclasses.dataclass
class OptimizerPair:
  sparse: sparse_lib.SparseOptimizer
  schedule: Callable
  make_dense: Callable
  embedding_lr_multiplier: float = 1.0

  def dense(self, params) -> DenseOptimizer:
    return self.make_dense(params)


def build_optimizer(opt_config: Optional[Message],
                    clip_norm: float = 0.0) -> OptimizerPair:
  which = opt_config.WhichOneof('optimizer') if opt_config is not None \
      else None
  if which is None:
    which, cfg = 'adam_optimizer', Message('AdamOptimizer')
  else:
    cfg = getattr(opt_config, which)
  if opt_config is not None and opt_config.use_moving_average:
    raise NotImplementedError('use_moving_average is not ported')
  schedule = schedules.build_schedule(
      cfg.learning_rate if cfg.HasField('learning_rate') else None)
  mult = opt_config.embedding_learning_rate_multiplier \
      if opt_config is not None and \
      opt_config.HasField('embedding_learning_rate_multiplier') else 1.0
  return OptimizerPair(sparse=_sparse_from_config(which, cfg),
                       schedule=schedule,
                       make_dense=_dense_from_config(which, cfg, schedule,
                                                     clip_norm),
                       embedding_lr_multiplier=mult)


def build_optimizers(train_config) -> Tuple[OptimizerPair,
                                            Optional[OptimizerPair]]:
  """(primary, embedding_override), as the JAX package groups them."""
  opts = list(train_config.optimizer_config)
  clip = train_config.gradient_clipping_by_norm
  if not opts:
    return build_optimizer(None, clip), None
  if len(opts) == 1:
    return build_optimizer(opts[0], clip), None
  return build_optimizer(opts[1], clip), build_optimizer(opts[0], clip)
