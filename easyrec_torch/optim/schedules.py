"""Learning-rate schedules as functions of a step tensor, evaluated on the
step's device in f32 (no host sync). Counterpart of
easyrec_tpu/optim/schedules.py (:17-108): constant, exponential decay
(with min_learning_rate and burn-in), cosine decay with warmup and hold,
manual steps (with an optional linear warmup to the first), polynomial
decay and the transformer's inverse-square-root schedule."""

from __future__ import annotations

import math
from typing import Callable

import torch


def build_schedule(lr_config, default_lr: float = 0.001) -> Callable:
  """LearningRate message (or None) -> fn(step tensor) -> f32 lr tensor."""
  which = lr_config.WhichOneof('learning_rate') if lr_config is not None \
      else None
  if which is None:
    return lambda step: torch.full((), default_lr, dtype=torch.float32,
                                   device=step.device)

  if which == 'constant_learning_rate':
    lr = lr_config.constant_learning_rate.learning_rate
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)

  if which == 'exponential_decay_learning_rate':
    c = lr_config.exponential_decay_learning_rate

    def fn(step):
      step = step.to(torch.float32)
      exponent = step / c.decay_steps
      if c.staircase:
        exponent = torch.floor(exponent)
      lr = c.initial_learning_rate * torch.pow(c.decay_factor, exponent)
      lr = torch.clamp(lr, min=c.min_learning_rate)
      if c.burnin_steps > 0:
        burnin = torch.full_like(lr, c.burnin_learning_rate or
                                 c.initial_learning_rate)
        lr = torch.where(step < c.burnin_steps, burnin, lr)
      return lr
    return fn

  if which == 'cosine_decay_learning_rate':
    c = lr_config.cosine_decay_learning_rate

    def fn(step):
      step = step.to(torch.float32)
      warmup = _f32(c.warmup_steps, step)
      hold = _f32(c.hold_base_rate_steps, step)
      total = _f32(max(c.total_steps, 1), step)
      slope = _f32(c.learning_rate_base - c.warmup_learning_rate, step) / \
          torch.clamp(warmup, min=1.0)
      warmup_lr = c.warmup_learning_rate + slope * step
      progress = torch.clamp((step - warmup - hold) /
                             torch.clamp(total - warmup - hold, min=1.0),
                             0.0, 1.0)
      cos_lr = 0.5 * c.learning_rate_base * (
          1 + torch.cos(_f32(math.pi, step) * progress))
      base = _f32(c.learning_rate_base, step)
      return torch.where(step < warmup, warmup_lr,
                         torch.where(step < warmup + hold, base, cos_lr))
    return fn

  if which == 'manual_step_learning_rate':
    c = lr_config.manual_step_learning_rate
    bounds = [float(s.step) for s in c.schedule]
    rates = [c.initial_learning_rate] + [s.learning_rate for s in c.schedule]

    def fn(step):
      step = step.to(torch.float32)
      boundaries = torch.tensor(bounds, dtype=torch.float32,
                                device=step.device)
      idx = torch.sum((step >= boundaries).to(torch.int64))
      lr = torch.tensor(rates, dtype=torch.float32, device=step.device)[idx]
      if c.warmup and bounds:
        first = _f32(c.schedule[0].step, step)
        frac = torch.clamp(step / torch.clamp(first, min=1.0), 0.0, 1.0)
        warm = c.initial_learning_rate + _f32(
            c.schedule[0].learning_rate - c.initial_learning_rate,
            step) * frac
        lr = torch.where(step < first, warm, lr)
      return lr
    return fn

  if which == 'poly_decay_learning_rate':
    c = lr_config.poly_decay_learning_rate

    def fn(step):
      step = step.to(torch.float32)
      frac = torch.clamp(step / _f32(max(c.total_steps, 1), step), 0.0, 1.0)
      return _f32(c.learning_rate_base - c.end_learning_rate, step) * \
          torch.pow(1 - frac, c.power) + c.end_learning_rate
    return fn

  if which == 'transformer_learning_rate':
    c = lr_config.transformer_learning_rate

    def fn(step):
      step = torch.clamp(step.to(torch.float32), min=1.0) * \
          c.step_scaling_rate
      hidden = _f32(c.hidden_size, step)
      return c.learning_rate_base * torch.pow(hidden, -0.5) * torch.minimum(
          torch.pow(step, -0.5),
          step * torch.pow(_f32(c.warmup_steps, step), -1.5))
    return fn

  raise ValueError('unsupported learning rate schedule %s' % which)


def _f32(value, like: torch.Tensor) -> torch.Tensor:
  """`value` as an f32 scalar on `like`'s device (the JAX schedules'
  jnp.float32 of a Python number)."""
  return torch.full((), value, dtype=torch.float32, device=like.device)
