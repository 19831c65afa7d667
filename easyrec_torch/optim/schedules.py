"""Learning-rate schedules as functions of a step tensor, evaluated on the
step's device (no host sync). Counterpart of easyrec_tpu/optim/schedules.py
(:17) for the constant and exponential-decay (with min_learning_rate)
schedules."""

from __future__ import annotations

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

  raise NotImplementedError('learning rate schedule %s is not ported'
                            % which)
