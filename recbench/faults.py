"""Faults planted under the timed path, each of which `correct` has to
catch: the CPU tests plant them at a small size and the calibration of
the limits (calibrate.py) on the card at the cell's own. Each is a
function of the Trainer that wraps its train_step."""

from __future__ import annotations

import torch


def half_batch(trainer) -> None:
  """Half of the batch left out: the step's mean over the rest."""
  step = trainer.train_step

  def train_step(batch):
    half = batch['sample_weight'].shape[0] // 2
    return step({k: v[:half] for k, v in batch.items()})

  trainer.train_step = train_step


def state_unchanged(trainer) -> None:
  """A step that computes its loss and returns the state it was given:
  tables, parameters and optimizer state put back as they were."""
  step = trainer.train_step

  def train_step(batch):
    saved = {'tables': {k: t.clone() for k, t in trainer.tables.items()},
             'params': [p.detach().clone() for p in trainer.dense_opt.params],
             'mu': [t.clone() for t in trainer.dense_opt.mu],
             'nu': [t.clone() for t in trainer.dense_opt.nu],
             'count': trainer.dense_opt.count.clone(),
             'step': trainer.step.clone()}
    out = step(batch)
    with torch.no_grad():
      for k, t in trainer.tables.items():
        t.copy_(saved['tables'][k])
      for dst, src in zip(trainer.dense_opt.params, saved['params']):
        dst.copy_(src)
      for dst, src in zip(trainer.dense_opt.mu, saved['mu']):
        dst.copy_(src)
      for dst, src in zip(trainer.dense_opt.nu, saved['nu']):
        dst.copy_(src)
    trainer.dense_opt.count = saved['count']
    trainer.step = saved['step']
    return out

  trainer.train_step = train_step


FAULTS = {'half_batch': half_batch, 'state_unchanged': state_unchanged}
