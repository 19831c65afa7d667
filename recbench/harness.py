"""One cell's port on one seed, driven as the benchmark drives it, and its
plain reference.

Session builds the cell's Trainer through the port's normal path
(Trainer(pipeline config), init_state), writes the initial weights of
recbench/weights.py into it, makes the traffic's batches on the device and
runs the first three train steps through Trainer.train_step, reading the
port as check.py says. The same Trainer then goes on to the warm-up and
the measured window (run.py). reference_readings trains the plain
reference from the same seed on the same three batches, after the port's
state is freed.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from recbench import check, traffic, weights
from recbench.cell import Cell, table_features
from recbench.reference import common

CHECK_STEPS = 3


def set_environment(cell: Cell) -> None:
  """The configuration's environment, and the kernel caches at fixed
  directories inside the checkout."""
  os.environ.update(cell.config.get('env', {}))
  build = os.path.join(cell.root, 'build')
  os.environ['TRITON_CACHE_DIR'] = os.path.join(build, 'triton')
  os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(build,
                                                    'torch_extensions')
  common.no_tf32()


def model_description(cell: Cell) -> dict:
  return dict(cell.config['model'], features=cell.features())


class Session:
  """The port of `cell` on `seed`, set up and through its first three
  steps. `compute_dtype` (the control) runs the towers in another
  precision; `fault` (tests and the calibration of the limits) breaks the
  train step underneath."""

  def __init__(self, cell: Cell, seed: int, device,
               compute_dtype: str = '', fault: Optional[Callable] = None,
               batches: int = 0):
    t = time.perf_counter()
    from easyrec_torch.train.trainer import Trainer
    self.phases = []

    def phase(name):
      nonlocal t
      if self.device.type == 'cuda':
        torch.cuda.synchronize()
      now = time.perf_counter()
      self.phases.append((name, now - t))
      t = now

    self.cell = cell
    self.seed = int(seed)
    self.device = torch.device(device)
    self.model = model_description(cell)
    self.features = self.model['features']
    self.shapes = cell.reference().param_shapes(self.model)
    cfg = cell.pipeline_config()
    if compute_dtype:
      cfg.train_config.compute_dtype = compute_dtype
    phase('port imports')
    self.trainer = Trainer(cfg, device=self.device)
    self.trainer.init_state()
    phase('Trainer')
    self.std = float(self.model['init_std'])
    self.dense0 = weights.load_into_program(self.trainer, self.features,
                                            self.shapes, self.seed, self.std)
    phase('weights')
    self.batches = traffic.make_batches(self.features, cell.traffic,
                                        self.seed, self.device, batches)
    phase('batches')
    if fault is not None:
      fault(self.trainer)
    self.readings = self._first_steps()
    phase('first steps')

  def _first_steps(self) -> dict:
    out = {'loss': []}
    for i in range(CHECK_STEPS):
      loss = self.trainer.train_step(self.batches[i])['total_loss']
      out['loss'].append(float(loss))
      if i == 0:
        out.update(check.program_gradient_norms(
            self.trainer, self.features, self.model['optimizer']))
    out['change'] = check.program_change_norms(
        self.trainer, self.features, self.dense0, self.seed, self.std)
    return out

  def step(self, i: int) -> Dict[str, torch.Tensor]:
    return self.trainer.train_step(self.batches[i % len(self.batches)])

  def close(self) -> List[dict]:
    """Free the port's state; the batches the reference needs."""
    kept = self.batches[:CHECK_STEPS]
    del self.trainer, self.batches, self.dense0
    if self.device.type == 'cuda':
      torch.cuda.synchronize()
      torch.cuda.empty_cache()
    return kept


def reference_readings(cell: Cell, seed: int, batches: List[dict],
                       device) -> dict:
  """The plain reference's readings of the first three steps, from the
  seed's initial weights: each feature's table is drawn block by block
  into the one copy the reference trains (its deep and wide columns
  apart), and drawn again for the change norms."""
  model = model_description(cell)
  ref_mod = cell.reference()
  std = float(model['init_std'])
  tables = {}
  for f in table_features(model['features']):
    parts = [(role, width, torch.empty((int(f['rows']), width),
                                       device=device))
             for role, width in common.roles(f)]
    for lo, hi, block in weights.table_chunks(seed, f, std, device):
      at = 0
      for _, width, table in parts:
        table[lo:hi] = block[:, at:at + width]
        at += width
      del block
    for role, _, table in parts:
      tables[(f['name'], role)] = table
  dense = weights.dense_weights(ref_mod.param_shapes(model), seed, device)
  ref = common.Reference(
      model, functools.partial(ref_mod.model_loss, model), tables, dense,
      lambda f: weights.table_chunks(seed, f, std, device))
  return common.readings(ref, batches, CHECK_STEPS)
