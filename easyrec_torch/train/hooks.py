"""Training hooks: early stopping, best-export tracking, deadlines.

The port's copy of easyrec_tpu/train/hooks.py, which imports nothing of
JAX: EarlyStopper (:17), BestExporter (:55), DeadlineStopper (:93) and
StopSignalFile (:106). Trainer.fit drives them (train/trainer.py).
"""

from __future__ import annotations

import datetime
import logging
import os
import shutil
from typing import Dict, Optional


class EarlyStopper:
  """Metric-based early stopping (export_config.enable_early_stop).

  export_config.early_stop_func switches to a user function loaded by
  dotted path, called as fn(eval_results, early_stop_params) -> bool
  (reference compat/early_stopping.py custom_early_stop_hook:285)."""

  def __init__(self, export_config):
    self.enabled = bool(export_config.enable_early_stop)
    self.metric = export_config.best_exporter_metric or 'auc'
    self.bigger = bool(export_config.metric_bigger)
    self.max_check_steps = int(export_config.max_check_steps) or 10000
    self.best_value: Optional[float] = None
    self.best_step: int = 0
    self.custom_fn = None
    if export_config.early_stop_func:
      from easyrec_torch.utils.registry import load_by_path
      self.custom_fn = load_by_path(export_config.early_stop_func)
      self.custom_params = export_config.early_stop_params
      self.enabled = True

  def should_stop(self, step: int, metrics: Dict[str, float]) -> bool:
    if not self.enabled:
      return False
    if self.custom_fn is not None:
      return bool(self.custom_fn(dict(metrics), self.custom_params))
    if self.metric not in metrics:
      return False
    value = metrics[self.metric]
    improved = self.best_value is None or (
        value > self.best_value if self.bigger else value < self.best_value)
    if improved:
      self.best_value = value
      self.best_step = step
      return False
    return (step - self.best_step) >= self.max_check_steps


class BestExporter:
  """Keeps the checkpoint with the best eval metric
  (reference compat/exporter.py BestExporter:88-335)."""

  def __init__(self, model_dir: str, metric: str = 'auc',
               bigger: bool = True):
    self.model_dir = model_dir
    self.metric = metric
    self.bigger = bigger
    self.best_value: Optional[float] = None
    self.best_step: Optional[int] = None

  def maybe_export(self, step: int, metrics: Dict[str, float],
                   export_fn) -> bool:
    if self.metric not in metrics:
      return False
    value = metrics[self.metric]
    improved = self.best_value is None or (
        value > self.best_value if self.bigger else value < self.best_value)
    if not improved:
      return False
    export_dir = os.path.join(self.model_dir, 'best_export')
    tmp_dir = export_dir + '.new'
    if os.path.exists(tmp_dir):
      shutil.rmtree(tmp_dir)
    # export FIRST, then swap + record: a failed export must neither
    # destroy the previous best artifact nor block a retry at the same
    # metric value
    export_fn(tmp_dir)
    if os.path.exists(export_dir):
      shutil.rmtree(export_dir)
    os.replace(tmp_dir, export_dir)
    self.best_value, self.best_step = value, step
    logging.info('best export at step %d: %s=%.6f', step, self.metric,
                 value)
    return True


class DeadlineStopper:
  """Stop after dead_line time, format '20220508 23:59:59'
  (reference compat/early_stopping.py:627-653)."""

  def __init__(self, dead_line: str):
    self.deadline = datetime.datetime.strptime(dead_line, '%Y%m%d %H:%M:%S') \
        if dead_line else None

  def should_stop(self) -> bool:
    return self.deadline is not None and \
        datetime.datetime.now() >= self.deadline


class StopSignalFile:
  """Stop when a signal file appears under model_dir (reference OSS stop
  signal, compat/early_stopping.py:565-625)."""

  SIGNAL_NAME = 'OSS_STOP_SIGNAL'

  def __init__(self, model_dir: str, enabled: bool = False):
    self.path = os.path.join(model_dir or '', self.SIGNAL_NAME)
    self.enabled = enabled and bool(model_dir)

  def should_stop(self) -> bool:
    return self.enabled and os.path.exists(self.path)
