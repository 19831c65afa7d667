"""Trainer: the train step, evaluation and the training loop.

Counterpart of easyrec_tpu/train/trainer.py (Trainer.__init__, init_state
:184, the step :298-401, evaluate :502, fit :640) on one device, without
checkpoints. A step:
  1. pulls the batch's rows by index_select on the tables' weight columns
     (no autograd on the tables themselves);
  2. marks the pulled rows as requiring grad and runs the forward;
  3. builds the loss: the model loss, l2 over the dense kernels, and the
     embedding regulariser over the pulled rows masked by sample_weight;
  4. runs backward();
  5. runs dense Adam at the schedule's rate for this step;
  6. runs the sparse update of each table (ops/packed_table.py): kernels
     K1 and K2, or the fused kernel K3 under EASYREC_PACKED_FUSED=1.
Everything the step needs per step (step counter, learning rates, Adam
bias corrections) stays on the device: a step syncs the host only where
the caller reads a loss.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from easyrec_torch.config import config_util, schema
from easyrec_torch.data.input_pipeline import InputPipeline
from easyrec_torch.device import resolve_device
from easyrec_torch.features import feature_spec as fs
from easyrec_torch.metrics.metrics import MetricsCollection
from easyrec_torch.models import base as model_base
from easyrec_torch.models import rank  # noqa: F401 (registers models)
from easyrec_torch.ops import embedding as emb_ops
from easyrec_torch.ops import packed_table as pt
from easyrec_torch.optim import builder as opt_builder


def l2_of_kernels(model: nn.Module) -> torch.Tensor:
  """Sum of squares of the Dense kernels, in the JAX package's leaf order
  (sorted parameter paths). BatchNorm weights — flax's `scale` — are not
  kernels and stay out, as in trainer.py:50-56."""
  total = None
  for _, m in sorted(((n, m) for n, m in model.named_modules()
                      if isinstance(m, nn.Linear)), key=lambda nm: nm[0]):
    sq = torch.sum(m.weight * m.weight)
    total = sq if total is None else total + sq
  return total


def _model_l2_reg(model_config) -> float:
  """l2_regularization of whichever model message is set, where it has one
  (trainer.py:59-67)."""
  which = model_config.WhichOneof('model')
  if which is None:
    return 0.0
  sub = getattr(model_config, which)
  if schema.has_field(sub.type_name, 'l2_regularization'):
    return float(sub.l2_regularization)
  return 0.0


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
  return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
          for k, v in batch.items()}


class Trainer:
  """Builds the whole training program from one pipeline config."""

  def __init__(self, pipeline_config, device=None):
    config_util.check_ported(pipeline_config)
    self.device = resolve_device(device)
    self.pipeline_config = pipeline_config
    self.data_config = pipeline_config.data_config
    self.train_config = pipeline_config.train_config
    self.eval_config = pipeline_config.eval_config
    self.feature_configs = config_util.get_feature_configs(pipeline_config)
    self.specs = fs.build_feature_specs(self.feature_configs)
    self.ctx = model_base.build_context(pipeline_config, self.specs)
    self.layout = self.ctx.layout
    self.metas = {key: pt.TableMeta(t.rows, t.dim)
                  for key, t in self.layout.tables.items()}
    self.seed = int(self.train_config.random_seed or 2025)

    tc = self.train_config
    self.dense_pair, embed_override = opt_builder.build_optimizers(tc)
    self.embed_pair = embed_override or self.dense_pair
    self.l2_reg = _model_l2_reg(pipeline_config.model_config)
    self.emb_reg = float(pipeline_config.model_config
                         .embedding_regularization)
    self.metrics = MetricsCollection(self.eval_config.metrics_set)
    self.model: Optional[nn.Module] = None
    self.tables: Dict[str, torch.Tensor] = {}

  # -- state ---------------------------------------------------------------

  def init_state(self) -> None:
    """Fresh model, tables and optimizer state, all on the device.

    Dense parameters are drawn on the CPU from a generator seeded with the
    config's random_seed and moved; the tables are drawn on the device
    (EmbeddingLayout.init_weights)."""
    gen = torch.Generator().manual_seed(self.seed)
    self.model = model_base.create_model(self.ctx, generator=gen) \
        .to(self.device)
    self.tables = {}
    for key, meta in self.metas.items():
      table = torch.zeros((meta.rows, meta.width), dtype=torch.float32,
                          device=self.device)
      self.tables[key] = self.layout.init_weights(key, self.seed,
                                                  self.device, table)
    self.dense_opt = self.dense_pair.dense(list(self.model.parameters()))
    self.step = torch.zeros((), dtype=torch.int32, device=self.device)

  # -- train step ----------------------------------------------------------

  def _regularised_loss(self, outputs, batch, pulled):
    total, loss_dict = self.model.build_loss(outputs, batch)
    if self.l2_reg > 0:
      total = total + self.l2_reg * l2_of_kernels(self.model)
    if self.emb_reg > 0:
      # padded tail rows (sample_weight 0) stay out of the regulariser
      valid = (batch['sample_weight'] > 0).to(torch.float32)
      reg = None
      for p in pulled.values():
        sq = torch.sum(p * p, dim=tuple(range(1, p.ndim)))
        term = torch.sum(sq * valid)
        reg = term if reg is None else reg + term
      total = total + self.emb_reg * reg
    return total, loss_dict

  def train_step(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """One step on a batch of device tensors; returns device scalars."""
    packs = emb_ops.pack_ids(self.layout, batch)
    pulled = {k: v.requires_grad_() for k, v in
              emb_ops.pull_embeddings(self.tables, packs, self.metas).items()}
    self.model.train()
    outputs = self.model(batch, pulled)
    total, loss_dict = self._regularised_loss(outputs, batch, pulled)
    for p in self.dense_opt.params:
      p.grad = None
    total.backward()
    self.dense_opt.step()
    with torch.no_grad():
      lr = self.embed_pair.schedule(self.step) * \
          self.embed_pair.embedding_lr_multiplier
      sparse = self.embed_pair.sparse
      hypers = sparse.hypers(lr, self.step)
      for key, meta in self.metas.items():
        pt.apply_packed_update(self.tables[key], packs[key],
                               pulled[key].grad, hypers, sparse, meta)
      self.step += 1
    out = {k: v.detach() for k, v in loss_dict.items()}
    out['total_loss'] = total.detach()
    return out

  # -- pipelines -----------------------------------------------------------

  def train_input(self, batch_size=None) -> InputPipeline:
    return InputPipeline(self.data_config, self.feature_configs,
                         config_util.get_train_input_path(
                             self.pipeline_config),
                         mode='train', batch_size=batch_size)

  def eval_input(self, batch_size=None) -> InputPipeline:
    return InputPipeline(self.data_config, self.feature_configs,
                         config_util.get_eval_input_path(
                             self.pipeline_config),
                         mode='eval', batch_size=batch_size)

  # -- evaluation ----------------------------------------------------------

  @torch.no_grad()
  def eval_step(self, batch: Dict[str, torch.Tensor], metric_states):
    packs = emb_ops.pack_ids(self.layout, batch)
    pulled = emb_ops.pull_embeddings(self.tables, packs, self.metas)
    self.model.eval()
    outputs = self.model(batch, pulled)
    loss, _ = self.model.build_loss(outputs, batch)
    mi = self.model.metric_inputs(outputs, batch)
    self.metrics.update_states(metric_states, mi['labels'], mi['probs'],
                               mi['weights'])
    return loss

  def evaluate(self, eval_iter: Optional[Iterable] = None,
               max_batches: Optional[int] = None) -> Dict[str, float]:
    if eval_iter is None:
      eval_iter = self.eval_input()
      if max_batches is None and self.data_config.input_type == 'DummyInput':
        max_batches = 50      # DummyInput streams forever
    if max_batches is None and int(self.eval_config.num_examples):
      bs = int(self.data_config.eval_batch_size) or \
          int(self.data_config.batch_size)
      max_batches = max(1, -(-int(self.eval_config.num_examples) // bs))
    states = self.metrics.init_states(self.device)
    losses: List[torch.Tensor] = []
    for n, batch in enumerate(eval_iter, 1):
      losses.append(self.eval_step(to_device(batch, self.device), states))
      if max_batches and n >= max_batches:
        break
    results = self.metrics.results(states)
    if losses:
      results['loss'] = float(np.mean([float(x) for x in losses]))
    return results

  # -- training loop -------------------------------------------------------

  def fit(self, num_steps: Optional[int] = None,
          log_every: Optional[int] = None,
          eval_at_end: bool = True) -> Dict:
    """Train for num_steps (default train_config.num_steps; 0 = until the
    input ends), then evaluate. Returns the step count, every step's total
    loss and the eval metrics."""
    tc = self.train_config
    num_steps = num_steps or (tc.num_steps or None)
    log_every = log_every or max(int(tc.log_step_count_steps), 1)
    self.init_state()
    step = 0
    losses: List[torch.Tensor] = []
    history = []
    t0, window = time.time(), 0
    for batch in self.train_input():
      if num_steps and step >= num_steps:
        break
      loss_dict = self.train_step(to_device(batch, self.device))
      losses.append(loss_dict['total_loss'])
      step += 1
      window += batch['sample_weight'].shape[0]
      if step % log_every == 0:
        loss_val = float(loss_dict['total_loss'])
        rate = window / max(time.time() - t0, 1e-6)
        logging.info('step %d: loss=%.5f (%.1f ex/s)', step, loss_val, rate)
        history.append({'step': step, 'loss': loss_val,
                        'examples_per_sec': rate})
        t0, window = time.time(), 0
    result = {'global_step': step, 'history': history,
              'losses': torch.stack(losses).tolist() if losses else []}
    if eval_at_end and self.pipeline_config.WhichOneof('eval_path'):
      result['eval_metrics'] = self.evaluate()
      logging.info('eval: %s', result['eval_metrics'])
    return result
