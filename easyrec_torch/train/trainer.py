"""Trainer: the train step, evaluation and the training loop.

Counterpart of easyrec_tpu/train/trainer.py (Trainer.__init__, init_state
:184, the step :298-401, eval_params :405, evaluate :502, fit :640 with its
checkpoints and hooks) on one device. A step:
  1. pulls the batch's rows by index_select on the tables' weight columns
     (no autograd on the tables themselves);
  2. marks the pulled rows as requiring grad, zeroes the rows of id slots
     that EV admission or TTL keeps out (features/ev.py, from the counters
     as they were before this batch) and runs the forward;
  3. builds the loss: the model loss, l2 over the dense kernels, and the
     embedding regulariser over the pulled rows, the base batch's masked
     by sample_weight and a sampler's views unmasked (JAX :336-346);
  4. runs backward() (the towers' DNNs in bf16 under compute_dtype
     bfloat16, JAX :91-98; parameters and optimizer state f32);
  5. zeroes the gradients of the parameters freeze_gradient names (JAX
     :352-362), then runs the dense optimizer at the schedule's rate for
     this step, after clip_by_global_norm where gradient_clipping_by_norm
     is set;
  6. runs the sparse update of each table (ops/packed_table.py) with the
     embedding optimizer's block math: kernels K1 and K2, or the fused
     kernel K3 under EASYREC_PACKED_FUSED=1, once over the ids and row
     gradients of the base batch and of a sampler's 'neg.' and
     'hard_neg.' views concatenated in that order (JAX optim/sparse.py
     :312-320), so a sampled item and its positive occurrences share one
     segment;
  7. with ev_params, counts the batch's ids and stamps their step into the
     EV aux tables through the same update (block maths ev_add, ev_set).
Eval reports the metrics of eval_config, gauc and session_auc grouped on
the host by the batch's field.<name> ids (JAX :527-612). Eval and export
run the model in eval mode on eval_params(): the dense
optimizer's EMA of the parameters under use_moving_average, through
torch.func.functional_call, so neither the live parameters nor BatchNorm's
buffers change.
The tables hold the embedding optimizer's slots beside the weights
(packed_table.table_meta: one part per slot, Adam's moments as bf16 pairs
unless EASYREC_PACKED_COMPACT=0). Everything the step needs per step (step
counter, learning rates, Adam bias corrections) stays on the device: a
step syncs the host only where the caller reads a loss.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from easyrec_torch import convert
from easyrec_torch.config import config_util, schema
from easyrec_torch.data.input_pipeline import InputPipeline
from easyrec_torch.device import resolve_device
from easyrec_torch.features import ev as ev_lib
from easyrec_torch.features import feature_spec as fs
from easyrec_torch.layers import dnn
from easyrec_torch.metrics import metrics as metrics_lib
from easyrec_torch.models import base as model_base
from easyrec_torch.models import (  # noqa: F401 (registers)
    backbone_model, match, match_extra, multi_task, rank, rank_extra)
from easyrec_torch.ops import embedding as emb_ops
from easyrec_torch.ops import packed_table as pt
from easyrec_torch.optim import builder as opt_builder
from easyrec_torch.train import checkpoints as ckpt_lib
from easyrec_torch.train import hooks
from easyrec_torch.train.restore import fine_tune_restore


def l2_of_kernels(model: nn.Module) -> torch.Tensor:
  """Sum of squares of the kernels, the leaves the JAX package counts
  (trainer.py:50-56: a flax name `kernel` or one starting with `w`): every
  `weight` of two or more axes (Dense, DenseGeneral, Conv, EinsumDense),
  the batched experts' and CIN's `w_<i>` and Bilinear's `w`, in the JAX
  package's leaf order (sorted parameter paths). Norm weights — flax's
  `scale` — biases, position tables and the other named parameters are
  not kernels and stay out. None for a model without kernels (FM)."""
  total = None
  for name, p in sorted(model.named_parameters()):
    leaf = name.rsplit('.', 1)[-1]
    if not (leaf == 'weight' and p.ndim >= 2 or leaf.startswith('w_') or
            leaf == 'w'):
      continue
    sq = torch.sum(p * p)
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


def frozen_parameters(model: nn.Module, patterns) -> List[nn.Parameter]:
  """The parameters whose flax path (convert.flax_names: 'inner/dnn/
  dense_0/kernel') one of the train_config.freeze_gradient regexes
  searches into (JAX trainer.py:294, :352-362). Their gradient is zeroed,
  not skipped: an optimizer's moments go on decaying as the JAX side's
  do."""
  regexes = [re.compile(p) for p in patterns]
  if not regexes:
    return []
  params = dict(model.named_parameters())
  names = convert.flax_names(params, root=model.flax_root)
  return [params[n] for n, (section, path) in names.items()
          if section == 'params' and any(r.search(path) for r in regexes)]


def view_stream(packs: Dict[str, torch.Tensor],
                pulled: Dict[str, torch.Tensor], key: str):
  """(ids [N], row gradients [N, dim]) of table `key`: its base pack's,
  then its 'neg.' and 'hard_neg.' views', concatenated (a view the model
  did not read has zero gradients, as in the JAX package's step)."""
  ids, grads = [], []
  for view in (key,) + tuple(v + key for v in emb_ops.VIEWS):
    if view in packs:
      p = pulled[view]
      ids.append(packs[view].reshape(-1))
      g = p.grad if p.grad is not None else torch.zeros_like(p)
      grads.append(g.reshape(-1, p.shape[-1]))
  if len(ids) == 1:
    return ids[0], grads[0]
  return torch.cat(ids), torch.cat(grads)


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
    self.specs = fs.build_feature_specs(
        self.feature_configs,
        max_tag_len=self.data_config.max_tag_len or 16)
    # train_config.compute_dtype: the towers' DNNs in bf16, parameters
    # and optimizer state in f32 (JAX :91-98)
    self.ctx = model_base.build_context(
        pipeline_config, self.specs,
        model_base.compute_dtype(self.train_config))
    self.layout = self.ctx.layout
    self.seed = int(self.train_config.random_seed or 2025)
    self.model_dir = pipeline_config.model_dir

    tc = self.train_config
    self.dense_pair, embed_override = opt_builder.build_optimizers(tc)
    self.embed_pair = embed_override or self.dense_pair
    self.metas = {key: pt.table_meta(t.rows, t.dim, self.embed_pair.sparse)
                  for key, t in self.layout.tables.items()}
    self.l2_reg = _model_l2_reg(pipeline_config.model_config)
    self.emb_reg = float(pipeline_config.model_config
                         .embedding_regularization)
    self.metrics = metrics_lib.MetricsCollection(self.eval_config.metrics_set)
    # EVParams admission / TTL (features/ev.py); None without ev_params
    self.ev_plan = ev_lib.build_ev_plan(self.layout, self.specs)
    self.model: Optional[nn.Module] = None
    self.tables: Dict[str, torch.Tensor] = {}
    self.ev_state: Dict[str, Dict[str, torch.Tensor]] = {}

  # -- state ---------------------------------------------------------------

  def init_state(self) -> None:
    """Fresh model, tables and optimizer state, all on the device.

    Dense parameters are drawn on the CPU from a generator seeded with the
    config's random_seed and moved; the tables' weights are drawn on the
    device (EmbeddingLayout.init_weights) and their slot parts filled with
    the embedding optimizer's slot_init."""
    gen = torch.Generator().manual_seed(self.seed)
    self.model = model_base.create_model(self.ctx, generator=gen) \
        .to(self.device)
    # dropout and the other random layers draw on the device, from a
    # generator of their own
    dnn.set_generator(self.model, torch.Generator(device=self.device)
                      .manual_seed(self.seed))
    self.tables = {}
    slot_init = self.embed_pair.sparse.slot_init
    for key, meta in self.metas.items():
      table = torch.zeros((meta.rows, meta.width), dtype=torch.float32,
                          device=self.device)
      self.layout.init_weights(key, self.seed, self.device, table)
      self.tables[key] = self.layout.fill_slots(
          key, table, pt.slot_fill(meta, slot_init))
    self.dense_opt = self.dense_pair.dense(
        dict(self.model.named_parameters()))
    self.frozen = frozen_parameters(self.model,
                                    self.train_config.freeze_gradient)
    self.ev_state = ev_lib.init_ev_state(self.layout, self.ev_plan,
                                         self.device) \
        if self.ev_plan else {}
    # id slots EV has masked in this trainer's steps, and (step, rows
    # swept by table) of its sweeps; neither is checkpointed
    self.ev_masked = torch.zeros((), dtype=torch.int64, device=self.device)
    self.ev_swept = []
    self.step = torch.zeros((), dtype=torch.int32, device=self.device)

  def state_dict(self) -> Dict[str, Any]:
    """Everything a checkpoint holds (train/checkpoints.py): the step, the
    model's state_dict, the tables, the EV aux tables and the dense
    optimizer's state; the trainer's own tensors, not copies."""
    return {'step': self.step, 'model': self.model.state_dict(),
            'tables': dict(self.tables),
            'ev': {k: dict(v) for k, v in self.ev_state.items()},
            'dense_opt': self.dense_opt.state_dict()}

  @torch.no_grad()
  def load_state_dict(self, state: Dict[str, Any]) -> None:
    """Copy a state_dict (a checkpoint's, or one built by convert.py from
    the JAX package's state) into the trainer, after init_state."""
    self.step = torch.as_tensor(state['step']).to(
        device=self.device, dtype=torch.int32).clone()
    self.model.load_state_dict(state['model'])
    for key, table in self.tables.items():
      table.copy_(state['tables'][key])
    for key, aux in self.ev_state.items():
      for name, t in aux.items():
        t.copy_(state['ev'][key][name])
    self.dense_opt.load_state_dict(state['dense_opt'])

  def layout_stamp(self) -> dict:
    """The tables' geometry, stored with and checked against checkpoints
    (train/checkpoints.layout_stamp)."""
    return ckpt_lib.layout_stamp(self.metas, self.ev_state)

  # -- train step ----------------------------------------------------------

  def _regularised_loss(self, outputs, batch, pulled):
    total, loss_dict = self.model.build_loss(outputs, batch)
    # the losses backbone layers record (AuxiliaryLoss, VariationalDropout;
    # JAX trainer.py:319-327), in training only
    for aux in outputs.get('aux_losses', ()):
      total = total + aux
      loss_dict['aux_loss'] = loss_dict.get('aux_loss', 0.0) + aux
    l2 = l2_of_kernels(self.model) if self.l2_reg > 0 else None
    if l2 is not None:
      total = total + self.l2_reg * l2
    if self.emb_reg > 0:
      # padded tail rows (sample_weight 0) stay out of the regulariser; a
      # sampler's views have none and count whole, filler columns too
      valid = (batch['sample_weight'] > 0).to(torch.float32)
      reg = None
      for k, p in pulled.items():
        sq = torch.sum(p * p, dim=tuple(range(1, p.ndim)))
        if emb_ops.view_table(k) == k and p.shape[0] == valid.shape[0]:
          term = torch.sum(sq * valid)
        else:
          term = torch.sum(sq)
        reg = term if reg is None else reg + term
      total = total + self.emb_reg * reg
    return total, loss_dict

  def train_step(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """One step on a batch of device tensors; returns device scalars."""
    packs = emb_ops.pack_all_views(self.layout, batch)
    pulled = {k: v.requires_grad_() for k, v in
              emb_ops.pull_embeddings(self.tables, packs, self.metas).items()}
    used = ev_lib.mask_pulled(pulled, packs, self.ev_state, self.ev_plan,
                              self.step, self.ev_masked) \
        if self.ev_plan else pulled
    self.model.train()
    outputs = self.model(batch, used)
    total, loss_dict = self._regularised_loss(outputs, batch, used)
    for p in self.dense_opt.params:
      p.grad = None
    total.backward()
    for p in self.frozen:
      p.grad = None           # a zero gradient: the optimizer still steps
    self.dense_opt.step()
    with torch.no_grad():
      lr = self.embed_pair.schedule(self.step) * \
          self.embed_pair.embedding_lr_multiplier
      sparse = self.embed_pair.sparse
      hypers = sparse.hypers(lr, self.step)
      for key, meta in self.metas.items():
        ids, grads = view_stream(packs, pulled, key)
        pt.apply_packed_update(self.tables[key], ids, grads, hypers,
                               sparse, meta)
      if self.ev_plan:
        ev_lib.update_ev_state(self.ev_state, packs, self.ev_plan,
                               self.step)
      self.step += 1
    out = {k: v.detach() for k, v in loss_dict.items()}
    out['total_loss'] = total.detach()
    return out

  # -- pipelines -----------------------------------------------------------

  def train_input(self, batch_size=None, skip_rows: int = 0
                  ) -> InputPipeline:
    return InputPipeline(self.data_config, self.feature_configs,
                         config_util.get_train_input_path(
                             self.pipeline_config),
                         mode='train', batch_size=batch_size,
                         skip_rows=skip_rows,
                         extra_fields=config_util.collect_extra_fields(
                             self.pipeline_config))

  def eval_input(self, batch_size=None) -> InputPipeline:
    return InputPipeline(self.data_config, self.feature_configs,
                         config_util.get_eval_input_path(
                             self.pipeline_config),
                         mode='eval', batch_size=batch_size,
                         extra_fields=config_util.collect_extra_fields(
                             self.pipeline_config))

  # -- evaluation ----------------------------------------------------------

  def eval_params(self) -> Dict[str, torch.Tensor]:
    """The parameters eval and export read (JAX trainer.py:405-410): the
    EMA weights where the dense optimizer keeps them (use_moving_average),
    else the live parameters; by parameter name."""
    ema = self.dense_opt.named_ema()
    return ema if ema is not None else dict(self.model.named_parameters())

  def eval_forward(self, batch: Dict[str, torch.Tensor],
                   pulled: Dict[str, torch.Tensor]):
    """The model's outputs in eval mode on eval_params(). BatchNorm reads
    its running statistics and updates nothing; the next train_step puts
    the model back in train mode."""
    self.model.eval()
    ema = self.dense_opt.named_ema()
    if ema is None:
      return self.model(batch, pulled)
    return torch.func.functional_call(self.model, ema, (batch, pulled))

  @torch.no_grad()
  def eval_step(self, batch: Dict[str, torch.Tensor], metric_states):
    """One eval batch: the headline metrics' states, and each task's AUC
    state `auc_task_<name>` where the task's probs are one per row (JAX
    trainer.py:439-450); returns the loss and the metric inputs."""
    packs = emb_ops.pack_all_views(self.layout, batch)
    pulled = emb_ops.pull_embeddings(self.tables, packs, self.metas)
    outputs = self.eval_forward(batch, pulled)
    loss, _ = self.model.build_loss(outputs, batch)
    mi = self.model.metric_inputs(outputs, batch)
    self.metrics.update_states(metric_states, mi['labels'], mi['probs'],
                               mi['weights'], preds=mi.get('preds',
                                                           mi['probs']),
                               extra=mi)
    for name, tmi in self.model.metric_inputs_per_task(outputs,
                                                       batch).items():
      key = 'auc_task_%s' % name
      if key in metric_states and tmi['probs'].ndim == 1:
        metrics_lib.update_auc(metric_states[key], tmi['labels'],
                               tmi['probs'], tmi['weights'])
    return loss, mi

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
    # per-task AUC beside the first task's `auc` (JAX trainer.py:520-527,
    # :618-622)
    for name in self.model.metric_task_names():
      states['auc_task_%s' % name] = metrics_lib.init_auc_state(self.device)
    # gauc and session_auc group the valid rows on the host by the batch's
    # field.<name> ids, which the eval step does not see (JAX :527-612)
    buffers = self.metrics.init_host_buffers()
    losses: List[torch.Tensor] = []
    for n, batch in enumerate(eval_iter, 1):
      batch = dict(batch)
      host = {f: np.asarray(batch.pop('field.%s' % f))
              for f in self.metrics.host_fields if 'field.%s' % f in batch}
      loss, mi = self.eval_step(to_device(batch, self.device), states)
      losses.append(loss)
      if buffers:
        valid = mi['weights'].cpu().numpy() > 0
        labels = mi['labels'].cpu().numpy()[valid]
        probs = mi['probs'].cpu().numpy()[valid]
        for f, ids in host.items():
          buffers[f].add(ids[valid], labels, probs)
      if max_batches and n >= max_batches:
        break
    results = self.metrics.results(states, buffers or None)
    for key, state in states.items():
      if key.startswith('auc_task_'):
        results['auc_%s' % key[len('auc_task_'):]] = \
            metrics_lib.auc_result(state)
    if losses:
      results['loss'] = float(np.mean([float(x) for x in losses]))
    return results

  # -- training loop -------------------------------------------------------

  def save(self, manager: ckpt_lib.CheckpointManager, step: int,
           force: bool = False) -> bool:
    """The EV TTL sweep (features/ev.evict_stale), then a checkpoint of
    step `step`; returns whether one was written."""
    if self.ev_plan:
      swept = ev_lib.evict_stale(self.tables, self.ev_state, self.ev_plan,
                                 self.step)
      self.ev_swept.append((step, swept))
      logging.info('EV sweep at step %d: rows evicted %s', step, swept)
    return manager.save(self.state_dict(), step, force=force)

  def fit(self, num_steps: Optional[int] = None,
          log_every: Optional[int] = None,
          eval_at_end: bool = True, checkpoint: bool = True) -> Dict:
    """Train up to num_steps (default train_config.num_steps; 0 = until the
    input ends), counting from the restored step, then evaluate.

    With `checkpoint` and a model_dir (JAX trainer.py:640-724, :865-876,
    :920-928): the latest checkpoint under model_dir/checkpoints is
    restored, and the input resumes by dropping restored_step * batch_size
    raw rows (the pipeline is built after the restore, so no batch of the
    un-resumed stream is read); with none there, fine_tune_checkpoint, if
    set, warm-starts the model and tables (train/restore.py). A checkpoint
    is saved every save_checkpoints_steps steps or save_checkpoints_secs
    seconds and once more at the end, each after the EV sweep. The JAX
    package also writes data_offset.json, for streaming readers only; none
    is ported, so the port writes none.

    The hooks (JAX :739-760, :850-900; train/hooks.py): after each
    periodic save, where eval_config.eval_online is set, a best exporter
    exists (export_config.exporter_type 'best' or best_exporter_metric
    set) or early stop is enabled, an eval of 20 batches feeds
    online_eval_result.txt-<step>, the best export into
    model_dir/best_export and the early stopper; train_config.dead_line
    and the stop-signal file (enable_oss_stop_signal) are checked at log
    cadence. A hook that stops training stops it before the next step.
    With a model_dir, the final eval is written to eval_result.txt.

    Returns the global step, the log history, this run's total losses (one
    a step) and the eval metrics."""
    from easyrec_torch.export.saved_model import export_saved_model
    tc = self.train_config
    num_steps = num_steps or (tc.num_steps or None)
    log_every = log_every or max(int(tc.log_step_count_steps), 1)
    save_every = int(tc.save_checkpoints_steps) or 1000
    save_secs = int(tc.save_checkpoints_secs)
    self.init_state()
    manager = None
    resumed = False
    if checkpoint and self.model_dir:
      manager = ckpt_lib.CheckpointManager(
          self.model_dir, max_to_keep=int(tc.keep_checkpoint_max) or 10,
          layout_stamp=self.layout_stamp())
      restored = manager.restore_latest()
      if restored is not None:
        self.load_state_dict(restored)
        resumed = True
        logging.info('restored checkpoint at step %d', int(self.step))
      del restored            # a host copy of every table
    if not resumed and tc.fine_tune_checkpoint:
      fine_tune_restore(
          self, tc.fine_tune_checkpoint, var_map=tc.fine_tune_ckpt_var_map,
          restore_filters=list(
              self.pipeline_config.model_config.restore_filters),
          force_shape_compat=tc.force_restore_shape_compatible)

    ec = self.pipeline_config.export_config
    has_eval = bool(self.pipeline_config.WhichOneof('eval_path'))
    stopper = hooks.EarlyStopper(ec) \
        if self.pipeline_config.HasField('export_config') else None
    best_exporter = None
    if has_eval and self.model_dir and (
        ec.exporter_type == 'best' or ec.HasField('best_exporter_metric')):
      best_exporter = hooks.BestExporter(
          self.model_dir, metric=ec.best_exporter_metric or 'auc',
          bigger=ec.metric_bigger)
    deadline = hooks.DeadlineStopper(tc.dead_line) if tc.dead_line else None
    stop_signal = hooks.StopSignalFile(
        self.model_dir, enabled=tc.enable_oss_stop_signal) \
        if self.model_dir else None
    want_periodic_eval = has_eval and (
        self.eval_config.eval_online or best_exporter is not None or
        (stopper is not None and stopper.enabled))

    step = int(self.step)
    losses: List[torch.Tensor] = []
    history = []
    t0, window = time.time(), 0
    last_save = time.time()
    stop_training = False
    skip_rows = step * int(self.data_config.batch_size)
    for batch in self.train_input(skip_rows=skip_rows):
      if stop_training or (num_steps and step >= num_steps):
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
        if deadline is not None and deadline.should_stop():
          logging.warning('dead_line reached; stopping training')
          stop_training = True
        if stop_signal is not None and stop_signal.should_stop():
          logging.warning('stop-signal file found; stopping training')
          stop_training = True
      if manager is not None and (
          step % save_every == 0 or
          (save_secs and time.time() - last_save >= save_secs)):
        last_save = time.time()
        self.save(manager, step)
        if want_periodic_eval:
          online = self.evaluate(max_batches=20)
          logging.info('online eval @%d: %s', step, online)
          if self.eval_config.eval_online:
            with open(os.path.join(self.model_dir,
                                   'online_eval_result.txt-%d' % step),
                      'w') as f:
              json.dump({k: float(v) for k, v in online.items()}, f)
          if best_exporter is not None:
            best_exporter.maybe_export(
                step, online, lambda d: export_saved_model(self, d))
          if stopper is not None and stopper.should_stop(step, online):
            if stopper.custom_fn is not None:
              logging.info('early stopping at step %d (early_stop_func '
                           'returned True)', step)
            else:
              logging.info('early stopping at step %d (no %s improvement '
                           'for %d steps)', step, stopper.metric,
                           stopper.max_check_steps)
            stop_training = True
    if manager is not None:
      self.save(manager, step, force=True)
    result = {'global_step': step, 'history': history,
              'losses': torch.stack(losses).tolist() if losses else []}
    if eval_at_end and has_eval:
      result['eval_metrics'] = self.evaluate()
      logging.info('eval: %s', result['eval_metrics'])
      if self.model_dir:
        os.makedirs(self.model_dir, exist_ok=True)
        with open(os.path.join(self.model_dir, 'eval_result.txt'),
                  'w') as f:
          json.dump({k: float(v) for k, v in result['eval_metrics'].items()},
                    f)
    return result
