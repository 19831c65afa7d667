"""Trainer: the train step, evaluation and the training loop.

Counterpart of easyrec_tpu/train/trainer.py (Trainer.__init__, init_state
:184, the step :298-401, eval_params :405, evaluate :502, fit :640 with its
checkpoints and hooks), on one device or in a world of processes, one a
device (parallel/mesh.py; the JAX package's mesh code, :104-213, :289-453,
:471-497, :534-635, :800-846). A step:
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
These stages are the easyrec.* spans of utils/spans.py, recorded only
while a torch profiler runs (train_config.is_profiling, fit).
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
step syncs the host in each ops/packed_table.py sort_segments (`starts[n]
= n`: once a table on one device without EV) and where the caller reads a
loss.

In a world (a Trainer made with `world`, or after mesh.join_world) every
rank reads its own shard of the input (shard_index = rank), and the step
equals the JAX step over the global batch:
  - the batch-wide reductions run global (mesh.step_scope: the losses'
    sums, BatchNorm's statistics, a match model's in-batch columns), so
    every rank holds the global loss; every gradient, dense and sparse,
    is summed over the ranks and divided by the world size (mesh.py says
    why that is the global batch's gradient);
  - row-sharded tables (train_distribute, mesh.make_rules) hold this
    rank's block of rows (mesh.RowSplit), read by ops/embedding.py
    ep_pull_sharded and updated by optim/sparse.py packed_update_sharded;
    the rows the exchange's capacity cut drops are returned as
    exchange_ep_pull_overflow and exchange_update_overflow, summed over the
    ranks; fit aborts where their rate stays above overflow_abort_rate;
  - replicated tables are whole on every rank and updated from every
    rank's ids and gradients, gathered in rank order, so they stay equal
    bit for bit;
  - eval keeps the ranks step-aligned with zero-weight filler batches,
    sums the metric states over the ranks and gathers the host buffers in
    rank order; rank 0 alone writes the checkpoint stamp and dense state,
    the eval result, the events files, the export and data_offset.json.
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
import torch.distributed as dist
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
from easyrec_torch.optim import sparse as sparse_lib
from easyrec_torch.parallel import mesh
from easyrec_torch.train import checkpoints as ckpt_lib
from easyrec_torch.train import hooks
from easyrec_torch.train.restore import fine_tune_restore
from easyrec_torch.utils.registry import INPUTS
from easyrec_torch.utils.spans import span


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

  def __init__(self, pipeline_config, device=None, check_mode: bool = False,
               world=mesh.CURRENT):
    config_util.check_ported(pipeline_config)
    # --check_mode: each raw input chunk is validated (data/check.py)
    self.check_mode = bool(check_mode)
    # the world this trainer is a rank of: the one given, by default the
    # one this process joined; None is the single-device path
    self.world = mesh.current_world() if world is mesh.CURRENT else world
    if self.world is not None:
      if device is not None and torch.device(device).type != \
          self.world.device.type:
        raise ValueError('device %s is not the world\'s device %s'
                         % (device, self.world.device))
      self.device = self.world.device
    else:
      self.device = resolve_device(device)
    self.is_chief = self.world is None or self.world.is_chief
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
    # in a world: which tables are row-sharded, and each one's owners
    self.sharding = None
    if self.world is not None:
      rules = mesh.make_rules(tc, self.world)
      splits = {key: mesh.row_split(m.rows, m.dim, m.n_parts,
                                    self.world.size)
                for key, m in self.metas.items()} \
          if rules.shard_embeddings else {}
      self.sharding = emb_ops.Sharding(self.world, splits)
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
      # a rank's block of a row-sharded table: the same draws as the
      # whole table's, cut
      self.tables[key] = self.own_rows(key, self.layout.fill_slots(
          key, table, pt.slot_fill(meta, slot_init)))
      del table
    self.dense_opt = self.dense_pair.dense(
        dict(self.model.named_parameters()))
    self.frozen = frozen_parameters(self.model,
                                    self.train_config.freeze_gradient)
    self.ev_state = ev_lib.init_ev_state(self.layout, self.ev_plan,
                                         self.device) \
        if self.ev_plan else {}
    self.ev_state = {key: {n: self.own_rows(key, t) for n, t in aux.items()}
                     for key, aux in self.ev_state.items()}
    # id slots EV has masked in this trainer's steps, and (step, rows
    # swept by table) of its sweeps; neither is checkpointed
    self.ev_masked = torch.zeros((), dtype=torch.int64, device=self.device)
    self.ev_swept = []
    self.step = torch.zeros((), dtype=torch.int32, device=self.device)

  def own_rows(self, key: str, table: torch.Tensor) -> torch.Tensor:
    """This rank's block of rows of a whole table of `key` (the table
    itself where it is not row-sharded, or is one block)."""
    split = self.sharding.splits.get(key) if self.sharding else None
    if split is None or split.count(self.world.rank) == table.shape[0]:
      return table
    lo = split.start(self.world.rank)
    return table[lo:lo + split.count(self.world.rank)].clone()

  def shard_layout(self) -> Optional[ckpt_lib.ShardLayout]:
    if self.world is None:
      return None
    return ckpt_lib.ShardLayout(self.world.rank, self.world.size,
                                self.sharding.splits)

  def checkpoint_manager(self, model_dir: str, max_to_keep: int = 10
                         ) -> ckpt_lib.CheckpointManager:
    """A manager that writes and reads this trainer's rows: in a world,
    each rank its block, the stamp and the dense state by rank 0."""
    return ckpt_lib.CheckpointManager(
        model_dir, max_to_keep=max_to_keep, layout_stamp=self.layout_stamp(),
        world=self.world, layout=self.shard_layout())

  @torch.no_grad()
  def whole_tables(self) -> Dict[str, torch.Tensor]:
    """Every table whole on every rank (a collective in a world with
    row-sharded tables; the tables themselves otherwise)."""
    if self.sharding is None or not self.sharding.splits:
      return dict(self.tables)
    return {key: (self.world.all_gather_rows(t)
                  if key in self.sharding.splits else t)
            for key, t in self.tables.items()}

  def unsharded(self):
    """A context in which this trainer holds its tables whole and runs as
    one device (an export or a predictor reads it so); every rank of a
    world enters it together."""
    import contextlib

    @contextlib.contextmanager
    def scope():
      saved = (self.tables, self.ev_state, self.sharding)
      whole = self.whole_tables()
      ev_whole = {key: {n: (self.world.all_gather_rows(t)
                            if self.sharding and key in
                            self.sharding.splits else t)
                        for n, t in aux.items()}
                  for key, aux in self.ev_state.items()}
      self.tables, self.ev_state, self.sharding = whole, ev_whole, None
      try:
        yield self
      finally:
        self.tables, self.ev_state, self.sharding = saved
    return scope()

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
    the JAX package's state) into the trainer, after init_state; a rank of
    a world takes its block of a whole table."""
    self.step = torch.as_tensor(state['step']).to(
        device=self.device, dtype=torch.int32).clone()
    self.model.load_state_dict(state['model'])
    for key, table in self.tables.items():
      table.copy_(self._mine(key, state['tables'][key], table))
    for key, aux in self.ev_state.items():
      for name, t in aux.items():
        t.copy_(self._mine(key, state['ev'][key][name], t))
    self.dense_opt.load_state_dict(state['dense_opt'])

  def _mine(self, key: str, src: torch.Tensor, dst: torch.Tensor
            ) -> torch.Tensor:
    """src, or this rank's block of it where src is the whole table."""
    if src.shape[0] != dst.shape[0] and src.shape[0] == self.metas[key].rows:
      split = self.sharding.splits[key]
      lo = split.start(self.world.rank)
      return src[lo:lo + dst.shape[0]]
    return src

  def layout_stamp(self) -> dict:
    """The tables' geometry, stored with and checked against checkpoints
    (train/checkpoints.layout_stamp); in a world, with its size and row
    split."""
    stamp = ckpt_lib.layout_stamp(self.metas)
    stamp['ev'] = {key: {n: self.metas[key].rows for n in sorted(aux)}
                   for key, aux in self.ev_state.items()}
    if self.world is not None:
      stamp['world'] = ckpt_lib.world_stamp(self.world.size,
                                            self.sharding.splits)
    return stamp

  # -- train step ----------------------------------------------------------

  def _regularised_loss(self, outputs, batch, pulled):
    with span('easyrec.loss'):
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
        # sampler's views have none and count whole, filler columns too. In
        # a world the base batch's and the 'hard_neg.' view's rows are each
        # rank's (summed over the ranks), the 'neg.' view's alike on every
        # rank
        valid = (batch['sample_weight'] > 0).to(torch.float32)
        reg = None
        for k, p in pulled.items():
          sq = torch.sum(p * p, dim=tuple(range(1, p.ndim)))
          if emb_ops.view_table(k) == k and p.shape[0] == valid.shape[0]:
            term = mesh.batch_sum(torch.sum(sq * valid))
          elif k.startswith('hard_neg.'):
            term = mesh.batch_sum(torch.sum(sq))
          else:
            term = torch.sum(sq)
          reg = term if reg is None else reg + term
        total = total + self.emb_reg * reg
      return total, loss_dict

  def pull(self, packs: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    """The rows of every pack, through the exchange where tables are
    row-sharded."""
    with span('easyrec.pull'):
      return emb_ops.pull_embeddings(self.tables, packs, self.metas,
                                     self.sharding)

  def _reduce_dense_grads(self) -> None:
    """Sum the dense gradients over the ranks in one all-reduce and divide
    by the world size (mesh.py: the global batch's gradient)."""
    params = self.dense_opt.params
    flat = torch.cat([(p.grad if p.grad is not None else
                       torch.zeros_like(p)).reshape(-1) for p in params])
    self.world.all_reduce(flat)
    if self.world.size > 1:
      flat = flat / self.world.size
    at = 0
    for p in params:
      n = p.numel()
      p.grad = flat[at:at + n].view_as(p).clone()
      at += n

  def _exchange_counts(self) -> Dict[str, torch.Tensor]:
    """This step's dropped rows, summed over the ranks (one all-reduce):
    exchange_ep_pull_overflow and exchange_update_overflow."""
    names = ('ep_pull_overflow', 'update_overflow')
    counts = torch.tensor([float(self.sharding.stats.get(n, 0))
                           for n in names], device=self.device)
    self.sharding.stats.clear()
    self.world.all_reduce(counts)
    return {'exchange_%s' % n: counts[i] for i, n in enumerate(names)}

  def train_step(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """One step on a batch of device tensors; returns device scalars."""
    with span('easyrec.step'):
      packs = emb_ops.pack_all_views(self.layout, batch)
      pulled = {k: v.requires_grad_() for k, v in self.pull(packs).items()}
      used = pulled
      if self.ev_plan:
        with span('easyrec.ev'):
          used = ev_lib.mask_pulled(pulled, packs, self.ev_state,
                                    self.ev_plan, self.step, self.ev_masked,
                                    self.sharding)
      # each pack cut once into its uses' pieces, for this step alone
      used = emb_ops.StepPulls(used, self.layout)
      self.model.train()
      with mesh.step_scope(self.world):
        with span('easyrec.forward'):
          outputs = self.model(batch, used)
        total, loss_dict = self._regularised_loss(outputs, batch, used)
      for p in self.dense_opt.params:
        p.grad = None
      with span('easyrec.backward'):
        total.backward()
      for p in self.frozen:
        p.grad = None         # a zero gradient: the optimizer still steps
      with span('easyrec.dense_opt'):
        if self.world is not None:
          self._reduce_dense_grads()
        self.dense_opt.step()
      with torch.no_grad():
        lr = self.embed_pair.schedule(self.step) * \
            self.embed_pair.embedding_lr_multiplier
        sparse = self.embed_pair.sparse
        hypers = sparse.hypers(lr, self.step)
        sh = self.sharding
        with span('easyrec.sparse_update'):
          for key, meta in self.metas.items():
            ids, grads = view_stream(packs, pulled, key)
            if sh is None:
              pt.apply_packed_update(self.tables[key], ids, grads, hypers,
                                     sparse, meta)
              continue
            if sh.world.size > 1:
              grads = grads / sh.world.size
            if key in sh.splits:
              sh.count('update_overflow', sparse_lib.packed_update_sharded(
                  sh.world, self.tables[key], ids, grads, hypers, sparse,
                  pt.TableMeta(self.tables[key].shape[0], meta.dim,
                               meta.logical_parts, meta.compact),
                  sh.splits[key]))
            else:
              sparse_lib.packed_update_replicated(
                  sh.world, self.tables[key], ids, grads, hypers, sparse,
                  meta)
        if self.ev_plan:
          with span('easyrec.ev'):
            ev_lib.update_ev_state(self.ev_state, packs, self.ev_plan,
                                   self.step, sh)
        self.step += 1
      out = {k: v.detach() for k, v in loss_dict.items()}
      out['total_loss'] = total.detach()
      if sh is not None and sh.splits:
        out.update(self._exchange_counts())
      return out

  # -- pipelines -----------------------------------------------------------

  def _shard_kw(self) -> Dict[str, int]:
    """In a world each rank reads its own shard of the input (the
    reference's worker sharding; JAX trainer.py:471-497)."""
    if self.world is None:
      return {}
    return {'shard_index': self.world.rank, 'shard_num': self.world.size}

  def train_input(self, batch_size=None, skip_rows: int = 0
                  ) -> InputPipeline:
    return InputPipeline(self.data_config, self.feature_configs,
                         config_util.get_train_input_path(
                             self.pipeline_config),
                         mode='train', batch_size=batch_size,
                         skip_rows=skip_rows,
                         extra_fields=config_util.collect_extra_fields(
                             self.pipeline_config),
                         check_mode=self.check_mode, **self._shard_kw())

  def eval_input(self, batch_size=None) -> InputPipeline:
    return InputPipeline(self.data_config, self.feature_configs,
                         config_util.get_eval_input_path(
                             self.pipeline_config),
                         mode='eval', batch_size=batch_size,
                         extra_fields=config_util.collect_extra_fields(
                             self.pipeline_config),
                         check_mode=self.check_mode, **self._shard_kw())

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
    pulled = self.pull(packs)
    with mesh.step_scope(self.world):
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
    world = self.world
    # dropped rows of the exchange and id slots, summed over the ranks
    # (JAX :628-635)
    dropped, slots = 0.0, 0
    it = iter(eval_iter)
    template, n = None, 0
    while True:
      batch = next(it, None)
      filler = batch is None
      if world is not None:
        # step-aligned: a rank whose shard ran dry feeds zero-weight
        # copies of its last batch until every rank has (JAX :562-593)
        more = torch.tensor([0.0 if filler else 1.0], device=self.device)
        if float(world.all_reduce(more)) == 0.0:
          break
        if filler:
          batch = dict(template if template is not None else
                       self._empty_eval_batch())
          batch['sample_weight'] = np.zeros_like(batch['sample_weight'])
        else:
          template = batch
      elif filler:
        break
      batch = dict(batch)
      host = {f: np.asarray(batch.pop('field.%s' % f))
              for f in self.metrics.host_fields if 'field.%s' % f in batch}
      loss, mi = self.eval_step(self.device_batch(batch), states)
      n += 1
      if not filler or world is not None:
        # in a world the loss is the global batch's, which has real rows
        # on some rank at every step the loop runs: every rank counts it
        losses.append(loss)
      if self.sharding is not None and self.sharding.splits:
        counts = torch.tensor(
            [float(sum(self.sharding.stats.values())),
             float(sum(int(np.prod(v.shape)) for k, v in batch.items()
                       if k.endswith('.ids')) if not filler else 0)],
            device=self.device)
        self.sharding.stats.clear()
        world.all_reduce(counts)
        dropped += float(counts[0])
        slots += int(counts[1])
      if buffers:
        valid = mi['weights'].cpu().numpy() > 0
        labels = mi['labels'].cpu().numpy()[valid]
        probs = mi['probs'].cpu().numpy()[valid]
        parts = [(labels, probs, {f: ids[valid] for f, ids in host.items()})]
        if world is not None:
          parts = world.gather_objects(parts[0])
        for labels, probs, ids in parts:
          for f in buffers:
            if f in ids:
              buffers[f].add(ids[f], labels, probs)
      if max_batches and n >= max_batches:
        break
    if world is not None:
      for state in states.values():
        for t in (state.values() if isinstance(state, dict) else [state]):
          world.all_reduce(t)
    results = self.metrics.results(states, buffers or None)
    for key, state in states.items():
      if key.startswith('auc_task_'):
        results['auc_%s' % key[len('auc_task_'):]] = \
            metrics_lib.auc_result(state)
    if losses:
      results['loss'] = float(np.mean([float(x) for x in losses]))
    if slots:
      results['exchange_overflow_rate'] = dropped / slots
    return results

  def _empty_eval_batch(self) -> Dict[str, np.ndarray]:
    """A batch of the eval shape for a rank whose eval shard is empty (its
    rows get weight 0), with every host-metric field."""
    from easyrec_torch.utils.synthetic import synthetic_batch
    bs = int(self.data_config.eval_batch_size) or \
        int(self.data_config.batch_size)
    batch = synthetic_batch(self.specs, list(self.ctx.label_fields), bs)
    for f in self.metrics.host_fields:
      batch['field.%s' % f] = np.zeros(bs, np.int64)
    return batch

  # -- training loop -------------------------------------------------------

  def _overflow_guard(self, loss_dict, batch, step: int, windows: int
                      ) -> int:
    """The exchange-overflow guardrail at log cadence (JAX trainer.py
    :815-846): the rows dropped in this step's exchanges over its id slots
    (every rank's); past train_config.overflow_abort_rate for
    overflow_abort_windows windows in a row, training aborts. Returns the
    windows in a row so far."""
    tc = self.train_config
    abort_rate = float(tc.overflow_abort_rate)
    if abort_rate <= 0:
      return 0
    dropped = sum(float(v) for k, v in loss_dict.items()
                  if k.startswith('exchange_') and k.endswith('overflow'))
    slots = sum(int(np.prod(v.shape)) for k, v in batch.items()
                if k.endswith('.ids'))
    slots *= self.world.size if self.world is not None else 1
    if not slots or dropped / slots <= abort_rate:
      return 0
    windows += 1
    logging.warning(
        'exchange overflow %.1f%% of %d id slots at step %d (window %d/%d '
        'before abort) — raise EASYREC_EXCHANGE_CAP_FACTOR or rebalance '
        'the table', 100.0 * dropped / slots, slots, step, windows,
        int(tc.overflow_abort_windows))
    if windows >= int(tc.overflow_abort_windows):
      raise RuntimeError(
          'exchange overflow rate %.1f%% exceeded train_config.'
          'overflow_abort_rate=%.3f for %d consecutive logging windows: the '
          'capacity-bounded owner buffers (parallel/exchange.py) are '
          'dropping ids — raise EASYREC_EXCHANGE_CAP_FACTOR, shrink the '
          'per-chip batch, or set overflow_abort_rate: 0 to accept the '
          'drops.' % (100.0 * dropped / slots, abort_rate, windows))
    return windows

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

  def device_batch(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
    """A host batch of this rank on the device. In a world of more than
    one rank a sampler's 'neg.' view is rank 0's on every rank, as the JAX
    package replicates it (parallel/mesh.py:62-73): a rank's sampler
    redraws the positives of its own rows, a NegativeSamplerV2 leaves out
    its own rows' positives, and a rank whose eval shard has run dry
    repeats its last batch."""
    if self.world is not None and self.world.size > 1:
      view = [{k: v for k, v in batch.items() if k.startswith('neg.')}]
      dist.broadcast_object_list(view, src=0, group=self.world.group)
      nbytes = sum(np.asarray(v).nbytes for v in view[0].values())
      self.world.count_traffic('broadcast_object',
                               nbytes if self.world.is_chief else 0,
                               0 if self.world.is_chief else nbytes)
      batch = {k: v for k, v in batch.items() if not k.startswith('neg.')}
      batch.update(view[0])
    return to_device(batch, self.device)

  def step_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """train_step on a host batch of this rank (device_batch)."""
    with span('easyrec.input'):
      batch = self.device_batch(batch)
    return self.train_step(batch)

  def export(self, export_fn):
    """export_fn() on rank 0, with the tables whole (every rank of a world
    calls it); its result on rank 0, None elsewhere."""
    with self.unsharded():
      out = export_fn() if self.is_chief else None
    if self.world is not None:
      self.world.barrier()
    return out

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
    seconds and once more at the end, each after the EV sweep. A streaming
    reader's offsets (JAX :665-710, :779-800) go beside each checkpoint
    into model_dir/data_offset.json, {"step": s, "offsets": {partition:
    next offset}}: those past the last batch trained, not the reader's
    read-ahead. A run restored from a checkpoint of a step above 0 with a
    streaming reader sets the train input's offset_info from that file and
    starts there; without the file it drops rows as a file input does.

    The hooks (JAX :739-760, :850-900; train/hooks.py): after each
    periodic save, where eval_config.eval_online is set, a best exporter
    exists (export_config.exporter_type 'best' or best_exporter_metric
    set) or early stop is enabled, an eval of 20 batches feeds
    online_eval_result.txt-<step>, the best export into
    model_dir/best_export and the early stopper; train_config.dead_line
    and the stop-signal file (enable_oss_stop_signal) are checked at log
    cadence. A hook that stops training stops it before the next step.
    With a model_dir, the final eval is written to eval_result.txt.

    With a model_dir, the events files of utils/summary_writer.py (JAX
    :765-769, :804-810, :849-852, :881-885, :937-945): `loss/<name>` of
    every loss every save_summary_steps steps (log_step_count_steps where
    it is unset), `global_step/examples_per_sec` at log cadence and
    `eval/<metric>` after each periodic eval, in model_dir; the final
    eval's metrics in model_dir/eval_val. With incr_save_config and a
    model_dir (JAX :726-738, :890-895, :931-932), an IncrementalPublisher
    (train/incremental.py) snapshots the state at the first step, then
    publishes every sparse_save_steps (else dense_save_steps, else
    save_checkpoints_steps) steps, or sparse_save_secs (else
    dense_save_secs) seconds, and once more at the end. With is_profiling
    and a model_dir, the first logging window runs under torch.profiler
    (the host, and the card's kernels and copies on a card); its chrome
    trace, with the easyrec.* spans of utils/spans.py, goes to
    model_dir/profile/rank<r>.pt.trace.json.

    Returns the global step, the log history, this run's total losses (one
    a step) and the eval metrics."""
    from easyrec_torch.export.saved_model import export_saved_model
    from easyrec_torch.utils.summary_writer import SummaryWriter
    tc = self.train_config
    num_steps = num_steps or (tc.num_steps or None)
    log_every = log_every or max(int(tc.log_step_count_steps), 1)
    summary_every = int(tc.save_summary_steps) \
        if tc.HasField('save_summary_steps') else log_every
    save_every = int(tc.save_checkpoints_steps) or 1000
    save_secs = int(tc.save_checkpoints_secs)
    self.init_state()
    manager = None
    resumed = False
    if checkpoint and self.model_dir:
      manager = self.checkpoint_manager(
          self.model_dir, max_to_keep=int(tc.keep_checkpoint_max) or 10)
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
          bigger=ec.metric_bigger, write=self.is_chief)
    deadline = hooks.DeadlineStopper(tc.dead_line) if tc.dead_line else None
    stop_signal = hooks.StopSignalFile(
        self.model_dir, enabled=tc.enable_oss_stop_signal) \
        if self.model_dir else None
    want_periodic_eval = has_eval and (
        self.eval_config.eval_online or best_exporter is not None or
        (stopper is not None and stopper.enabled))

    step = int(self.step)
    publisher = None
    if tc.HasField('incr_save_config') and self.model_dir:
      if self.world is not None and self.world.size > 1:
        raise NotImplementedError(
            'incr_save_config in a world of %d processes: the incremental '
            'publisher diffs whole tables on one device' % self.world.size)
      from easyrec_torch.train.incremental import IncrementalPublisher
      ic = tc.incr_save_config
      publisher = IncrementalPublisher(ic, self.model_dir)
      incr_every = int(ic.sparse_save_steps or ic.dense_save_steps or
                       save_every)
      incr_secs = int(ic.sparse_save_secs or ic.dense_save_secs or 0)
      last_incr = time.time()
      publisher.publish(self, step)       # the base snapshot
    summary = SummaryWriter(self.model_dir) \
        if self.model_dir and self.is_chief else None
    overflow_windows = 0
    losses: List[torch.Tensor] = []
    history = []
    t0, window = time.time(), 0
    last_save = time.time()
    stop_training = False
    offset_file = os.path.join(self.model_dir, 'data_offset.json') \
        if self.model_dir else None
    train_pipe = None
    if resumed and step > 0 and offset_file and \
        os.path.exists(offset_file):
      with open(offset_file) as f:
        restored_offsets = json.load(f).get('offsets')
      streaming = getattr(INPUTS.get(self.data_config.input_type),
                          'supports_offsets', False)
      if restored_offsets is not None and streaming:
        source = getattr(self.pipeline_config,
                         self.pipeline_config.WhichOneof('train_path'))
        source.offset_info = json.dumps(restored_offsets)
        train_pipe = self.train_input()
    if train_pipe is None:
      train_pipe = self.train_input(
          skip_rows=step * int(self.data_config.batch_size))
    trained_offsets = None

    def save_offsets(at_step):
      if offset_file and trained_offsets is not None and self.is_chief:
        with open(offset_file, 'w') as f:
          json.dump({'step': at_step,
                     'offsets': {str(k): int(v)
                                 for k, v in trained_offsets.items()}}, f)

    profiler = None
    if tc.is_profiling and self.model_dir:
      # the first logging window under torch.profiler (JAX :771-777,
      # :855-858, :917-920), with the easyrec.* spans of utils/spans.py
      from torch.profiler import ProfilerActivity, profile
      profiler = profile(activities=[ProfilerActivity.CPU] + (
          [ProfilerActivity.CUDA] if self.device.type == 'cuda' else []))
      profiler.start()

    def write_profile():
      """Stop the profiler and write its chrome trace into
      model_dir/profile, one file a rank."""
      nonlocal profiler
      if profiler is None:
        return
      if self.device.type == 'cuda':
        torch.cuda.synchronize()
      profiler.stop()
      path = os.path.join(self.model_dir, 'profile', 'rank%d.pt.trace.json'
                          % (self.world.rank if self.world else 0))
      os.makedirs(os.path.dirname(path), exist_ok=True)
      profiler.export_chrome_trace(path)
      logging.info('profiler trace written to %s', path)
      profiler = None

    batches = iter(train_pipe)
    while True:
      with span('easyrec.input'):
        batch = next(batches, None)
      if batch is None or stop_training or (num_steps and step >= num_steps):
        break
      # the pipeline cuts batches one at a time: its offsets are this
      # batch's
      if train_pipe.last_batch_offsets is not None:
        trained_offsets = dict(train_pipe.last_batch_offsets)
      loss_dict = self.step_batch(batch)
      losses.append(loss_dict['total_loss'])
      step += 1
      window += batch['sample_weight'].shape[0]
      if summary is not None and step % summary_every == 0:
        summary.add_scalars({'loss/%s' % k: float(v)
                             for k, v in loss_dict.items()}, step)
        summary.flush()
      if step % log_every == 0:
        loss_val = float(loss_dict['total_loss'])
        rate = window / max(time.time() - t0, 1e-6)
        logging.info('step %d: loss=%.5f (%.1f ex/s)', step, loss_val, rate)
        overflow_windows = self._overflow_guard(loss_dict, batch, step,
                                                overflow_windows)
        history.append({'step': step, 'loss': loss_val,
                        'examples_per_sec': rate})
        if summary is not None:
          summary.add_scalars({'global_step/examples_per_sec': rate}, step)
          summary.flush()
        t0, window = time.time(), 0
        write_profile()
        if deadline is not None and deadline.should_stop():
          logging.warning('dead_line reached; stopping training')
          stop_training = True
        if stop_signal is not None and stop_signal.should_stop():
          logging.warning('stop-signal file found; stopping training')
          stop_training = True
        if self.world is not None:
          # one rank's clock or file stops every rank at the same step
          flag = torch.tensor([float(stop_training)], device=self.device)
          stop_training = float(self.world.all_reduce(flag)) > 0
      if manager is not None and (
          step % save_every == 0 or
          (save_secs and time.time() - last_save >= save_secs)):
        last_save = time.time()
        self.save(manager, step)
        save_offsets(step)
        if want_periodic_eval:
          online = self.evaluate(max_batches=20)
          logging.info('online eval @%d: %s', step, online)
          if summary is not None:
            summary.add_scalars({'eval/%s' % k: float(v)
                                 for k, v in online.items()}, step)
            summary.flush()
          if self.eval_config.eval_online and self.is_chief:
            with open(os.path.join(self.model_dir,
                                   'online_eval_result.txt-%d' % step),
                      'w') as f:
              json.dump({k: float(v) for k, v in online.items()}, f)
          if best_exporter is not None:
            best_exporter.maybe_export(
                step, online, lambda d: self.export(
                    lambda: export_saved_model(self, d)))
          if stopper is not None and stopper.should_stop(step, online):
            if stopper.custom_fn is not None:
              logging.info('early stopping at step %d (early_stop_func '
                           'returned True)', step)
            else:
              logging.info('early stopping at step %d (no %s improvement '
                           'for %d steps)', step, stopper.metric,
                           stopper.max_check_steps)
            stop_training = True
      if publisher is not None and (
          step % incr_every == 0 or
          (incr_secs and time.time() - last_incr >= incr_secs)):
        last_incr = time.time()
        publisher.publish(self, step)
    write_profile()           # training ended inside the first window
    if manager is not None:
      self.save(manager, step, force=True)
      save_offsets(step)
    if publisher is not None:
      publisher.publish(self, step)
      publisher.close()
    result = {'global_step': step, 'history': history,
              'losses': torch.stack(losses).tolist() if losses else []}
    if eval_at_end and has_eval:
      result['eval_metrics'] = self.evaluate()
      logging.info('eval: %s', result['eval_metrics'])
      if self.model_dir and self.is_chief:
        os.makedirs(self.model_dir, exist_ok=True)
        with open(os.path.join(self.model_dir, 'eval_result.txt'),
                  'w') as f:
          json.dump({k: float(v) for k, v in result['eval_metrics'].items()},
                    f)
        with SummaryWriter(os.path.join(self.model_dir, 'eval_val')) as sw:
          sw.add_scalars({k: float(v) for k, v in
                          result['eval_metrics'].items()}, step)
    if summary is not None:
      summary.close()
    return result
