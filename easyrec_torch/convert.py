"""Carry weights between the JAX package's state and the port's.

The JAX side is given as numpy arrays (np.asarray of its leaves), so this
module imports nothing of JAX:
  - flax `params` / `batch_stats` trees (nested dicts under the model's
    flax root: 'inner' for a rank model, none for a multi-task or a
    match model;
    BaseModel.flax_root) <-> a torch state_dict: every `kernel` becomes
    `weight` with its axes reversed (a Dense [in, out] is nn.Linear's
    [out, in], a Conv [W, Cin, Cout] nn.Conv1d's [Cout, Cin, W], a
    DenseGeneral [in, H, Dh] or [H, Dh, out] the port's DenseGeneral
    weight, an EinsumDense kernel the port's EinsumDense weight);
    BatchNorm's and LayerNorm's `scale`/`bias` become weight/bias (a
    scalar `scale`, keras Attention's, a weight of no axes), BatchNorm's
    `mean`/`var` running_mean/running_var, and the parameters flax makes
    by self.param keep their names and shapes: a `position_emb` table,
    FM's `global_bias`, the batched experts' `w_<i>` [E, D, U] and `b_<i>`
    [E, U], CrossNet's `w_<i>` [d, 1] and `b_<i>` [d], CIN's `w_<i>`,
    Bilinear's `w`, Dice's `alpha`, the numeric embeddings' `coef`,
    `linear_w`, `linear_b`, `meta_embedding`, `proj_w`, `proj_mat` and
    `emb_carry<i>`, VariationalDropout's `logit_p`, an Embed's
    `embedding`, the capsule's `bilinear` [D, high_dim], a pointwise
    two-tower model's `simi_scale` and `simi_bias` and PDN's
    `direct_sim_w` and `direct_sim_b`; a rank model's `loss_uncertainty`,
    which flax keeps at the top of the tree beside `inner`, is the
    model's parameter of that name;
  - a packed table [G*8, W] of any optimizer (easyrec_tpu/ops/
    packed_table.py layout: groups of 8 physical rows, `pack` logical rows
    per physical row, each logical row its `parts` parts of dim columns,
    cc = parts * dim: [w | s1 | s2], or compact Adam's [w | mv]) <-> the
    port's [rows, cc] table, which has the same row. The index math is a
    copy of unpack_host's (packed_table.py:227-239);
  - the optax state of the dense optimizer (easyrec_tpu/optim/builder.py
    _dense_from_config: a chain of scale_by_adam / scale_by_rss / trace /
    scale_by_rms states and scale_by_schedule's count, behind
    clip_by_global_norm's empty state where gradient_clipping_by_norm is
    set, and param_ema's ParamEmaState where use_moving_average is) -> the
    port's DenseOptimizer.state_dict;
  - a JAX export's serving state (params, batch_stats, the logical
    [rows, dim] tables and the step, as the tests read them from its orbax
    `variables/`) -> the port's export bundle (jax_export_to_bundle), which
    the port's Predictor and server load.
`flax_names` gives each state_dict key the name the JAX package's
train/restore.py _flatten gives the same variable ('inner/dnn/dense_0/
kernel'), which fine-tune restore_filters and var maps are written against.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_LEAF_TO_TORCH = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}
# parameters flax keeps at the top of a rank model's tree, beside its root
_ROOT_LEAVES = ('loss_uncertainty',)
_STAT_TO_TORCH = {'mean': 'running_mean', 'var': 'running_var'}
_STAT_TO_FLAX = {v: k for k, v in _STAT_TO_TORCH.items()}
# leaves that keep their flax name and layout (see the module docstring)
_SAME_LEAF = re.compile(r'^([wb]_\d+|w|position_emb|global_bias|alpha|coef|'
                        r'linear_[wb]|meta_embedding|proj_w|proj_mat|'
                        r'emb_carry\d+|logit_p|embedding|bilinear|'
                        r'simi_scale|simi_bias|direct_sim_[wb])$')


def _flatten(tree, prefix=()):
  for k, v in tree.items():
    if isinstance(v, dict) or hasattr(v, 'items'):
      yield from _flatten(v, prefix + (k,))
    else:
      yield prefix + (k,), v


def flax_to_state_dict(params, batch_stats=None,
                       root: str = 'inner') -> Dict[str, torch.Tensor]:
  """flax params (+ batch_stats) -> a state_dict of the port's model."""
  sd = {}
  if root:
    for name in _ROOT_LEAVES:
      if name in params:
        sd[name] = torch.from_numpy(np.array(params[name], np.float32))
  for path, leaf in _flatten(params[root] if root else params):
    arr = np.array(leaf, np.float32)
    name = path[-1] if _SAME_LEAF.match(path[-1]) else \
        _LEAF_TO_TORCH[path[-1]]
    if path[-1] == 'kernel':
      arr = arr.T
    sd['.'.join(path[:-1] + (name,))] = torch.from_numpy(
        np.ascontiguousarray(arr))
  if batch_stats:
    for path, leaf in _flatten(batch_stats[root] if root else batch_stats):
      sd['.'.join(path[:-1] + (_STAT_TO_TORCH[path[-1]],))] = \
          torch.from_numpy(np.array(leaf, np.float32))
  return sd


def flax_names(state_dict, root: str = 'inner'
               ) -> Dict[str, Tuple[str, str]]:
  """state_dict key -> (section, name): section 'params' or 'batch_stats'
  and the flax path joined by '/', as the JAX package's train/restore.py
  _flatten names it. A 'weight' of one axis or none is a scale (BatchNorm,
  LayerNorm, keras Attention); any other is a kernel. Keys with no flax
  counterpart (BatchNorm's num_batches_tracked) are left out."""
  out = {}
  for name, value in state_dict.items():
    mod, leaf = name.rsplit('.', 1) if '.' in name else ('', name)
    if not mod and leaf in _ROOT_LEAVES:
      out[name] = ('params', leaf)
      continue
    if leaf in _STAT_TO_FLAX:
      section, key = 'batch_stats', _STAT_TO_FLAX[leaf]
    elif leaf == 'weight':
      section, key = 'params', 'scale' if value.ndim <= 1 else 'kernel'
    elif leaf == 'bias' or _SAME_LEAF.match(leaf):
      section, key = 'params', leaf
    else:
      continue
    path = ([root] if root else []) + (mod.split('.') if mod else []) + [key]
    out[name] = (section, '/'.join(path))
  return out


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor],
                       root: str = 'inner') -> Tuple[dict, dict]:
  """The port's state_dict -> (flax params, batch_stats) numpy trees."""
  trees = {'params': {}, 'batch_stats': {}}
  for name, (section, path) in flax_names(state_dict, root).items():
    arr = state_dict[name].detach().cpu().numpy()
    if path.endswith('/kernel') or path == 'kernel':
      arr = arr.T
    node = trees[section]
    *parents, key = path.split('/')
    for part in parents:
      node = node.setdefault(part, {})
    node[key] = np.ascontiguousarray(arr)
  return trees['params'], trees['batch_stats']


# slot fields of optax's states, and param_ema's ParamEmaState.ema
_OPTAX_SLOTS = ('mu', 'nu', 'sum_of_squares', 'trace', 'ema')


def _optax_fields(node):
  """(field, value) of every count and slot field in an optax state: named
  tuples (optax's states), tuples and lists (chains), or dicts of the same
  (a raw restore). A slot's value (a parameter tree) is not walked."""
  if hasattr(node, '_fields'):
    items = [(f, getattr(node, f)) for f in node._fields]
  elif isinstance(node, dict):
    items = list(node.items())
  elif isinstance(node, (tuple, list)):
    items = [(None, v) for v in node]
  else:
    return
  for field, value in items:
    if field == 'count' or field in _OPTAX_SLOTS:
      yield field, value
    else:
      yield from _optax_fields(value)


def optax_to_dense_state(opt_state, slot_names, root: str = 'inner'
                         ) -> Dict[str, object]:
  """The JAX package's optax dense state, as numpy arrays -> the
  state_dict of the port's DenseOptimizer with these `slot_names` (its
  state_slots: Adam's mu/nu, Adagrad's sum_of_squares, momentum's trace,
  RMSProp's nu and trace, then param_ema's ema): 'count' from the chain's counts (scale_by_adam's and the
  schedule's, which move together), each slot's parameter tree through
  flax_to_state_dict (kernels transposed). ValueError when a slot is
  missing or the counts disagree."""
  counts, slots = set(), {}
  for field, value in _optax_fields(opt_state):
    if field == 'count':
      counts.add(int(np.asarray(value)))
    elif field in slot_names:
      if field in slots:
        raise ValueError('optax state holds two %r states' % field)
      slots[field] = value
  if len(counts) != 1:
    raise ValueError('optax state counts %s: expected one value'
                     % sorted(counts))
  missing = [s for s in slot_names if s not in slots]
  if missing:
    raise ValueError('optax state has no %s' % ', '.join(missing))
  state: Dict[str, object] = {
      'count': torch.tensor(counts.pop(), dtype=torch.int32)}
  for slot in slot_names:
    state[slot] = flax_to_state_dict(slots[slot], root=root)
  return state


def jax_packed_to_table(packed: np.ndarray, dim: int, rows: int,
                        parts: int) -> np.ndarray:
  """Packed [G*8, W] of `parts` physical parts (the JAX PackMeta's n_parts:
  2 for compact Adam) -> the port's [rows, parts*dim]."""
  cc = parts * dim
  phys_rows, width = packed.shape
  if width % cc or phys_rows % 8:
    raise ValueError('packed table %s is not a %d-part layout of dim %d'
                     % (packed.shape, parts, dim))
  pack, groups = width // cc, phys_rows // 8
  flat = np.asarray(packed).reshape(groups, 8, pack, cc).reshape(-1, cc)
  if rows > flat.shape[0]:
    raise ValueError('packed table holds %d rows, %d asked'
                     % (flat.shape[0], rows))
  return np.array(flat[:rows], np.float32)


def table_to_jax_packed(table: np.ndarray, phys_rows: int,
                        width: int) -> np.ndarray:
  """The port's [rows, cc] -> packed [phys_rows, width] of the same
  combined rows, rows past `rows` zero (pack_host's layout)."""
  rows, cc = table.shape
  pack, groups = width // cc, phys_rows // 8
  full = np.zeros((groups * 8 * pack, cc), np.float32)
  full[:rows] = table
  return np.ascontiguousarray(full.reshape(groups, 8, pack, cc)
                              .reshape(phys_rows, width))


def jax_export_to_bundle(jax_export_dir: str, out_dir: str, params,
                         batch_stats, tables, step) -> str:
  """A JAX export -> a port export bundle in out_dir; returns out_dir.

  `params`, `batch_stats`, `tables` ({key: logical [rows, dim] weights})
  and `step` are the arrays of the JAX export's orbax variables/ as numpy
  (read on the JAX side, e.g. by its load_serving_state). Its
  pipeline.config is copied as it is, its export_meta.json with
  'framework': 'easyrec_torch', and variables/variables.pt holds what the
  port's export_saved_model writes: the model's state_dict
  (flax_to_state_dict), each table cut to the rows of the port's layout
  (the JAX package pads a table's rows: to a multiple of 8 in its plain
  layout, to whole groups in its packed one) and the step."""
  import json
  import os
  import shutil
  from easyrec_torch.config import config_util
  from easyrec_torch.export import saved_model as sm
  from easyrec_torch.features import feature_spec as fs
  from easyrec_torch.models import base as model_base
  from easyrec_torch.models import (  # noqa: F401 (registers)
      backbone_model, match, match_extra, multi_task, rank, rank_extra)
  from easyrec_torch.utils.registry import MODELS
  config = config_util.get_configs_from_pipeline_file(
      os.path.join(jax_export_dir, sm.CONFIG_FILE))
  specs = fs.build_feature_specs(
      config_util.get_feature_configs(config),
      max_tag_len=config.data_config.max_tag_len or 16)
  layout = model_base.build_context(config, specs).layout
  out_tables = {}
  for key, t in layout.tables.items():
    table = np.asarray(tables[key], np.float32)
    if table.shape[0] < t.rows or table.shape[1] != t.dim:
      raise ValueError('JAX table %r is %s, the port\'s layout [%d, %d]'
                       % (key, table.shape, t.rows, t.dim))
    out_tables[key] = torch.from_numpy(np.ascontiguousarray(table[:t.rows]))
  root = MODELS.get(config.model_config.model_class).flax_root
  state = {'model': flax_to_state_dict(params, batch_stats, root=root),
           'tables': out_tables,
           'step': torch.tensor(int(np.asarray(step)), dtype=torch.int64)}
  os.makedirs(os.path.join(out_dir, sm.VARIABLES_DIR), exist_ok=True)
  shutil.copy(os.path.join(jax_export_dir, sm.CONFIG_FILE),
              os.path.join(out_dir, sm.CONFIG_FILE))
  with open(os.path.join(jax_export_dir, sm.EXPORT_META)) as f:
    meta = json.load(f)
  meta['framework'] = 'easyrec_torch'
  with open(os.path.join(out_dir, sm.EXPORT_META), 'w') as f:
    json.dump(meta, f, indent=2)
  torch.save(state, os.path.join(out_dir, sm.VARIABLES_DIR,
                                 sm.VARIABLES_FILE))
  return out_dir
