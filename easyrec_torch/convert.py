"""Carry weights between the JAX package's state and the port's.

The JAX side is given as numpy arrays (np.asarray of its leaves), so this
module imports nothing of JAX:
  - flax `params` / `batch_stats` trees (nested dicts under the model's
    'inner' scope) <-> a torch state_dict: a Dense `kernel` [in, out]
    becomes nn.Linear.weight [out, in]; BatchNorm `scale`/`bias` become
    weight/bias and `mean`/`var` running_mean/running_var;
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
    set) -> the port's DenseOptimizer.state_dict.
`flax_names` gives each state_dict key the name the JAX package's
train/restore.py _flatten gives the same variable ('inner/dnn/dense_0/
kernel'), which fine-tune restore_filters and var maps are written against.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_LEAF_TO_TORCH = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}
_STAT_TO_TORCH = {'mean': 'running_mean', 'var': 'running_var'}
_STAT_TO_FLAX = {v: k for k, v in _STAT_TO_TORCH.items()}


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
  for path, leaf in _flatten(params[root] if root else params):
    arr = np.array(leaf, np.float32)
    name = _LEAF_TO_TORCH[path[-1]]
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
  _flatten names it. A module with running statistics is a BatchNorm
  (weight -> scale); any other 'weight' is a Dense kernel. Keys with no
  flax counterpart (BatchNorm's num_batches_tracked) are left out."""
  bn = {k.rsplit('.', 1)[0] for k in state_dict
        if k.endswith('.running_mean')}
  out = {}
  for name in state_dict:
    mod, leaf = name.rsplit('.', 1) if '.' in name else ('', name)
    if leaf in _STAT_TO_FLAX:
      section, key = 'batch_stats', _STAT_TO_FLAX[leaf]
    elif leaf == 'weight':
      section, key = 'params', 'scale' if mod in bn else 'kernel'
    elif leaf == 'bias':
      section, key = 'params', 'bias'
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


_OPTAX_SLOTS = ('mu', 'nu', 'sum_of_squares', 'trace')


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
  state_dict of the port's DenseOptimizer with these `slot_names` (Adam's
  mu/nu, Adagrad's sum_of_squares, momentum's trace, RMSProp's nu and
  trace): 'count' from the chain's counts (scale_by_adam's and the
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
