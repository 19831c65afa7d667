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
    copy of unpack_host's (packed_table.py:227-239).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_LEAF_TO_TORCH = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}
_STAT_TO_TORCH = {'mean': 'running_mean', 'var': 'running_var'}


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


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor],
                       root: str = 'inner') -> Tuple[dict, dict]:
  """The port's state_dict -> (flax params, batch_stats) numpy trees.
  A module with running statistics is a BatchNorm; any other 'weight'
  is a Dense kernel."""
  bn = {k.rsplit('.', 1)[0] for k in state_dict
        if k.endswith('.running_mean')}
  params, stats = {}, {}
  for name, t in state_dict.items():
    mod, leaf = name.rsplit('.', 1) if '.' in name else ('', name)
    arr = t.detach().cpu().numpy()
    if leaf in ('running_mean', 'running_var'):
      tree, key = stats, 'mean' if leaf == 'running_mean' else 'var'
    elif leaf == 'weight':
      tree, key = params, 'scale' if mod in bn else 'kernel'
      if key == 'kernel':
        arr = arr.T
    elif leaf == 'bias':
      tree, key = params, 'bias'
    else:
      continue                  # e.g. BatchNorm's num_batches_tracked
    node = tree.setdefault(root, {}) if root else tree
    for part in mod.split('.') if mod else []:
      node = node.setdefault(part, {})
    node[key] = np.ascontiguousarray(arr)
  return params, stats


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
