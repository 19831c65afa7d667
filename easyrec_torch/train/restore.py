"""Fine-tune (warm-start) restore with var-map renames, restore filters and
shape-compatible clip/pad.

Counterpart of easyrec_tpu/train/restore.py (_parse_var_map :28, _fit_shape
:53, fine_tune_restore :95-216). Variables are matched by the names the JAX
package gives them (its _flatten, :20-25): 'inner/<module path>/kernel',
'.../bias', '.../scale' for params, '.../mean', '.../var' for batch stats,
and the table key for a table. The port's state_dict keys are translated
to those names (convert.flax_names) before any rename or filter applies, so
one config selects the same variables on both sides.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Optional

import torch

from easyrec_torch import convert
from easyrec_torch.train import checkpoints as ckpt_lib


def _parse_var_map(var_map: str) -> Dict[str, str]:
  """'ckpt_name:model_name' lines or comma-separated pairs (or a file of
  them) -> the rename map applied to checkpoint names."""
  mapping = {}
  if not var_map:
    return mapping
  if os.path.exists(var_map):
    with open(var_map) as f:
      content = f.read()
  else:
    content = var_map
  for entry in re.split(r'[,\n]', content):
    entry = entry.strip()
    if not entry:
      continue
    if ':' in entry:
      src, dst = entry.split(':', 1)
    elif '\t' in entry:
      src, dst = entry.split('\t', 1)
    else:
      continue
    mapping[src.strip()] = dst.strip()
  return mapping


def _fit_shape(value: torch.Tensor, target_shape, name: str,
               force: bool) -> Optional[torch.Tensor]:
  """`value` as it is where the shapes agree; else, with `force`, clipped
  or zero-padded along each axis (the reference's
  IncompatibleShapeRestoreHook); else None (skipped, with a warning)."""
  target_shape = tuple(target_shape)
  if tuple(value.shape) == target_shape:
    return value
  if not force:
    logging.warning('skip %s: ckpt shape %s != model shape %s '
                    '(set force_restore_shape_compatible to clip/pad)',
                    name, tuple(value.shape), target_shape)
    return None
  if value.ndim != len(target_shape):
    logging.warning('skip %s: rank mismatch %s vs %s', name,
                    tuple(value.shape), target_shape)
    return None
  out = torch.zeros(target_shape, dtype=value.dtype)
  slices = tuple(slice(0, min(a, b))
                 for a, b in zip(value.shape, target_shape))
  out[slices] = value[slices]
  logging.info('restored %s with shape adaptation %s -> %s', name,
               tuple(value.shape), target_shape)
  return out


def fine_tune_restore(trainer, ckpt_path: str, var_map: str = '',
                      restore_filters: List[str] = (),
                      force_shape_compat: bool = True) -> Dict[str, int]:
  """Warm-start `trainer`'s model and tables (after init_state) from the
  port checkpoint `ckpt_path` names (a model_dir, its checkpoints/ or a
  step directory): params, batch stats and each table's weight columns,
  matched by name after `var_map` renames the checkpoint's names, less any
  name a `restore_filters` regex matches. The tables' optimizer slots, the
  EV counters, the dense optimizer and the step stay fresh. Returns the
  number of variables restored per section."""
  saved, stamp = ckpt_lib.load(ckpt_path)
  rename = _parse_var_map(var_map)
  filters = [re.compile(p) for p in restore_filters]
  counts = {'params': 0, 'batch_stats': 0, 'tables': 0}

  def take(section, name, value, shape):
    if any(f.search(name) for f in filters):
      logging.info('restore filter excluded %s/%s', section, name)
      return None
    fitted = _fit_shape(value, shape, '%s/%s' % (section, name),
                        force_shape_compat)
    if fitted is not None:
      counts[section] += 1
    return fitted

  saved_model = saved['model']
  by_name = {}
  # in _flatten's order (sorted paths), so where the map sends two names
  # onto one the same one wins on both sides
  for key, (section, name) in sorted(
      convert.flax_names(saved_model).items(),
      key=lambda kv: (kv[1][0], kv[1][1].split('/'))):
    by_name[(section, rename.get(name, name))] = saved_model[key]
  current = trainer.model.state_dict()
  with torch.no_grad():
    for key, (section, name) in convert.flax_names(current).items():
      value = by_name.get((section, name))
      if value is None:
        continue
      fitted = take(section, name, value, current[key].shape)
      if fitted is not None:
        current[key].copy_(fitted)

    dims = {k: v['dim'] for k, v in stamp['tables'].items()}
    tables = {rename.get(k, k): (v, dims[k])
              for k, v in saved['tables'].items()}
    for key, table in trainer.tables.items():
      if key not in tables:
        continue
      value, dim = tables[key]
      cur_dim = trainer.metas[key].dim
      fitted = take('tables', key, value[:, :dim],
                    (table.shape[0], cur_dim))
      if fitted is not None:
        table[:, :cur_dim].copy_(fitted)
  logging.info('fine-tune restore from %s: %d params, %d tables, %d batch '
               'stats', ckpt_path, counts['params'], counts['tables'],
               counts['batch_stats'])
  return counts
