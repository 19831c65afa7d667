"""Checkpoints of the port: one file per step, keep-max, a layout stamp.

Counterpart of easyrec_tpu/train/checkpoints.py (layout_stamp :27-47,
LayoutMismatchError :50, CheckpointManager :54-140) in a format of its own,
since orbax is not on the card's machine. Under `model_dir`:

    checkpoints/<step>/state.pt     torch.save of one dict: 'step', 'model'
                                    (the model's state_dict), 'tables'
                                    ({key: [rows, width] f32 combined rows,
                                    the embedding optimizer's slots
                                    included}), 'ev' ({key: {'ev_count' |
                                    'ev_last': [rows, 1] f32}}) and
                                    'dense_opt' (the dense optimizer's
                                    state_dict)
    checkpoints/<step>/layout.json  the layout stamp the tables were written
                                    with

A step is written into a temporary directory beside the others and renamed
into place with os.replace, so a run killed while it saves never leaves a
half-written step as the latest. It is read back with
torch.load(weights_only=True). A JAX checkpoint does not load here: it is
restored on the JAX side and mapped by easyrec_torch/convert.py.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Dict, List, Optional, Tuple

import torch

# Generation of the port's on-disk table layout ([rows, n_parts * dim]
# combined rows, compact Adam as bf16 pairs). Bump on an incompatible
# change, so an old checkpoint fails with a pointed error.
PACKED_LAYOUT_VERSION = 1

_STATE = 'state.pt'
_STAMP = 'layout.json'
_TMP = '.tmp-'


def layout_stamp(metas, ev_state=None) -> dict:
  """Geometry of the tables (ops/packed_table.TableMeta by key) and of the
  EV aux tables (their names and rows by key), checked against a
  checkpoint's before it is restored."""
  return {
      'layout_version': PACKED_LAYOUT_VERSION,
      'tables': {key: {'rows': m.rows, 'dim': m.dim,
                       'n_parts': m.logical_parts, 'compact': m.compact}
                 for key, m in metas.items()},
      'ev': {key: {name: int(t.shape[0]) for name, t in sorted(aux.items())}
             for key, aux in (ev_state or {}).items()},
  }


class LayoutMismatchError(ValueError):
  pass


def _mismatch_hints(saved: dict, cur: dict) -> List[str]:
  hints = []
  if saved.get('layout_version') != cur.get('layout_version'):
    hints.append('table layout generation differs (saved v%s, this build '
                 'writes v%s)' % (saved.get('layout_version'),
                                  cur.get('layout_version')))
  s_tabs, c_tabs = saved.get('tables') or {}, cur.get('tables') or {}
  for key in sorted(set(s_tabs) | set(c_tabs)):
    old, new = s_tabs.get(key), c_tabs.get(key)
    if old == new:
      continue
    if old is None or new is None:
      hints.append('table %r is %s' % (key, 'new' if old is None
                                        else 'gone'))
      continue
    if old.get('compact') != new.get('compact'):
      hints.append('table %r: compact moment layout differs (saved %s, '
                   'current %s; EASYREC_PACKED_COMPACT toggles it)'
                   % (key, old.get('compact'), new.get('compact')))
    hints.append('table %r geometry: saved %s vs current %s'
                 % (key, old, new))
  if (saved.get('ev') or {}) != (cur.get('ev') or {}):
    hints.append('EV aux tables: saved %s vs current %s (ev_params '
                 'differ)' % (saved.get('ev'), cur.get('ev')))
  return hints


class CheckpointManager:
  """Checkpoints under `<model_dir>/checkpoints/<step>/`, at most
  `max_to_keep` of them (the oldest are deleted)."""

  def __init__(self, model_dir: str, max_to_keep: int = 10,
               layout_stamp: Optional[dict] = None):
    self.directory = os.path.join(os.path.abspath(model_dir), 'checkpoints')
    os.makedirs(self.directory, exist_ok=True)
    self.max_to_keep = int(max_to_keep)
    self._stamp = layout_stamp
    # a temporary step of a run killed while it saved
    for name in os.listdir(self.directory):
      if name.startswith(_TMP):
        shutil.rmtree(os.path.join(self.directory, name),
                      ignore_errors=True)

  def step_dir(self, step: int) -> str:
    return os.path.join(self.directory, str(int(step)))

  def all_steps(self) -> List[int]:
    return sorted(int(d) for d in os.listdir(self.directory)
                  if d.isdigit() and
                  os.path.exists(os.path.join(self.directory, d, _STATE)))

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def save(self, state: dict, step: int, force: bool = False) -> bool:
    """Write `state` as step `step`; a step already saved is left as it is
    (the forced save at the end of training may land on the last periodic
    one). `force` is the JAX signature's and changes nothing: every call
    saves. Returns whether it wrote."""
    del force
    step = int(step)
    if step in self.all_steps():
      return False
    tmp = os.path.join(self.directory, '%s%d-%d' % (_TMP, step, os.getpid()))
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, _STATE))
    with open(os.path.join(tmp, _STAMP), 'w') as f:
      json.dump(self._stamp or {}, f, indent=1, sort_keys=True)
    os.replace(tmp, self.step_dir(step))
    steps = self.all_steps()
    for old in steps[:max(0, len(steps) - max(self.max_to_keep, 1))]:
      shutil.rmtree(self.step_dir(old), ignore_errors=True)
    return True

  def check_layout(self, step: int) -> None:
    """Raise LayoutMismatchError, naming what differs, if step `step` was
    written with another table layout than this run's."""
    if self._stamp is None:
      return
    with open(os.path.join(self.step_dir(step), _STAMP)) as f:
      saved = json.load(f)
    cur = json.loads(json.dumps(self._stamp, sort_keys=True))
    if saved == cur:
      return
    raise LayoutMismatchError(
        'checkpoint %s was written with another table layout than this '
        'run uses: %s. Restore the matching layout settings, or warm-start '
        'from it with train_config.fine_tune_checkpoint, which restores '
        'the weights across layouts.'
        % (self.step_dir(step),
           '; '.join(_mismatch_hints(saved, cur)) or 'stamp mismatch'))

  def restore(self, step: int) -> dict:
    self.check_layout(step)
    return torch.load(os.path.join(self.step_dir(step), _STATE),
                      map_location='cpu', weights_only=True)

  def restore_latest(self) -> Optional[dict]:
    step = self.latest_step()
    return None if step is None else self.restore(step)


def resolve(path: str) -> str:
  """The step directory `path` names: a model_dir (its latest step), its
  checkpoints/ directory (the latest step) or a step directory, as the JAX
  package's load_raw_checkpoint accepts them."""
  path = os.path.abspath(path)
  if os.path.exists(os.path.join(path, _STATE)):
    return path
  for cdir in (os.path.join(path, 'checkpoints'), path):
    if os.path.isdir(cdir):
      steps = sorted(int(d) for d in os.listdir(cdir) if d.isdigit() and
                     os.path.exists(os.path.join(cdir, d, _STATE)))
      if steps:
        return os.path.join(cdir, str(steps[-1]))
  raise FileNotFoundError('no checkpoint under %s' % path)


def load(path: str) -> Tuple[dict, dict]:
  """(state, layout stamp) of the checkpoint `path` names (resolve), with
  no layout check: a fine-tune reads across layouts."""
  step_dir = resolve(path)
  with open(os.path.join(step_dir, _STAMP)) as f:
    stamp = json.load(f)
  state = torch.load(os.path.join(step_dir, _STATE), map_location='cpu',
                     weights_only=True)
  logging.info('loaded checkpoint %s', step_dir)
  return state, stamp
