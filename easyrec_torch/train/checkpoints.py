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
    checkpoints/<step>/shard-<r>.pt in a world of W processes with
                                    row-sharded tables, rank r's blocks of
                                    them, 'tables' and 'ev' (r >= 1; rank 0's
                                    are in state.pt)

In a world (parallel/mesh.py) each rank writes the rows it owns, and the
stamp's 'world' records the world size and the first row of every rank's
block of each row-sharded table (the counterpart of the JAX package's
packed_layout.json and tools/splice_packed_ckpt.py, :1-27). A restore at
another world size, or on one device, re-splits the rows: weights,
optimizer slots and EV counters. The stamp's table geometry must match,
whatever the world; 'world' is not part of that check.
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
_SHARD = 'shard-%d.pt'
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


def world_stamp(world_size: int, splits) -> dict:
  """The stamp's 'world': its size and, by row-sharded table, the first row
  of every rank's block and the end (splits: {key: mesh.RowSplit})."""
  return {'size': int(world_size),
          'rows': {key: [sp.start(r) for r in range(world_size + 1)]
                   for key, sp in sorted(splits.items())}}


class LayoutMismatchError(ValueError):
  pass


class ShardLayout:
  """Where this process's rows of each table go: `rank` of a world of
  `size`, `splits` the row-sharded tables' RowSplits (a table not in it is
  held whole)."""

  def __init__(self, rank: int, size: int, splits=None):
    self.rank, self.size = int(rank), int(size)
    self.splits = dict(splits or {})

  def block(self, key: str, rows: int) -> Tuple[int, int]:
    sp = self.splits.get(key)
    if sp is None:
      return 0, rows
    return sp.start(self.rank), sp.start(self.rank + 1)


def _saved_blocks(stamp: dict, step_dir: str) -> Dict[str, List[tuple]]:
  """By row-sharded table of a saved step: (first row, end, file) of each
  rank's block, checked against the files present."""
  world = stamp.get('world') or {}
  size = int(world.get('size', 1))
  out = {}
  for key, starts in (world.get('rows') or {}).items():
    blocks = []
    for r in range(size):
      path = os.path.join(step_dir, _STATE if r == 0 else _SHARD % r)
      if not os.path.exists(path):
        raise LayoutMismatchError(
            'checkpoint %s was written by a world of %d processes, but '
            '%s (rank %d\'s rows %d-%d of table %r) is missing'
            % (step_dir, size, os.path.basename(path), r, starts[r],
               starts[r + 1], key))
      blocks.append((starts[r], starts[r + 1], path))
    out[key] = blocks
  return out


def load_rows(state: dict, stamp: dict, step_dir: str,
              layout: Optional[ShardLayout]) -> dict:
  """`state` (rank 0's state.pt) with its 'tables' and 'ev' re-split to
  `layout`'s block of each table (None: whole tables), from the blocks
  every saved rank wrote."""
  if 'tables' not in state:
    return state
  blocks = _saved_blocks(stamp, step_dir)
  files = {}

  def rows_of(part, key, name, lo, hi):
    pieces = []
    for b_lo, b_hi, path in blocks[key]:
      if b_hi <= lo or b_lo >= hi or b_lo == b_hi:
        continue
      if path not in files:
        files[path] = state if path.endswith(_STATE) else torch.load(
            path, map_location='cpu', weights_only=True, mmap=True)
      src = files[path][part][key]
      src = src if name is None else src[name]
      pieces.append(src[max(lo, b_lo) - b_lo:min(hi, b_hi) - b_lo])
    if not pieces:
      # an empty block: rank 0's file holds the table's trailing shape
      src = state[part][key]
      return (src if name is None else src[name])[:0].clone()
    return torch.cat(pieces) if len(pieces) != 1 else pieces[0].clone()

  out = dict(state)
  tables, ev = {}, {}
  for key, t in state['tables'].items():
    rows = blocks[key][-1][1] if key in blocks else t.shape[0]
    lo, hi = layout.block(key, rows) if layout is not None else (0, rows)
    if key not in blocks:
      tables[key] = t[lo:hi]
      ev[key] = {n: a[lo:hi] for n, a in state.get('ev', {}).get(
          key, {}).items()}
      continue
    tables[key] = rows_of('tables', key, None, lo, hi)
    ev[key] = {n: rows_of('ev', key, n, lo, hi)
               for n in state.get('ev', {}).get(key, {})}
  out['tables'] = tables
  if 'ev' in state:
    out['ev'] = {k: v for k, v in ev.items() if v}
  return out


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


def write_split(step_dir: str, state: dict, stamp: dict, layout: ShardLayout
                ) -> None:
  """Write a checkpoint step as a world of layout.size processes would:
  `state` with whole tables, each rank's block of the row-sharded ones
  into its file, and `stamp` with that world's 'world' (every rank from one
  process: tools/splice_packed_ckpt.py). The directory is filled in a
  temporary sibling and renamed into place."""
  tmp = step_dir.rstrip('/') + '.tmp-%d' % os.getpid()
  shutil.rmtree(tmp, ignore_errors=True)
  os.makedirs(tmp)
  rows = {k: t.shape[0] for k, t in state['tables'].items()}
  for rank in range(layout.size):
    mine = ShardLayout(rank, layout.size, layout.splits)
    blocks = {k: mine.block(k, n) for k, n in rows.items()}
    tables = {k: state['tables'][k][lo:hi].clone()
              for k, (lo, hi) in blocks.items()}
    ev = {k: {n: a[blocks[k][0]:blocks[k][1]].clone()
              for n, a in aux.items()}
          for k, aux in state.get('ev', {}).items()}
    if rank == 0:
      torch.save(dict(state, tables=tables, ev=ev),
                 os.path.join(tmp, _STATE))
    elif layout.splits:
      keys = sorted(layout.splits)
      torch.save({'tables': {k: tables[k] for k in keys},
                  'ev': {k: ev.get(k, {}) for k in keys}},
                 os.path.join(tmp, _SHARD % rank))
  stamp = dict(stamp, world=world_stamp(layout.size, layout.splits))
  with open(os.path.join(tmp, _STAMP), 'w') as f:
    json.dump(stamp, f, indent=1, sort_keys=True)
  if os.path.exists(step_dir):
    shutil.rmtree(step_dir)
  os.makedirs(os.path.dirname(step_dir), exist_ok=True)
  os.replace(tmp, step_dir)


def check_stamp(saved: dict, cur: dict, where: str) -> None:
  """Raise LayoutMismatchError, naming what differs, where the checkpoint
  `where` was written with another table layout than `cur`; the world it
  was written by ('world') may differ."""
  saved = {k: v for k, v in saved.items() if k != 'world'}
  cur = {k: v for k, v in json.loads(json.dumps(cur, sort_keys=True)).items()
         if k != 'world'}
  if saved == cur:
    return
  raise LayoutMismatchError(
      'checkpoint %s was written with another table layout than this '
      'run uses: %s. Restore the matching layout settings, or warm-start '
      'from it with train_config.fine_tune_checkpoint, which restores '
      'the weights across layouts.'
      % (where, '; '.join(_mismatch_hints(saved, cur)) or 'stamp mismatch'))


class CheckpointManager:
  """Checkpoints under `<model_dir>/checkpoints/<step>/`, at most
  `max_to_keep` of them (the oldest are deleted)."""

  def __init__(self, model_dir: str, max_to_keep: int = 10,
               layout_stamp: Optional[dict] = None, world=None,
               layout: Optional[ShardLayout] = None):
    """world: the mesh.World of a trainer in one (every rank makes its
    manager; rank 0 writes the stamp and the dense state); layout: where
    this rank's rows go (ShardLayout), for saves and restores."""
    self.directory = os.path.join(os.path.abspath(model_dir), 'checkpoints')
    self.world = world
    self.layout = layout
    self.chief = world is None or world.rank == 0
    if self.chief:
      os.makedirs(self.directory, exist_ok=True)
    self.max_to_keep = int(max_to_keep)
    self._stamp = layout_stamp
    # a temporary step of a run killed while it saved
    if self.chief:
      for name in os.listdir(self.directory):
        if name.startswith(_TMP):
          shutil.rmtree(os.path.join(self.directory, name),
                        ignore_errors=True)
    self._barrier()

  def _barrier(self):
    if self.world is not None:
      self.world.barrier()

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
    # one temporary directory the ranks share, renamed by rank 0 once
    # every rank has written its rows
    tmp = os.path.join(self.directory, '%s%d%s' % (
        _TMP, step, '' if self.world is not None else '-%d' % os.getpid()))
    if self.chief:
      shutil.rmtree(tmp, ignore_errors=True)
      os.makedirs(tmp)
    self._barrier()
    if self.chief:
      torch.save(state, os.path.join(tmp, _STATE))
      with open(os.path.join(tmp, _STAMP), 'w') as f:
        json.dump(self._stamp or {}, f, indent=1, sort_keys=True)
    elif self.layout is not None and self.layout.splits:
      keys = sorted(self.layout.splits)
      torch.save({'tables': {k: state['tables'][k] for k in keys},
                  'ev': {k: state.get('ev', {}).get(k, {}) for k in keys}},
                 os.path.join(tmp, _SHARD % self.world.rank))
    self._barrier()
    if self.chief:
      os.replace(tmp, self.step_dir(step))
      steps = self.all_steps()
      for old in steps[:max(0, len(steps) - max(self.max_to_keep, 1))]:
        shutil.rmtree(self.step_dir(old), ignore_errors=True)
    self._barrier()
    return True

  def check_layout(self, step: int) -> None:
    """Raise LayoutMismatchError, naming what differs, if step `step` was
    written with another table layout than this run's."""
    if self._stamp is None:
      return
    with open(os.path.join(self.step_dir(step), _STAMP)) as f:
      check_stamp(json.load(f), self._stamp, self.step_dir(step))

  def restore(self, step: int) -> dict:
    """Step `step`'s state, its tables and EV counters re-split to this
    manager's layout (whole without one), whatever world wrote them."""
    self.check_layout(step)
    step_dir = self.step_dir(step)
    with open(os.path.join(step_dir, _STAMP)) as f:
      stamp = json.load(f)
    state = torch.load(os.path.join(step_dir, _STATE), map_location='cpu',
                       weights_only=True, mmap=True)
    return load_rows(state, stamp, step_dir, self.layout)

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
                     weights_only=True, mmap=True)
  logging.info('loaded checkpoint %s', step_dir)
  return load_rows(state, stamp, step_dir, None), stamp
