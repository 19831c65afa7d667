"""How `correct` is decided: the port's first three steps, as set-up drives
them through Trainer.train_step, against the plain reference's three steps
from the same initial weights and batches.

Both sides are read alike (common.readings is the reference's reader):
  - each step's total loss (model loss, l2 and embedding regulariser);
  - after step 1, each leaf's first gradient as the optimizer holds it:
    |mu| / (1 - b1) and |sqrt(nu)| / sqrt(1 - b2), of every dense
    parameter and of every feature's table (deep and wide columns apart),
    the table's moments decoded from the port's packed rows;
  - after step 3, before step 4 writes over it, the norm of each leaf's
    change from its initial weights.
The numbers compared (each against its limit in the workload file):
  loss_1,        |loss - ref| / |ref| of each step: the first step's
  loss_2,        forward and backward, then the model after one and two
  loss_3         updates of its dense parameters and table rows;
  grad_dense,    the worst leaf's |norm - ref| / max(ref, the median
  grad_table     leaf's ref), over mu and nu;
  change_dense,  the same for the change;
  change_table
Leaves whose reference gradient lies under a thousandth of the median
leaf's are left out of every number: they move by round-off alone (a
bias under BatchNorm). The median leaf's norm floors each leaf's own, as
the benchmark's contract measures a gap of norms, since some leaves'
gradients are all but zero; own_gaps (read by the calibration only)
gives each number against the leaf's own norm, and PERF.md the readings.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

from recbench.cell import table_features
from recbench.reference import common
from recbench.weights import CHUNK_ROWS, program_columns, table_chunks

NUMBERS = ('loss_1', 'loss_2', 'loss_3', 'grad_dense', 'grad_table',
           'change_dense', 'change_table')
DEAD_LEAF = 1e-3


def _columns(trainer, name: str, role: str):
  """(table, meta, first row, first weight column) of a feature's role."""
  key, row, col = program_columns(trainer, name, role)
  return trainer.tables[key], trainer.metas[key], row, col


def _moments(table, meta, lo, hi, col, width):
  """(m, v) f32 of rows lo..hi, columns col..col+width of the port's
  table: the compact layout's bf16 pair (m in the high 16 bits) or the
  3-part layout's f32 parts."""
  d = meta.dim
  if meta.compact:
    u = table[lo:hi, d + col:d + col + width].contiguous().view(torch.int32)
    return ((u & -65536).view(torch.float32),
            (u << 16).view(torch.float32))
  return (table[lo:hi, d + col:d + col + width],
          table[lo:hi, 2 * d + col:2 * d + col + width])


@torch.no_grad()
def program_gradient_norms(trainer, features, opt: dict
                           ) -> Dict[str, Dict[str, float]]:
  """The port's first gradient by leaf, from its optimizer state after
  step 1 (common.Reference.gradient_norms' reading)."""
  a, b = 1 - opt['b1'], math.sqrt(1 - opt['b2'])
  dopt = trainer.dense_opt
  grad_m, grad_v = {}, {}
  for name, mu, nu in zip(dopt.names, dopt.mu, dopt.nu):
    grad_m[name] = float(torch.linalg.vector_norm(mu.double())) / a
    grad_v[name] = math.sqrt(float(nu.double().sum())) / b
  for f in table_features(features):
    for role, width in common.roles(f):
      table, meta, row, col = _columns(trainer, f['name'], role)
      sm = sv = 0.0
      for lo in range(0, int(f['rows']), CHUNK_ROWS):
        hi = min(int(f['rows']), lo + CHUNK_ROWS)
        m, v = _moments(table, meta, row + lo, row + hi, col, width)
        sm += float((m.double() ** 2).sum())
        sv += float(v.double().sum())
      leaf = common.leaf_name(f['name'], role)
      grad_m[leaf] = math.sqrt(sm) / a
      grad_v[leaf] = math.sqrt(sv) / b
  return {'grad_m': grad_m, 'grad_v': grad_v}


@torch.no_grad()
def program_change_norms(trainer, features, dense0, seed: int, std: float
                         ) -> Dict[str, float]:
  """Each leaf's change from the initial weights (the tables' drawn again,
  chunk by chunk, beside the port's rows)."""
  out = {n: float(torch.linalg.vector_norm((p - dense0[n]).double()))
         for n, p in trainer.model.named_parameters()}
  for f in table_features(features):
    cols = {role: _columns(trainer, f['name'], role)
            for role, _ in common.roles(f)}
    sq = {role: 0.0 for role in cols}
    first = {'deep': 0, 'wide': int(f['dim'])}
    for lo, hi, block in table_chunks(seed, f, std, trainer.device):
      for role, width in common.roles(f):
        table, _, row, col = cols[role]
        sq[role] += common.squared_gap(
            table[row + lo:row + hi, col:col + width],
            block[:, first[role]:first[role] + width])
    for role in cols:
      out[common.leaf_name(f['name'], role)] = math.sqrt(sq[role])
  return out


def _live(ref: dict) -> List[str]:
  grads = ref['grad_m']
  floor = DEAD_LEAF * statistics.median(grads.values())
  return [k for k, v in grads.items() if v >= floor]


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves,
               floor: float) -> Dict[str, float]:
  """Each leaf's |norm - ref| against the larger of its own reference
  norm and `floor`."""
  return {k: abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
          for k in leaves}


def _worst(prog: Dict[str, float], ref: Dict[str, float], leaves,
           live) -> float:
  """The widest gap over `leaves`, each against the larger of its own
  reference norm and the median live leaf's."""
  med = statistics.median(ref[k] for k in live)
  return max(_leaf_gaps(prog, ref, leaves, med).values(), default=0.0)


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
  """The numbers compared, from two readings of the same shape."""
  out = {'loss_%d' % (i + 1): abs(p - r) / abs(r)
         for i, (p, r) in enumerate(zip(prog['loss'], ref['loss']))}
  live = _live(ref)
  for kind in ('dense', 'table'):
    leaves = [k for k in live if k.startswith('table.') == (kind == 'table')]
    out['grad_' + kind] = max(_worst(prog[q], ref[q], leaves, live)
                              for q in ('grad_m', 'grad_v'))
    out['change_' + kind] = _worst(prog['change'], ref['change'], leaves,
                                   live)
  for k, v in out.items():
    if not math.isfinite(v):
      out[k] = math.inf
  return out


def own_gaps(prog: dict, ref: dict) -> Dict[str, list]:
  """The gradient and change numbers with each live leaf against its own
  reference norm, no median floor: {number: [gap, leaf]}."""
  live = _live(ref)
  out = {}
  for kind in ('dense', 'table'):
    leaves = [k for k in live if k.startswith('table.') == (kind == 'table')]
    for number, quantities in (('grad_' + kind, ('grad_m', 'grad_v')),
                               ('change_' + kind, ('change',))):
      worst = [0.0, '']
      for q in quantities:
        for k, v in _leaf_gaps(prog[q], ref[q], leaves, 0.0).items():
          if v > worst[0]:
            worst = [v, '%s %s' % (q, k)]
      out[number] = worst
  return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
  """(correct, [(name, number, limit)]): every number at or under its
  limit; a number without a limit fails."""
  rows = [(k, numbers.get(k, math.inf), limits.get(k)) for k in NUMBERS]
  return all(lim is not None and n <= lim for _, n, lim in rows), rows
