"""Initial weights from --seed, made on the device, handed alike to the
port and to the reference.

Tables: each feature's rows draw normal(0, init_std) into [rows, dim +
wide_dim] (its deep columns, then its wide ones), chunk by chunk from a
generator of its own, so the reference draws them again bit for bit after
the port's state is freed, and no second copy of a 26M-row table is ever
held. Dense parameters, by name: kernels (2-D `weight`) lecun-normal
truncated at two deviations (flax's default, as the port's Dense), other
`weight`s (BatchNorm scales) 1, the rest 0.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

from recbench.cell import table_features
from recbench.traffic import generator

# rows of a table that a walk over it (drawing, writing, reading the
# norms) holds at a time; the generator draws DRAW_ROWS rows a call, which
# fixes the tables' bits
CHUNK_ROWS = 1 << 20
DRAW_ROWS = 1 << 22
_TRUNC_STD = 0.87962566103423978   # stddev of N(0, 1) truncated to (-2, 2)


def table_width(feature: dict) -> int:
  return int(feature['dim']) + int(feature.get('wide_dim', 0))


def table_chunks(seed: int, feature: dict, std: float, device
                 ) -> Iterator[Tuple[int, int, torch.Tensor]]:
  """(lo, hi, rows lo..hi of the feature's [rows, dim + wide_dim] initial
  table), in order, at most CHUNK_ROWS rows each."""
  gen = generator(seed, 'table', feature['name'], device=device)
  rows, width = int(feature['rows']), table_width(feature)
  for first in range(0, rows, DRAW_ROWS):
    last = min(rows, first + DRAW_ROWS)
    drawn = torch.randn((last - first, width), generator=gen,
                        device=device).mul_(float(std))
    for lo in range(first, last, CHUNK_ROWS):
      hi = min(last, lo + CHUNK_ROWS)
      yield lo, hi, drawn[lo - first:hi - first]
    del drawn


def dense_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device
                  ) -> Dict[str, torch.Tensor]:
  """Initial dense parameters by name, drawn in sorted name order."""
  gen = generator(seed, 'dense', device=device)
  out = {}
  for name in sorted(shapes):
    shape = tuple(shapes[name])
    leaf = name.rsplit('.', 1)[-1]
    if leaf == 'weight' and len(shape) == 2:
      w = torch.empty(shape, device=device)
      torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
      out[name] = w.mul_(math.sqrt(1.0 / shape[1]) / _TRUNC_STD)
    elif leaf == 'weight':
      out[name] = torch.ones(shape, device=device)
    else:
      out[name] = torch.zeros(shape, device=device)
  return out


def program_columns(trainer, name: str, role: str):
  """(fused table key, first row, first column) of feature `name`'s `role`
  ('deep' or 'wide') columns in the port's fused tables."""
  key, use = trainer.layout.feature_use[(name, role)]
  return key, use.offset, (use.col_start if use.col_dim else 0)


@torch.no_grad()
def load_into_program(trainer, features, shapes, seed: int, std: float
                      ) -> Dict[str, torch.Tensor]:
  """Write the initial weights into an initialised Trainer's tables and
  model; returns the dense weights (the reference gets the same). A
  `dense` feature has no table to write."""
  for f in table_features(features):
    dim, wide = int(f['dim']), int(f.get('wide_dim', 0))
    deep_k, deep_r, deep_c = program_columns(trainer, f['name'], 'deep')
    deep_t = trainer.tables[deep_k]
    if wide:
      wide_k, wide_r, wide_c = program_columns(trainer, f['name'], 'wide')
      wide_t = trainer.tables[wide_k]
    for lo, hi, block in table_chunks(seed, f, std, trainer.device):
      deep_t[deep_r + lo:deep_r + hi, deep_c:deep_c + dim] = block[:, :dim]
      if wide:
        wide_t[wide_r + lo:wide_r + hi, wide_c:wide_c + wide] = block[:, dim:]
  params = dict(trainer.model.named_parameters())
  got = {n: tuple(p.shape) for n, p in params.items()}
  if got != {n: tuple(s) for n, s in shapes.items()}:
    raise ValueError('the port\'s parameters %s differ from the '
                     'reference\'s %s' % (sorted(got.items()),
                                          sorted(shapes.items())))
  dense = dense_weights(shapes, seed, trainer.device)
  for n, p in params.items():
    p.copy_(dense[n])
  return dense
