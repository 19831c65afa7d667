"""The one batch generator: a traffic file's parameters, the
configuration's features, a seed -> batches on the device.

A traffic file (recbench/traffic/<name>.json) gives, per feature of the
configuration, how its values are drawn:

  power_law   ids: a rank r in [1, vocab] from the truncated power law
              P(r) ~ r^-exponent by its inverse CDF (a copy of
              benchmarks/quality_proxy.py GroundTruth.draw_ids), landing on
              row (r * scatter) mod rows (bench.py's multiplicative hash;
              without `scatter`, on row r - 1). `vocab` defaults to the
              feature's rows. A sequence feature takes `length` [lo, hi]:
              one length a row, uniform, shared by the features of one
              `length_group`; positions past it carry id 0 and mask 0.
  lognormal   raw values exp(N(0, sigma)) - 1 rounded to `decimals`, then
              (x - min_val) / (max_val - min_val) as the port's RawFeature
              transform scales them: a `raw` feature's one value a row,
              the weight of its one-row table, or a `dense` feature's
              `value_dim` values a row, which reach the model with no
              table (feat.<f>.dense [B, value_dim]);

and each label's `bernoulli` share `p`. The batches are the dicts the
port's input pipeline yields (feat.<f>.ids / .weights / .mask or
feat.<f>.dense, label.<l>, sample_weight), made on the device in a few calls per feature. Every draw
has a generator of its own, seeded from (seed, batch, feature), so the same
seed gives the same batches, and a seed changes the rows but not the sizes.
"""

from __future__ import annotations

import zlib
from typing import Dict, List

import torch

from recbench import counts
from recbench.cell import table_features


def generator(seed: int, *parts, device) -> torch.Generator:
  """A generator on `device` seeded from `seed` and the names `parts`."""
  h = int(seed) % (1 << 63)
  for p in parts:
    h = (h * 1000003 + zlib.crc32(str(p).encode())) % (1 << 63)
  return torch.Generator(device=device).manual_seed(h)


def power_law_ids(gen, shape, vocab: int, exponent: float, rows: int,
                  scatter: int = 0, device=None) -> torch.Tensor:
  """int64 rows of `shape`: truncated power-law ranks over [1, vocab],
  scattered over [0, rows)."""
  u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
  a = float(exponent)
  top = float(vocab) ** (1.0 - a) - 1.0
  rank = torch.floor((top * u + 1.0) ** (1.0 / (1.0 - a)))
  rank = rank.clamp_(1, vocab).to(torch.int64)
  if scatter:
    return (rank * int(scatter)) % rows
  return (rank - 1) % rows


def lognormal_values(gen, shape, p: dict, device) -> torch.Tensor:
  """float32 values of `shape` by a `lognormal` draw's parameters."""
  x = torch.exp(torch.randn(shape, generator=gen, device=device) *
                float(p.get('sigma', 1.0))) - 1.0
  scale = 10.0 ** int(p.get('decimals', 3))
  x = torch.round(x * scale) / scale
  lo, hi = float(p.get('min_val', 0.0)), float(p.get('max_val', 0.0))
  if hi > lo:
    x = (x - lo) / (hi - lo)
  return x.to(torch.float32)


def make_batch(features: List[dict], traffic: dict, seed: int, index: int,
               device) -> Dict[str, torch.Tensor]:
  """Batch `index` of the traffic for `seed`."""
  b = int(traffic['batch_size'])
  spec = traffic['features']
  batch: Dict[str, torch.Tensor] = {}
  lengths: Dict[str, torch.Tensor] = {}
  for f in features:
    name, kind = f['name'], f['kind']
    p = spec[name]
    gen = generator(seed, index, name, device=device)
    if kind in ('raw', 'dense') and p['draw'] != 'lognormal':
      raise ValueError('feature %s: unknown draw %r' % (name, p['draw']))
    if kind == 'dense':
      batch['feat.%s.dense' % name] = lognormal_values(
          gen, (b, int(f['value_dim'])), p, device)
      continue
    if kind == 'raw':
      batch['feat.%s.ids' % name] = torch.zeros((b, 1), dtype=torch.int32,
                                                device=device)
      batch['feat.%s.weights' % name] = lognormal_values(gen, (b, 1), p,
                                                         device)
      continue
    if p['draw'] != 'power_law':
      raise ValueError('feature %s: unknown draw %r' % (name, p['draw']))
    rows = int(f['rows'])
    k = int(f.get('max_len', 1))
    ids = power_law_ids(gen, (b, k), int(p.get('vocab', rows)),
                        p['exponent'], rows, int(p.get('scatter', 0)),
                        device)
    if kind == 'seq':
      group = p.get('length_group', name)
      if group not in lengths:
        lo, hi = p['length']
        lengths[group] = torch.randint(
            int(lo), int(hi) + 1, (b, 1),
            generator=generator(seed, index, 'length', group, device=device),
            device=device)
      mask = torch.arange(k, device=device)[None, :] < lengths[group]
      batch['feat.%s.ids' % name] = (ids * mask).to(torch.int32)
      batch['feat.%s.mask' % name] = mask.to(torch.float32)
    else:
      batch['feat.%s.ids' % name] = ids.to(torch.int32)
      batch['feat.%s.weights' % name] = torch.ones((b, k), device=device)
  for label, p in traffic['labels'].items():
    gen = generator(seed, index, 'label', label, device=device)
    batch['label.%s' % label] = (torch.rand(b, generator=gen, device=device)
                                 < float(p['p'])).to(torch.float32)
  batch['sample_weight'] = torch.ones(b, device=device)
  return batch


def make_batches(features: List[dict], traffic: dict, seed: int,
                 device, count: int = 0) -> List[Dict[str, torch.Tensor]]:
  return [make_batch(features, traffic, seed, i, device)
          for i in range(count or int(traffic['batches']))]


def slot_counts(features: List[dict], batch: Dict[str, torch.Tensor]
                ) -> Dict[str, int]:
  """{'slots': id slots of the batch, 'rows': distinct rows they name,
  'slot_bytes': what the slots bring to the sparse update
  (counts.slot_bytes)}, over every feature with a table (each feature's
  rows are its own). Syncs the device: set-up only."""
  slots = rows = nbytes = 0
  for f in table_features(features):
    ids = batch['feat.%s.ids' % f['name']]
    slots += ids.numel()
    rows += int(torch.unique(ids).numel())
    nbytes += ids.numel() * counts.slot_bytes(ids.element_size(), f)
  return {'slots': slots, 'rows': rows, 'slot_bytes': nbytes}
