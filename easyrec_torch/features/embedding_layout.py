"""Embedding layout: fuse all same-dim tables into one matrix per dim.

Counterpart of easyrec_tpu/features/embedding_layout.py. Every embedding
table with the same dim is stacked into one fused table with per-member row
offsets, so a step does one gather and one sparse update per dim group.
Wide columns are embeddings too (dim = wide_output_dim, sum combiner); a
wide feature that also has a deep use is merged into the deep table as
extra columns of the same rows (:102-170) — on the flagship DeepFM one
table of physical dim 32 whose columns [0:16) are deep, [16:17) wide and
[17:32) zero alignment lanes.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from easyrec_torch.features.feature_spec import FeatureSpec

# every fused table gets one trailing scratch row (zero, never pulled by a
# real id)
SCRATCH_ROWS = 1


@dataclasses.dataclass
class TableUse:
  """One feature's slice inside a fused table's packed id axis."""
  feature: str
  role: str          # 'deep' | 'wide'
  k: int             # number of id slots ([B, k] ids)
  offset: int        # row offset of this feature's table inside the fusion
  start: int         # start column inside the fused [B, tot_k] id pack
  # merged wide-into-deep tables: this use reads a COLUMN slice of the
  # pulled rows (deep cols [0:D), wide col(s) [D:D+W)); 0 = full dim
  col_start: int = 0
  col_dim: int = 0


@dataclasses.dataclass
class FusedTable:
  key: str                       # e.g. 'emb16' / 'wide1'
  dim: int                       # PHYSICAL column count (may be padded)
  rows: int                      # total rows incl. scratch row
  offsets: Dict[str, int]        # member table_name -> row offset
  member_rows: Dict[str, int]
  uses: List[TableUse] = dataclasses.field(default_factory=list)
  stddev: Dict[str, float] = dataclasses.field(default_factory=dict)
  # merged tables: cols [0:used_dim) are live, the rest is zero padding
  used_dim: int = 0

  @property
  def tot_k(self) -> int:
    return sum(u.k for u in self.uses)


class EmbeddingLayout:
  """Builds fused tables from feature specs and their group roles."""

  def __init__(self,
               specs: Dict[str, FeatureSpec],
               deep_features: Iterable[str],
               wide_features: Iterable[str] = (),
               wide_output_dim: int = 4):
    self.specs = specs
    self.wide_output_dim = wide_output_dim
    self.tables: Dict[str, FusedTable] = {}
    # (feature, role) -> (table_key, TableUse)
    self.feature_use: Dict[Tuple[str, str], Tuple[str, TableUse]] = {}

    deep = list(dict.fromkeys(deep_features))
    wide = list(dict.fromkeys(wide_features))

    plans: Dict[str, List[Tuple[str, str, FeatureSpec]]] = {}
    for fname in deep:
      spec = specs[fname]
      if spec.kind == 'dense' or spec.seq_is_dense:
        continue
      if spec.embedding_dim <= 0:
        raise ValueError('feature %s has no embedding_dim but is used in a '
                         'deep group' % fname)
      plans.setdefault('emb%d' % spec.embedding_dim, []).append(
          (fname, 'deep', spec))
    for fname in wide:
      spec = specs[fname]
      if spec.kind == 'dense':
        continue
      plans.setdefault('wide%d' % wide_output_dim, []).append(
          (fname, 'wide', spec))

    # wide-into-deep merge: the wide weights of a feature that also has a
    # deep use live as extra columns of the deep table's rows
    self.merged_wide: Dict[str, Tuple[str, int]] = {}
    deep_feats = {f for k, ms in plans.items() if k.startswith('emb')
                  for f, _, _ in ms}
    for wkey in [k for k in plans if k.startswith('wide')]:
      keep = []
      for fname, role, spec in plans[wkey]:
        dkey = 'emb%d' % spec.embedding_dim
        pad = merged_pad_dim(spec.embedding_dim + wide_output_dim)
        if fname in deep_feats and dkey in plans and pad:
          self.merged_wide[fname] = (dkey, spec.embedding_dim)
        else:
          keep.append((fname, role, spec))
      if keep:
        plans[wkey] = keep
      else:
        del plans[wkey]

    for key, members in plans.items():
      dim = members[0][2].embedding_dim if not key.startswith('wide') \
          else wide_output_dim
      merged_here = [f for f, (k2, _) in self.merged_wide.items()
                     if k2 == key]
      used_dim = dim + (wide_output_dim if merged_here else 0)
      phys_dim = merged_pad_dim(used_dim) if merged_here else dim
      offsets: Dict[str, int] = {}
      member_rows: Dict[str, int] = {}
      stddev: Dict[str, float] = {}
      next_row = 0
      uses: List[TableUse] = []
      start = 0
      for fname, role, spec in members:
        tname = spec.table_name if role == 'deep' else \
            spec.table_name + '__wide'
        if tname not in offsets:
          offsets[tname] = next_row
          member_rows[tname] = spec.rows
          stddev[tname] = init_stddev(spec, dim)
          next_row += spec.rows
        use = TableUse(feature=fname, role=role, k=spec.num_ids,
                       offset=offsets[tname], start=start,
                       col_start=0, col_dim=dim if merged_here else 0)
        uses.append(use)
        start += spec.num_ids
        self.feature_use[(fname, role)] = (key, use)
        if fname in merged_here:
          self.feature_use[(fname, 'wide')] = (key, TableUse(
              feature=fname, role='wide', k=spec.num_ids,
              offset=offsets[tname], start=use.start,
              col_start=dim, col_dim=wide_output_dim))
      self.tables[key] = FusedTable(
          key=key, dim=phys_dim, rows=next_row + SCRATCH_ROWS,
          offsets=offsets, member_rows=member_rows, uses=uses,
          stddev=stddev, used_dim=used_dim if merged_here else dim)

  def init_weights(self, key: str, rng_seed: int, device: torch.device,
                   out: torch.Tensor,
                   chunk_rows: int = 1 << 22) -> torch.Tensor:
    """Fill `out` ([rows, >= dim] on `device`; columns [0:dim) are the
    weights) with the table's initial weights, ON the device.

    Each member table draws normal(0, stddev) into its live columns
    [0:used_dim); alignment lanes, inter-member gaps and the scratch row
    are zero. Counterpart of init_packed_tables_on_device (:274-367): the
    values come from a torch.Generator on `device` seeded with
    seed ^ crc32(key), chunk by chunk so the peak stays at the table plus
    one chunk. The 26M-row flagship table never crosses the host link.
    """
    t = self.tables[key]
    used = t.used_dim or t.dim
    gen = torch.Generator(device=device)
    gen.manual_seed(rng_seed ^ (zlib.crc32(key.encode()) & 0x7fffffff))
    w = out[:, :t.dim]
    w.zero_()
    for name, off in sorted(t.offsets.items(), key=lambda kv: kv[1]):
      n, std = t.member_rows[name], float(t.stddev[name])
      for lo in range(0, n, chunk_rows):
        hi = min(n, lo + chunk_rows)
        block = torch.randn((hi - lo, used), generator=gen, device=device,
                            dtype=torch.float32)
        w[off + lo:off + hi, :used] = block.mul_(std)
    return out

  def fill_slots(self, key: str, out: torch.Tensor,
                 values) -> torch.Tensor:
    """Fill the optimizer slot parts of `out` ([rows, (1 + len(values)) *
    dim]): part p + 1 of every member row holds values[p] (Adagrad's and
    FTRL's accumulators start at initial_accumulator_value); the scratch
    row stays zero, as init_packed_tables_on_device (:274-320) leaves
    padding."""
    t = self.tables[key]
    live = t.rows - SCRATCH_ROWS
    for p, value in enumerate(values, 1):
      out[:live, p * t.dim:(p + 1) * t.dim] = float(value)
    return out


def merged_pad_dim(used: int):
  """Smallest physical dim >= used in (16, 32, 64, 128) whose combined
  widths the JAX package's packed kernel accepts for both its compact
  (2-part) and full (3-part) layouts, or None (the merge is then skipped).
  Re-derived from packed_table.supported (:182): width lcm(cc, 128) must
  stay within 512 lanes, cc = dim * parts."""
  def width_ok(cc):
    return cc * (128 // math.gcd(cc, 128)) <= 512
  for p in (16, 32, 64, 128):
    if p >= used and width_ok(3 * p) and width_ok(2 * p):
      return p
  return None


def init_stddev(spec: FeatureSpec, dim: int) -> float:
  config = spec.config
  if config is not None and config.HasField('ev_params') and \
      config.ev_params.filter_freq > 0:
    # EV admission: an id has no embedding until admitted, so it starts at
    # zero and reads the EV default everywhere (features/ev.py)
    return 0.0
  if config is not None and config.HasField('initializer'):
    init = config.initializer
    which = init.WhichOneof('initializer_oneof')
    if which == 'truncated_normal_initializer':
      return init.truncated_normal_initializer.stddev
    if which == 'random_normal_initializer':
      return init.random_normal_initializer.stddev
    if which == 'glorot_normal_initializer':
      return float(np.sqrt(2.0 / (spec.rows + dim)))
    if which == 'constant_initializer':
      return 0.0
  # default: 0.01/sqrt(dim), the reference's embedding_column default
  return float(0.01 / np.sqrt(dim))
