"""EVParams semantics on static hash tables: frequency-filtered admission
(filter_freq) and TTL eviction (steps_to_live).

Counterpart of easyrec_tpu/features/ev.py. The reference's
EmbeddingVariable grows a KV store that creates an embedding once an id has
been seen `filter_freq` times and frees ids unseen for `steps_to_live`
steps. On static hash buckets the equivalents are:
  - members with filter_freq > 0 initialise to zero
    (embedding_layout.init_stddev), so an id without a trained embedding
    reads the reference's default value everywhere;
  - a COUNT aux table [rows, 1] per fused table accumulates the
    occurrences of training ids (the base batch view only); in training,
    the pulled rows of id slots not yet admitted (count < filter_freq) or
    stale (step - last_seen > steps_to_live) are zeroed, so their gradients
    vanish and the sparse update leaves their rows untouched. Admission
    reads the counts BEFORE the current batch (the one-batch delay of the
    JAX package, :18-21);
  - a LAST-SEEN aux table [rows, 1] records the step of every touched row;
    `evict_stale`, run before every checkpoint save, resets rows stale
    beyond their member's steps_to_live: the whole combined row, optimizer
    slots included, to 0.0, and both counters, so the id must earn its
    admission again.
Both aux tables are updated through the port's sparse update
(ops/packed_table.apply_packed_update: K1 + K2, or K3 under
EASYREC_PACKED_FUSED=1) with the block maths EvAdd and EvSet
(optim/sparse.py), the counterparts of the JAX package's add_math and
set_math (:202-206) on its packed path. The counts are sums of ones: K1
under EASYREC_GG_BF16=1 rounds an id's per-batch count to bf16 once, so a
count above 256 occurrences of one id in one batch moves in steps of 2 or
more; K3 and the other modes add exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from easyrec_torch.ops import packed_table as pt
from easyrec_torch.optim.sparse import EvAdd, EvSet

EV_ADD = EvAdd()
EV_SET = EvSet()
AUX_NAMES = ('ev_count', 'ev_last')


@dataclasses.dataclass
class TableEv:
  """EV config of one fused table."""
  thr_cols: np.ndarray     # [tot_k] admission threshold per pack column
  ttl: int                 # max steps_to_live over members (0 = off)
  ttl_cols: np.ndarray     # [tot_k] steps_to_live per pack column
  row_segments: tuple      # ((start, end, filter_freq, ttl), ...)

  @property
  def enabled(self) -> bool:
    return bool(self.thr_cols.max() > 0 or self.ttl > 0)


def build_ev_plan(layout, specs) -> Optional[Dict[str, TableEv]]:
  """Per fused table: admission thresholds per id-pack column and TTL.
  None when no feature sets ev_params (JAX ev.py:59)."""
  plan = {}
  any_ev = False
  for key, table in layout.tables.items():
    thr = np.zeros((table.tot_k,), np.int32)
    ttl_cols = np.zeros((table.tot_k,), np.int32)
    segs = []
    ttl = 0
    for use in table.uses:
      spec = specs[use.feature]
      cfg = spec.config
      ff = lv = 0
      if cfg is not None and cfg.HasField('ev_params'):
        ff = int(cfg.ev_params.filter_freq)
        lv = int(cfg.ev_params.steps_to_live)
      thr[use.start:use.start + use.k] = ff
      ttl_cols[use.start:use.start + use.k] = lv
      tname = spec.table_name if use.role == 'deep' \
          else spec.table_name + '__wide'
      off = table.offsets[tname]
      segs.append((off, off + table.member_rows[tname], ff, lv))
      ttl = max(ttl, lv)
    ev = TableEv(thr_cols=thr, ttl=ttl, ttl_cols=ttl_cols,
                 row_segments=tuple(segs))
    any_ev = any_ev or ev.enabled
    plan[key] = ev
  return plan if any_ev else None


def aux_meta(rows: int) -> pt.TableMeta:
  """The layout of an aux table: dim 1, one part."""
  return pt.TableMeta(rows, 1, 1)


def init_ev_state(layout, plan: Dict[str, TableEv],
                  device) -> Dict[str, Dict[str, torch.Tensor]]:
  """Zero count / last-seen aux tables [rows, 1] f32 per EV-enabled fused
  table (JAX ev.py:103): ev_count where a member filters, ev_last where
  one has a TTL."""
  out = {}
  for key, ev in plan.items():
    if not ev.enabled:
      continue
    rows = layout.tables[key].rows
    aux = {}
    if ev.thr_cols.max() > 0:
      aux['ev_count'] = torch.zeros((rows, 1), dtype=torch.float32,
                                    device=device)
    if ev.ttl > 0:
      aux['ev_last'] = torch.zeros((rows, 1), dtype=torch.float32,
                                   device=device)
    out[key] = aux
  return out


def keep_mask(pack: torch.Tensor, aux: Dict[str, torch.Tensor],
              ev: TableEv, step: torch.Tensor) -> Optional[torch.Tensor]:
  """[B, tot_k] bool: the id slots admitted (count >= filter_freq) and
  fresh (step - last_seen <= ttl, or the column has no TTL); None where the
  table has neither counter."""
  keep = None
  if 'ev_count' in aux:
    counts = aux['ev_count'][:, 0][pack]
    thr = torch.as_tensor(ev.thr_cols, dtype=torch.float32,
                          device=pack.device)[None, :]
    keep = counts >= thr
  if 'ev_last' in aux and ev.ttl > 0:
    last = aux['ev_last'][:, 0][pack]
    ttl_c = torch.as_tensor(ev.ttl_cols, dtype=torch.float32,
                            device=pack.device)[None, :]
    age = step.to(torch.float32) - last
    fresh = (age <= ttl_c) | (ttl_c <= 0)
    keep = fresh if keep is None else keep & fresh
  return keep


def mask_pulled(pulled: Dict[str, torch.Tensor],
                packs: Dict[str, torch.Tensor],
                ev_state: Dict[str, Dict[str, torch.Tensor]],
                plan: Dict[str, TableEv], step: torch.Tensor,
                masked: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
  """Zero the pulled rows of id slots not admitted or stale (JAX
  ev.py:137-172), in every batch view: the base batch and a sampler's
  'neg.' and 'hard_neg.' views, so that a sampled negative of an id not
  yet admitted leaks no gradient either. The product is differentiated,
  so their gradients vanish and the sparse update leaves their rows
  untouched. `masked`, a device scalar, is incremented by the number of
  slots zeroed (no host sync)."""
  out = dict(pulled)
  for key, ev in plan.items():
    if not ev.enabled:
      continue
    for view in (key, 'neg.' + key, 'hard_neg.' + key):
      if view not in pulled:
        continue
      keep = keep_mask(packs[view], ev_state.get(key, {}), ev, step)
      if keep is not None:
        out[view] = pulled[view] * keep[..., None].to(pulled[view].dtype)
        if masked is not None:
          masked += (~keep).sum()
  return out


def update_ev_state(ev_state: Dict[str, Dict[str, torch.Tensor]],
                    packs: Dict[str, torch.Tensor],
                    plan: Dict[str, TableEv], step: torch.Tensor) -> None:
  """counts += occurrences; last_seen = step, for the ids of the base
  batch only, in place (JAX ev.py:177): a sampled negative is not an
  occurrence, and a view's filler columns (id 0) would admit row 0. Each
  aux table takes one sparse update with a gradient of ones, EvAdd on
  ev_count and EvSet on ev_last. `step` is the step before its
  increment."""
  for key, ev in plan.items():
    aux = ev_state.get(key)
    if not ev.enabled or not aux or key not in packs:
      continue
    ids = packs[key].reshape(-1)
    ones = torch.ones((ids.shape[0], 1), dtype=torch.float32,
                      device=ids.device)
    hypers = EV_ADD.hypers(None, step)
    for name, math in (('ev_count', EV_ADD), ('ev_last', EV_SET)):
      if name in aux:
        pt.apply_packed_update(aux[name], ids, ones, hypers, math,
                               aux_meta(aux[name].shape[0]))


def stale_rows(aux: Dict[str, torch.Tensor], ev: TableEv,
               step: torch.Tensor) -> torch.Tensor:
  """[rows] bool: rows inside a member segment with steps_to_live whose
  last-seen step is older than it, step - last > ttl in f32 (rows never
  seen have last 0)."""
  last = aux['ev_last'][:, 0]
  r = torch.arange(last.shape[0], device=last.device)
  age = step.to(torch.float32) - last
  stale = torch.zeros(last.shape[0], dtype=torch.bool, device=last.device)
  for start, end, _ff, lv in ev.row_segments:
    if lv > 0:
      stale |= (r >= start) & (r < end) & (age > float(lv))
  return stale


def evict_stale(tables: Dict[str, torch.Tensor],
                ev_state: Dict[str, Dict[str, torch.Tensor]],
                plan: Dict[str, TableEv],
                step: torch.Tensor) -> Dict[str, Tuple[int, int]]:
  """The TTL sweep, in place (JAX ev.py:237): rows stale beyond their
  member's steps_to_live are zeroed, the whole combined row (weights and
  optimizer slots, to 0.0, not to the slots' initial values) and both
  counters. Members without steps_to_live are never touched. Returns per
  table the number of rows swept and, of those, rows an id had touched
  (last seen after step 0; the others were never trained)."""
  swept = {}
  for key, ev in plan.items():
    aux = ev_state.get(key, {})
    if not ev.enabled or ev.ttl <= 0 or 'ev_last' not in aux:
      continue
    stale = stale_rows(aux, ev, step)
    seen = stale & (aux['ev_last'][:, 0] > 0)
    tables[key][stale] = 0.0
    for name in AUX_NAMES:
      if name in aux:
        aux[name][stale] = 0.0
    swept[key] = (stale.sum(), seen.sum())
  return {k: (int(a), int(b)) for k, (a, b) in swept.items()}
