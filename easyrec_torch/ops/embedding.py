"""Embedding ops: id packing, fused gather, combiners, input-layer assembly.

Counterpart of easyrec_tpu/ops/embedding.py (single device): `pack_ids`
(:21), `pull_embeddings` (:56), `pack_all_views` (:230), `combine` (:241)
and `InputLayer` (:268-422); over a row-sharded table in a world of
processes, `ep_pull_sharded` (:150-227) and `ep_pull_replicated` (:114-142). A sampler's batch views ('neg.', 'hard_neg.')
are packed under '<prefix><table>' and read through the InputLayer's
`prefix`. A sequence in a flat
feature group is reduced by its SequenceCombiner (`_combine_sequence`,
:361): the masked mean, or an attention, multi-head attention or TextCNN
whose parameters flax creates inside the calling model; here the model
owns them (models/seq_input.build_group_input) and is passed as
`owner`. The pull
happens OUTSIDE the differentiated forward: the backward pass produces
gradients of the pulled rows [B, totK, dim], which the sparse update then
applies to the table. In a train step the pulled rows come as a
`StepPulls`, which cuts each pack once into its uses' pieces; the
InputLayer reads a use's rows from its piece there, and by a slice of the
whole pack from any other mapping (eval, predict, export).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from easyrec_torch.features.embedding_layout import EmbeddingLayout
from easyrec_torch.ops import packed_table as pt
from easyrec_torch.parallel import exchange as xch
from easyrec_torch.parallel.mesh import RowSplit, World
from easyrec_torch.utils.spans import span


def pack_ids(layout: EmbeddingLayout, batch: Dict[str, torch.Tensor],
             prefix: str = '') -> Dict[str, torch.Tensor]:
  """Concatenate every feature's ids (+ its table's row offset) into one
  [B, totK] int64 pack per fused table.

  With a prefix (a sampler's 'neg.' or 'hard_neg.' view, which carries the
  item-side features only), a feature absent from the view fills its
  columns with id 0, row 0 of the fused table, without its offset, as the
  JAX package does; a table none of whose features is in the view has no
  pack."""
  packs = {}
  for key, table in layout.tables.items():
    cols, rows, missing = [], None, []
    for use in table.uses:
      bkey = '%sfeat.%s.ids' % (prefix, use.feature)
      if bkey in batch:
        rows, device = batch[bkey].shape[0], batch[bkey].device
        cols.append(batch[bkey].to(torch.int64) + use.offset)
      elif prefix:
        cols.append(use.k)
        missing.append(len(cols) - 1)
      else:
        raise KeyError('batch is missing %s' % bkey)
    if rows is None:
      continue
    for i in missing:
      cols[i] = torch.zeros((rows, cols[i]), dtype=torch.int64,
                            device=device)
    packs[key] = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
  return packs


VIEWS = ('neg.', 'hard_neg.')


def pack_all_views(layout: EmbeddingLayout,
                   batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  """The base batch's packs, then each sampled view's present in the
  batch, under '<view><table>'."""
  with span('easyrec.pack'):
    packs = pack_ids(layout, batch)
    for pfx in VIEWS:
      if any(k.startswith(pfx + 'feat.') for k in batch):
        packs.update({pfx + k: v for k, v in
                      pack_ids(layout, batch, prefix=pfx).items()})
    return packs


def view_table(pack_key: str) -> str:
  """The table of a pack key ('neg.<table>' -> '<table>')."""
  for pfx in VIEWS:
    if pack_key.startswith(pfx):
      return pack_key[len(pfx):]
  return pack_key


@dataclasses.dataclass
class Sharding:
  """How a trainer in a world holds its tables: `splits` names the
  row-sharded ones (each rank holds its RowSplit block); a table not in it
  is whole on every rank. `stats` counts the rows this rank's exchanges
  dropped, by counter name (the JAX step's xstats)."""
  world: World
  splits: Dict[str, RowSplit]
  stats: Dict[str, int] = dataclasses.field(default_factory=dict)

  def count(self, name: str, n: int) -> None:
    self.stats[name] = self.stats.get(name, 0) + int(n)


def pull_embeddings(tables: Dict[str, torch.Tensor],
                    packs: Dict[str, torch.Tensor],
                    metas: Dict[str, pt.TableMeta],
                    sharding: Optional[Sharding] = None
                    ) -> Dict[str, torch.Tensor]:
  """One gather per pack (a table's, or a sampled view's of it) ->
  [rows, totK, dim]. A row-sharded table is read through the exchange:
  the base batch's pack and the 'hard_neg.' view (each rank's rows' own)
  by ep_pull_sharded, the 'neg.' view (the same on every rank) by
  ep_pull_replicated; dropped rows are counted into
  sharding.stats['ep_pull_overflow']."""
  out = {}
  for key, ids in packs.items():
    base = view_table(key)
    split = sharding.splits.get(base) if sharding is not None else None
    if split is None:
      out[key] = pt.pull(tables[base], ids, metas[base])
    elif key.startswith('neg.'):
      out[key] = ep_pull_replicated(sharding, tables[base], ids, split,
                                    metas[base].dim)
    else:
      out[key] = ep_pull_sharded(sharding, tables[base], ids, split,
                                 metas[base].dim)
  return out


def ep_pull_sharded(sharding: Sharding, table: torch.Tensor,
                    ids: torch.Tensor, split: RowSplit, dim: int,
                    counter: Optional[str] = 'ep_pull_overflow'
                    ) -> torch.Tensor:
  """EmbeddingParallel forward over a row-sharded table (JAX :150-227):
  flatten and dedup this rank's ids, send them to their owners, gather
  there from the owner's block `table` [count, >= dim], send the rows back
  and undo the dedup -> [..., dim]. Rows the capacity cut drops pull zeros
  and are counted under `counter`."""
  world = sharding.world
  lr = split.local_rows
  flat = ids.reshape(-1).to(torch.int64)
  n_loc = flat.shape[0]
  uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
  pad_id = world.size * lr
  uids = torch.cat([uniq, uniq.new_full((n_loc - uniq.shape[0],), pad_id)])
  route = xch.build_route(world, uids, lr, cap=xch.capacity_rows(
      n_loc, world.size, split.live_owners))
  lids = xch.send_to_owners(world, route, uids % lr, 0)
  n = sum(route.recv_sizes)
  rows = table.new_zeros((route.cap, dim))
  rows[:n] = torch.index_select(table[:, :dim], 0, lids[:n])
  vecs = xch.return_to_requesters(world, route, rows)
  if counter:
    sharding.count(counter, route.overflow)
  return vecs[inv].reshape(tuple(ids.shape) + (dim,))


def ep_pull_replicated(sharding: Sharding, table: torch.Tensor,
                       ids: torch.Tensor, split: RowSplit, dim: int
                       ) -> torch.Tensor:
  """EP pull of a pack every rank holds alike (a sampled view; JAX
  _ep_pull_replicated, :114-142): rank r pulls the r-th of W equal slices
  of the flat ids (padded with id 0), and the slices' rows are gathered
  on every rank."""
  world = sharding.world
  flat = ids.reshape(-1).to(torch.int64)
  pad = (-flat.shape[0]) % world.size
  if pad:
    flat = torch.cat([flat, flat.new_zeros(pad)])
  per = flat.shape[0] // world.size
  mine = flat[world.rank * per:(world.rank + 1) * per]
  vecs = torch.cat(world.all_gather(
      ep_pull_sharded(sharding, table, mine, split, dim)))
  if pad:
    vecs = vecs[:-pad]
  return vecs.reshape(tuple(ids.shape) + (dim,))


def combine(rows: torch.Tensor, weights: torch.Tensor,
            combiner: str) -> torch.Tensor:
  """Reduce [B, K, dim] weighted rows to [B, dim]; weight 0 marks
  padding."""
  with span('easyrec.embed.pool'):
    if combiner == 'sum':
      return torch.einsum('bk,bkd->bd', weights, rows)
    if combiner == 'mean':
      total = torch.einsum('bk,bkd->bd', weights, rows)
      denom = torch.clamp(weights.sum(dim=1, keepdim=True), min=1e-9)
      return total / denom
    if combiner in ('max', 'min'):
      mask = (weights > 0)[:, :, None]
      fill = float('-inf') if combiner == 'max' else float('inf')
      masked = torch.where(mask, rows * weights[:, :, None],
                           torch.full_like(rows, fill))
      out = masked.amax(dim=1) if combiner == 'max' else masked.amin(dim=1)
      return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    raise ValueError('unknown combiner %r' % combiner)


def sequence_combiner(spec):
  """The SequenceCombiner a sequence feature names (attention,
  multi_head_attention, text_cnn), or None for the masked mean."""
  cfg = spec.config
  if cfg is not None and cfg.HasField('sequence_combiner'):
    return cfg.sequence_combiner.WhichOneof('combiner')
  return None


def sequence_dim(spec) -> int:
  """Width of one step of a sequence: its values or its embedding."""
  return spec.value_dim if spec.seq_is_dense else spec.embedding_dim


# feature uses whose rows came from a piece of a StepPulls ('piece') and
# from a slice of the whole pack ('slice': a plain mapping, or a use whose
# slots are not one piece of its table)
_USES = {'piece': 0, 'slice': 0}


def reset_use_counts() -> None:
  _USES.update(piece=0, slice=0)


def use_counts() -> Dict[str, int]:
  return dict(_USES)


class StepPulls(dict):
  """The pulled packs of one train step (pack key -> [rows, totK, dim]),
  each cut once, at its first read, along its slot axis into the pieces of
  its table's uses (FusedTable.uses: consecutive and disjoint). Every use
  of the step reads its piece, so the backward of the one split writes the
  pack's gradient once; a slice per use would fill and add a gradient of
  the whole pack each. A piece is a view of its pack and holds it and its
  graph: Trainer.train_step makes one for the step alone."""

  def __init__(self, pulled: Dict[str, torch.Tensor],
               layout: EmbeddingLayout):
    super().__init__(pulled)
    self.layout = layout
    self._pieces: Dict[str, tuple] = {}

  def pieces(self, key: str) -> tuple:
    """Pack `key`'s pieces [rows, k, dim], one a use of its table."""
    got = self._pieces.get(key)
    if got is None:
      uses = self.layout.tables[view_table(key)].uses
      with span('easyrec.embed.split'):
        got = torch.split(self[key], [u.k for u in uses], dim=1)
      self._pieces[key] = got
    return got


class InputLayer:
  """Assembles per-feature embeddings from the fused pulls."""

  def __init__(self, layout: EmbeddingLayout, specs):
    self.layout = layout
    self.specs = specs
    # (feature, role) -> its piece among its table's uses, where its slots
    # are exactly one (a merged wide use shares its deep use's)
    self.piece_of = {}
    for fr, (key, use) in layout.feature_use.items():
      for i, u in enumerate(layout.tables[key].uses):
        if (u.start, u.k) == (use.start, use.k):
          self.piece_of[fr] = i
          break

  def use_rows(self, pulled, fname: str, role: str, prefix: str = ''
               ) -> torch.Tensor:
    """[rows, k, d] pulled rows of one use: its piece of a StepPulls, else
    a slice of the whole pack; then its columns of a merged table."""
    key, use = self.layout.feature_use[(fname, role)]
    i = self.piece_of.get((fname, role))
    if i is not None and isinstance(pulled, StepPulls):
      _USES['piece'] += 1
      rows = pulled.pieces(prefix + key)[i]
    else:
      _USES['slice'] += 1
      rows = pulled[prefix + key][:, use.start:use.start + use.k]
    if use.col_dim:
      # merged wide-into-deep table: this role reads a column slice
      rows = rows[..., use.col_start:use.col_start + use.col_dim]
    return rows

  def feature_embedding(self, pulled, batch, fname: str,
                        role: str = 'deep', prefix: str = ''
                        ) -> torch.Tensor:
    """[B, dim] combined embedding of one categorical feature, of the
    base batch or of the sampled view `prefix`."""
    with span('easyrec.embed'):
      spec = self.specs[fname]
      wkey = '%sfeat.%s.weights' % (prefix, fname)
      if prefix and wkey not in batch:
        raise KeyError(
            'feature %r is used by a sampled-negative tower but is not in '
            'the batch view %r: add its input column to the sampler\'s '
            'attr_fields' % (fname, prefix))
      rows = self.use_rows(pulled, fname, role, prefix)
      combiner = spec.combiner if role == 'deep' else 'sum'
      return combine(rows, batch[wkey], combiner)

  def sequence_embedding(self, pulled, batch, fname: str,
                         prefix: str = ''):
    """([B, L, dim] rows x mask, mask [B, L]) of one id sequence, or the
    [B, L, N] values x mask of a numeric one."""
    with span('easyrec.embed'):
      spec = self.specs[fname]
      mkey = '%sfeat.%s.mask' % (prefix, fname)
      if prefix and mkey not in batch:
        raise KeyError('sequence feature %r has no %r view in the batch'
                       % (fname, prefix))
      mask = batch[mkey]
      if spec.seq_is_dense:
        return batch[prefix + spec.dense_key] * mask[:, :, None], mask
      rows = self.use_rows(pulled, fname, 'deep', prefix)
      return rows * mask[:, :, None], mask

  def dense_feature(self, batch, fname: str, prefix: str = ''
                    ) -> torch.Tensor:
    return batch['%sfeat.%s.dense' % (prefix, fname)]

  def group_embeddings(self, pulled, batch, feature_names,
                       role: str = 'deep', owner=None, prefix: str = ''):
    """Per-feature [B, d_f] tensors of a group (dense features pass; a
    sequence is reduced by its combiner, held by `owner`)."""
    outs = []
    for f in feature_names:
      kind = self.specs[f].kind
      if kind == 'dense':
        outs.append(self.dense_feature(batch, f, prefix))
      elif kind == 'sequence':
        seq, mask = self.sequence_embedding(pulled, batch, f, prefix)
        outs.append(self.combine_sequence(owner, f, seq, mask))
      else:
        outs.append(self.feature_embedding(pulled, batch, f, role, prefix))
    return outs

  def combine_sequence(self, owner, fname: str, seq: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """[B, L, d] sequence -> [B, d'] by the feature's SequenceCombiner,
    whose module `owner` holds as seqcomb_<f>_att | _mha | _cnn; without
    one, the masked mean."""
    which = sequence_combiner(self.specs[fname])
    if which == 'attention':
      scores = getattr(owner, 'seqcomb_%s_att' % fname)(seq)[..., 0]
      scores = torch.where(mask > 0, scores,
                           torch.full_like(scores, -1e9))
      w = torch.softmax(scores, dim=-1)
      w = w * (mask.sum(dim=1, keepdim=True) > 0)
      return torch.einsum('bl,bld->bd', w, seq)
    if which == 'multi_head_attention':
      out = getattr(owner, 'seqcomb_%s_mha' % fname)(seq, mask)
      denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
      return (out * mask[:, :, None]).sum(dim=1) / denom
    if which == 'text_cnn':
      return getattr(owner, 'seqcomb_%s_cnn' % fname)(seq, mask)
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    return seq.sum(dim=1) / denom

  def group_concat(self, pulled, batch, feature_names,
                   role: str = 'deep', owner=None, prefix: str = ''
                   ) -> torch.Tensor:
    """[B, sum(d_f)] concatenation of a feature group."""
    outs = self.group_embeddings(pulled, batch, feature_names, role, owner,
                                 prefix)
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

  def group_stack(self, pulled, batch, feature_names,
                  role: str = 'deep') -> torch.Tensor:
    """[B, F, dim] stack (equal dims) for field-wise interactions."""
    outs = self.group_embeddings(pulled, batch, feature_names, role)
    dims = {o.shape[-1] for o in outs}
    if len(dims) != 1:
      raise ValueError('group_stack needs equal embedding dims, got %s'
                       % sorted(dims))
    return torch.stack(outs, dim=1)

  def wide_logits(self, pulled, batch, feature_names) -> torch.Tensor:
    """[B, wide_dim] summed wide terms, added in feature order."""
    outs = [self.feature_embedding(pulled, batch, f, 'wide')
            for f in feature_names if self.specs[f].kind != 'dense']
    if not outs:
      raise ValueError('wide group has no categorical features')
    total = outs[0]
    for o in outs[1:]:
      total = total + o
    return total
