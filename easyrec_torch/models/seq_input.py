"""Group inputs. Counterpart of easyrec_tpu/models/seq_input.py:
group_input (:110) on its non-sequence path (the plain embedding concat of
a feature group; sequence sub-groups are not ported), group_input_fn
(:131-145) and seq_group_tensors (:33-52)."""

from __future__ import annotations

import torch


def group_input(ctx, pulled, batch, group_name: str) -> torch.Tensor:
  if ctx.groups[group_name].sequence_features:
    raise NotImplementedError('sequence_features of group %s are not ported'
                              % group_name)
  return ctx.input_layer.group_concat(pulled, batch,
                                      ctx.group_features(group_name))


def group_input_fn(ctx, pulled, batch):
  """Memoised group_input: towers that share a feature group render it
  once."""
  cache = {}

  def gi(group_name: str) -> torch.Tensor:
    if group_name not in cache:
      cache[group_name] = group_input(ctx, pulled, batch, group_name)
    return cache[group_name]

  return gi


def group_width(ctx, group_name: str) -> int:
  """Feature width of group_input's output."""
  width = 0
  for f in ctx.group_features(group_name):
    spec = ctx.specs[f]
    width += spec.value_dim if spec.kind == 'dense' else spec.embedding_dim
  return width


def seq_group_widths(ctx, group):
  """(query width or 0 without keys, history width) of a seq_att group."""
  dq = sum(ctx.specs[k].embedding_dim for m in group.seq_att_map
           for k in m.key)
  dh = sum(ctx.specs[h].embedding_dim for m in group.seq_att_map
           for h in m.hist_seq)
  return dq, dh


def seq_group_tensors(ctx, group, batch, pulled):
  """One seq_att group -> (query [B, Dq] or None, hist [B, L, D], mask
  [B, L]). Keys concatenate along features, histories along their embedding
  axis, and the mask is the elementwise max over the histories."""
  il = ctx.input_layer
  keys, seqs, mask = [], [], None
  for m in group.seq_att_map:
    for k in m.key:
      keys.append(il.feature_embedding(pulled, batch, k))
    for h in m.hist_seq:
      seq, msk = il.sequence_embedding(pulled, batch, h)
      seqs.append(seq)
      mask = msk if mask is None else torch.maximum(mask, msk)
  query = None
  if keys:
    query = torch.cat(keys, dim=1) if len(keys) > 1 else keys[0]
  hist = torch.cat(seqs, dim=2) if len(seqs) > 1 else seqs[0]
  return query, hist, mask
