"""Group inputs with their sequence parts.

Counterpart of easyrec_tpu/models/seq_input.py (whole): seq_group_tensors
(:33-52) with the aux histories, seq_att_output (:55-107), group_input
(:110-128), group_input_fn (:131-145) and seq_scopes (:148-161).

flax creates a group's parameters inside whatever model module renders
it: each sequence_features sub-group's score net `seq_dnn_<scope>` (a
DinAttention) and, where its key is wider than its history or
transform_dnn is set, `sequence_key_transform_<scope>` and
`sequence_fea_transform_<scope>`; each sequence feature of the group's
own feature_names with a SequenceCombiner its `seqcomb_<f>_att | _mha |
_cnn`. A torch model builds them in its __init__ with build_group_input,
under those names on itself, so convert.py maps them one to one; a group
shared by several towers gets one set, as group_input_fn's memo renders
it once.
"""

from __future__ import annotations

import torch
from torch import nn

from easyrec_torch.layers.attention import DinAttention, MultiHeadSelfAttention
from easyrec_torch.layers.blocks import TextCNN
from easyrec_torch.layers.dnn import Dense
from easyrec_torch.ops.embedding import sequence_combiner, sequence_dim

_DEFAULT_ATT_DIMS = (128, 64, 32)


def seq_scopes(group_name: str, sub_groups):
  """Parameter-scope names of a group's sequence_features:
  '<group>_<sub-name>' with a positional suffix on missing or repeated
  sub-group names."""
  seen = {}
  scopes = []
  for sg in sub_groups:
    base = sg.group_name or 'seq'
    n = seen.get(base, 0)
    seen[base] = n + 1
    scopes.append('%s_%s%s' % (group_name, base,
                               '' if n == 0 else '_%d' % n))
  return scopes


def seq_group_widths(ctx, group):
  """(query width or 0 without keys, history width, aux widths) of a
  seq_att group."""
  maps = group.seq_att_map
  dq = sum(ctx.specs[k].embedding_dim for m in maps for k in m.key)
  dh = sum(sequence_dim(ctx.specs[h]) for m in maps for h in m.hist_seq)
  da = [sequence_dim(ctx.specs[a]) for m in maps for a in m.aux_hist_seq]
  return dq, dh, da


def seq_group_tensors(ctx, group, batch, pulled):
  """One seq_att group -> (query [B, Dq] or None, hist [B, L, D], mask
  [B, L], aux [list of [B, L, Da]]). Keys concatenate along features,
  histories along their step axis's features, and the mask is the
  elementwise max over the histories."""
  il = ctx.input_layer
  keys, seqs, aux, mask = [], [], [], None
  for m in group.seq_att_map:
    for k in m.key:
      keys.append(il.feature_embedding(pulled, batch, k))
    for h in m.hist_seq:
      seq, msk = il.sequence_embedding(pulled, batch, h)
      seqs.append(seq)
      mask = msk if mask is None else torch.maximum(mask, msk)
    for a in m.aux_hist_seq:
      aux.append(il.sequence_embedding(pulled, batch, a)[0])
  query = None
  if keys:
    query = torch.cat(keys, dim=1) if len(keys) > 1 else keys[0]
  hist = torch.cat(seqs, dim=2) if len(seqs) > 1 else seqs[0]
  return query, hist, mask, aux


def _add(owner: nn.Module, name: str, make):
  if not hasattr(owner, name):
    owner.add_module(name, make())
  return getattr(owner, name)


def build_flat_part(owner: nn.Module, ctx, feature_names,
                     generator=None, device=None) -> int:
  """Build on `owner` the combiner modules of the sequences among a
  group's `feature_names`; returns the width of the group's concatenated
  features."""
  kw = dict(generator=generator, device=device)
  width = 0
  for f in feature_names:
    spec = ctx.specs[f]
    if spec.kind == 'dense':
      width += spec.value_dim
      continue
    if spec.kind != 'sequence':
      width += spec.embedding_dim
      continue
    d = sequence_dim(spec)
    which = sequence_combiner(spec)
    if which == 'attention':
      _add(owner, 'seqcomb_%s_att' % f, lambda: Dense(d, 1, **kw))
    elif which == 'multi_head_attention':
      head = max(d // 4, 1)
      _add(owner, 'seqcomb_%s_mha' % f,
           lambda: MultiHeadSelfAttention(d, 4, head, **kw))
      d = 4 * head
    elif which == 'text_cnn':
      tc = spec.config.sequence_combiner.text_cnn
      cnn = _add(owner, 'seqcomb_%s_cnn' % f, lambda: TextCNN(
          d, tuple(tc.filter_sizes) or (2, 3),
          tuple(tc.num_filters) or (8, 8), **kw))
      d = cnn.out_features
    width += d
  return width


def build_seq_att(owner: nn.Module, ctx, group, scope: str,
                  generator=None, device=None) -> int:
  """Build on `owner` the modules of one sequence_features sub-group
  (seq_att_output's); returns its output width."""
  kw = dict(generator=generator, device=device)
  dq, dh, da = seq_group_widths(ctx, group)
  if dq and dq != dh:
    if not group.allow_key_transform:
      raise ValueError(
          'sequence_features group %r: key dim %d != hist dim %d; set '
          'allow_key_transform to pad/project the key' % (scope, dq, dh))
    if not (dh > dq and not group.transform_dnn):
      _add(owner, 'sequence_key_transform_%s' % scope,
           lambda: Dense(dq, dh, **kw))
      _add(owner, 'sequence_fea_transform_%s' % scope,
           lambda: Dense(dh, dh, **kw))
  att_dims, act = _DEFAULT_ATT_DIMS, 'relu'
  if group.HasField('seq_dnn'):
    act = group.seq_dnn.activation or 'relu'
    hu = tuple(group.seq_dnn.hidden_units)
    if hu:
      if hu[-1] != 1:
        raise ValueError(
            'sequence_features group %r: seq_dnn.hidden_units must end in '
            '1 (the attention score); got %s' % (scope, list(hu)))
      att_dims = hu[:-1]
  _add(owner, 'seq_dnn_%s' % scope,
       lambda: DinAttention(dh, att_dims, activation=act, **kw))
  need_key = group.need_key_feature and dq > 0
  return dh + sum(da) + (dh if need_key else 0)


def build_group_input(owner: nn.Module, ctx, group_name: str,
                      generator=None, device=None) -> int:
  """Build on `owner` everything group_input renders for `group_name`
  (once per group); returns the width of its output."""
  g = ctx.groups[group_name]
  width = build_flat_part(owner, ctx, ctx.group_features(group_name),
                           generator, device)
  for sg, scope in zip(g.sequence_features,
                       seq_scopes(group_name, g.sequence_features)):
    width += build_seq_att(owner, ctx, sg, scope, generator, device)
  return width


def seq_att_output(owner, ctx, group, batch, pulled, scope: str
                   ) -> torch.Tensor:
  """Attend one sequence_features sub-group -> [B, D_out]: its keys (or
  the history's masked mean) query the history with owner's
  seq_dnn_<scope>; the aux histories are weighted alike and follow; the
  key follows where need_key_feature holds. A key narrower than the
  history is zero-padded, any other mismatch (or transform_dnn) projects
  key and history by Dense layers."""
  query, hist, mask, aux = seq_group_tensors(ctx, group, batch, pulled)
  need_key = group.need_key_feature and query is not None
  if query is None:
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    query = (hist * mask[:, :, None]).sum(dim=1) / denom
  elif query.shape[-1] != hist.shape[-1]:
    if hist.shape[-1] > query.shape[-1] and not group.transform_dnn:
      query = torch.nn.functional.pad(
          query, (0, hist.shape[-1] - query.shape[-1]))
    else:
      query = getattr(owner, 'sequence_key_transform_%s' % scope)(query)
      hist = getattr(owner, 'sequence_fea_transform_%s' % scope)(hist)
  att = getattr(owner, 'seq_dnn_%s' % scope)(query, hist, mask,
                                             aux=tuple(aux))
  if need_key:
    return torch.cat([att, query], dim=1)
  return att


def group_input(owner, ctx, pulled, batch, group_name: str) -> torch.Tensor:
  """A group's input: its features' concatenation (sequences through
  their combiners), then each sequence_features sub-group attended, in
  that order."""
  x = ctx.input_layer.group_concat(pulled, batch,
                                   ctx.group_features(group_name),
                                   owner=owner)
  g = ctx.groups[group_name]
  parts = [x] + [
      seq_att_output(owner, ctx, sg, batch, pulled, scope)
      for sg, scope in zip(g.sequence_features,
                           seq_scopes(group_name, g.sequence_features))]
  return torch.cat(parts, dim=1) if len(parts) > 1 else x


def group_input_fn(owner, ctx, pulled, batch):
  """Memoised group_input: towers that share a feature group render it
  once."""
  cache = {}

  def gi(group_name: str) -> torch.Tensor:
    if group_name not in cache:
      cache[group_name] = group_input(owner, ctx, pulled, batch, group_name)
    return cache[group_name]

  return gi
