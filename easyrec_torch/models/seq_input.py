"""Group inputs. Counterpart of easyrec_tpu/models/seq_input.py
group_input (:110) on its non-sequence path: the plain embedding concat of
a feature group (sequence sub-groups are not ported)."""

from __future__ import annotations

import torch


def group_input(ctx, pulled, batch, group_name: str) -> torch.Tensor:
  if ctx.groups[group_name].sequence_features:
    raise NotImplementedError('sequence_features of group %s are not ported'
                              % group_name)
  return ctx.input_layer.group_concat(pulled, batch,
                                      ctx.group_features(group_name))


def group_width(ctx, group_name: str) -> int:
  """Feature width of group_input's output."""
  width = 0
  for f in ctx.group_features(group_name):
    spec = ctx.specs[f]
    width += spec.value_dim if spec.kind == 'dense' else spec.embedding_dim
  return width
