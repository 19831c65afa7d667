"""Plain reference of the Criteo DeepFM (alibaba/EasyRec
examples/configs/deepfm_on_criteo.config; the model of EasyRec's
model/deepfm.py).

Every feature (13 raw values, 26 ids) has a deep embedding of `dim` and a
wide one of `wide_dim`; a raw feature's one row is scaled by its value.
The logit is final_dnn over [the summed wide terms, the FM's second-order
term over the deep embeddings (0.5 ((sum x)^2 - sum x^2), per column),
the deep DNN over the concatenated embeddings], then one dense unit. Every
DNN layer is Dense, BatchNorm, relu. The loss is the mean sigmoid cross
entropy. Parameter names are those the port's model gives the same
leaves, so the harness can hand both the same initial weights.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from recbench.reference import common


def param_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
  feats = model['features']
  dim = feats[0]['dim']
  wide = feats[0].get('wide_dim', 0)
  shapes, deep_out = common.mlp_shapes('dnn', model['dnn'],
                                       len(feats) * dim)
  final, final_out = common.mlp_shapes('final_dnn', model['final_dnn'],
                                       wide + dim + deep_out)
  shapes.update(final)
  shapes['logits.weight'] = (1, final_out)
  shapes['logits.bias'] = (1,)
  return shapes


def model_loss(model: dict, params, emb, batch) -> torch.Tensor:
  feats = model['features']
  deep = [common.pooled(emb[(f['name'], 'deep')], batch, f['name'])
          for f in feats]
  wide = None
  for f in feats:
    term = common.pooled(emb[(f['name'], 'wide')], batch, f['name'])
    wide = term if wide is None else wide + term
  x = torch.stack(deep, dim=1)
  s = x.sum(dim=1)
  fm = 0.5 * (s * s - (x * x).sum(dim=1))
  h = common.mlp(torch.cat(deep, dim=1), params, 'dnn', model['dnn'])
  h = common.mlp(torch.cat([wide, fm, h], dim=1), params, 'final_dnn',
                 model['final_dnn'])
  logits = common.dense(h, params, 'logits')[:, 0]
  return common.sigmoid_ce(logits, batch['label.%s' % model['label']],
                           batch['sample_weight'])


def flops_per_example(model: dict) -> float:
  """Forward operations of one example: the DNNs' products and the FM."""
  feats = model['features']
  dim = feats[0]['dim']
  wide = feats[0].get('wide_dim', 0)
  deep = model['dnn']
  return (common.mlp_flops(deep, len(feats) * dim) +
          common.mlp_flops(model['final_dnn'] + [1],
                           wide + dim + deep[-1]) +
          3.0 * len(feats) * dim)
