"""Plain reference of the DLRM-DCNv2 (MLPerf Training recommendation_v2,
torchrec_dlrm's DLRM_DCN; Wang et al., "DCN V2", WWW 2021), as the port
runs it: a RankModel whose backbone holds the bottom MLP, the Cross and
the top MLP.

The bottom MLP (Dense with bias, relu after every layer) runs over the
dense values, which reach the model with no table (feat.dense.dense).
Each id feature's bag is sum-pooled with its weights. x0 = [bottom
output, the 26 pooled bags] goes through the low-rank cross layers,
x_{l+1} = x0 * (V_l (U_l x_l) + b_l) + x_l, then the top MLP (relu after
every layer) and one dense unit; the loss is the mean sigmoid cross
entropy. Parameter names are those the port's model gives the same
leaves.

Plain float32 torch with TF32 off (common.no_tf32, which the harness
sets); it imports nothing of the port. Where it departs from the source,
it departs as the configuration's `assumed` says, on both sides:
  - Adam (common.Reference: dense Adam, lazy Adam on the touched rows
    with the moments held at bf16) in place of the source's Adagrad;
  - tables drawn normal(0, init_std) (recbench/weights.py) in place of
    the source's uniform in +-1/sqrt(rows);
  - the dense values reach the bottom MLP as the batch holds them: the
    source log-transforms them in its preprocessing, and the port's
    RawFeature has no such transform;
  - one card's share of four: the tables of 1M rows or more hold a
    quarter of their rows, and nothing is exchanged between cards.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from recbench.reference import common

BOTTOM = 'backbone.main.bottom_l0'
CROSS = 'backbone.main.cross_l0.CrossNetV2_0'
TOP = 'backbone.top_mlp'


def _parts(model: dict):
  """(dense values, id features, their width in x0)."""
  feats = model['features']
  dense = sum(int(f['value_dim']) for f in feats if f['kind'] == 'dense')
  ids = common.table_features(feats)
  return dense, ids, model['bottom_mlp'][-1] + sum(f['dim'] for f in ids)


def param_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
  dense, _, width = _parts(model)
  shapes, _ = common.mlp_shapes(BOTTOM, model['bottom_mlp'], dense,
                                bn=False)
  rank = model['cross']['projection_dim']
  for i in range(model['cross']['num_layers']):
    shapes['%s.u_%d.weight' % (CROSS, i)] = (rank, width)
    shapes['%s.v_%d.weight' % (CROSS, i)] = (width, rank)
    shapes['%s.v_%d.bias' % (CROSS, i)] = (width,)
  top, out = common.mlp_shapes(TOP, model['top_mlp'], width, bn=False)
  shapes.update(top)
  shapes['logits.weight'] = (1, out)
  shapes['logits.bias'] = (1,)
  return shapes


def model_loss(model: dict, params, emb, batch) -> torch.Tensor:
  feats = model['features']
  values = torch.cat([batch['feat.%s.dense' % f['name']] for f in feats
                      if f['kind'] == 'dense'], dim=1)
  bottom = common.mlp(values, params, BOTTOM, model['bottom_mlp'], bn=False)
  x0 = torch.cat([bottom] + [common.pooled(emb[(f['name'], 'deep')], batch,
                                           f['name'])
                             for f in common.table_features(feats)], dim=1)
  x = x0
  for i in range(model['cross']['num_layers']):
    u = x @ params['%s.u_%d.weight' % (CROSS, i)].T
    x = x0 * common.dense(u, params, '%s.v_%d' % (CROSS, i)) + x
  h = common.mlp(x, params, TOP, model['top_mlp'], bn=False)
  logits = common.dense(h, params, 'logits')[:, 0]
  return common.sigmoid_ce(logits, batch['label.%s' % model['label']],
                           batch['sample_weight'])


def cross_flops_per_example(model: dict) -> float:
  """Forward operations of one example in the cross layers: each layer's
  two products (U_l x_l, then V_l of it: 2 W R each), the bias, the
  product with x0 and the sum with x_l (W each), over x0's width W and
  the rank R."""
  _, _, width = _parts(model)
  rank = model['cross']['projection_dim']
  return model['cross']['num_layers'] * (4.0 * width * rank + 3.0 * width)


def flops_per_example(model: dict) -> float:
  """Forward operations of one example: the MLPs', the cross layers' two
  products and the logit's, the cross layers' elementwise product and
  sum, and the bags' pooling."""
  dense, ids, width = _parts(model)
  return (common.mlp_flops(model['bottom_mlp'], dense) +
          cross_flops_per_example(model) +
          common.mlp_flops(model['top_mlp'] + [1], width) +
          2.0 * sum(f['dim'] * int(f.get('max_len', 1)) for f in ids))
