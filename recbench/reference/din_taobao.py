"""Plain reference of the Taobao MultiTowerDIN (alibaba/EasyRec
examples/configs/din_on_taobao.config; the models of EasyRec's
model/multi_tower_din.py and layers/din, after Zhou et al., "Deep
Interest Network for Click-Through Rate Prediction", KDD 2018).

The user and the item tower are DNNs (Dense, BatchNorm, relu) over their
features' concatenated embeddings. The DIN tower's query is the target's
keys' embeddings concatenated ([brand, cate_id]); its history the two
behaviour sequences' embeddings, each zeroed past its length, concatenated
per position; a position counts where either history has it. An MLP
without BatchNorm (relu, the last layer linear) scores [q, h, q - h, q * h]
at every position, a softmax over the counted positions weighs the
history, and the tower gives [that weighted sum, the query]. final_dnn
runs over [user, item, DIN tower], then one dense unit; the loss is the
mean sigmoid cross entropy. Parameter names are those the port's model
gives the same leaves.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from recbench.reference import common


def _dims(model: dict) -> Dict[str, int]:
  return {f['name']: int(f['dim']) for f in model['features']}


def param_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
  dims = _dims(model)
  shapes, width = {}, 0
  for tower, names in model['towers'].items():
    s, out = common.mlp_shapes('tower_%s' % tower, model['tower_dnn'],
                               sum(dims[n] for n in names))
    shapes.update(s)
    width += out
  hist = sum(dims[h] for h in model['din']['hists'])
  s, _ = common.mlp_shapes('din_din.att_dnn', model['din']['att_dnn'],
                           4 * hist, bn=False)
  shapes.update(s)
  width += hist + sum(dims[k] for k in model['din']['keys'])
  s, out = common.mlp_shapes('final_dnn', model['final_dnn'], width)
  shapes.update(s)
  shapes['logits.weight'] = (1, out)
  shapes['logits.bias'] = (1,)
  return shapes


def model_loss(model: dict, params, emb, batch) -> torch.Tensor:
  outs = []
  for tower, names in model['towers'].items():
    x = torch.cat([common.pooled(emb[(n, 'deep')], batch, n)
                   for n in names], dim=1)
    outs.append(common.mlp(x, params, 'tower_%s' % tower,
                           model['tower_dnn']))
  din = model['din']
  query = torch.cat([common.pooled(emb[(k, 'deep')], batch, k)
                     for k in din['keys']], dim=1)
  masks = [batch['feat.%s.mask' % h] for h in din['hists']]
  hist = torch.cat([emb[(h, 'deep')] * m[:, :, None]
                    for h, m in zip(din['hists'], masks)], dim=2)
  mask = torch.stack(masks).amax(dim=0)
  q = query[:, None, :].expand_as(hist)
  att_in = torch.cat([q, hist, q - hist, q * hist], dim=2)
  scores = common.mlp(att_in, params, 'din_din.att_dnn', din['att_dnn'],
                      bn=False, last_relu=False)[:, :, 0]
  scores = scores.masked_fill(mask <= 0, float('-inf'))
  weights = torch.softmax(scores, dim=1)
  outs.append(torch.cat([torch.einsum('bl,bld->bd', weights, hist), query],
                        dim=1))
  h = common.mlp(torch.cat(outs, dim=1), params, 'final_dnn',
                 model['final_dnn'])
  logits = common.dense(h, params, 'logits')[:, 0]
  return common.sigmoid_ce(logits, batch['label.%s' % model['label']],
                           batch['sample_weight'])


def flops_per_example(model: dict) -> float:
  """Forward operations of one example: the towers', the attention MLP's
  at every position and the final DNN's products, the attention's
  elementwise inputs and its weighted sum."""
  dims = _dims(model)
  din = model['din']
  length = max(f.get('max_len', 1) for f in model['features']
               if f['name'] in din['hists'])
  hist = sum(dims[h] for h in din['hists'])
  towers = sum(common.mlp_flops(model['tower_dnn'],
                                sum(dims[n] for n in names))
               for names in model['towers'].values())
  attention = length * (common.mlp_flops(din['att_dnn'], 4 * hist) +
                        4.0 * hist)
  width = len(model['towers']) * model['tower_dnn'][-1] + hist + \
      sum(dims[k] for k in din['keys'])
  return towers + attention + common.mlp_flops(
      model['final_dnn'] + [1], width)
