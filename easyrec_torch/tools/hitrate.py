"""Hitrate of a trained match model on its eval data.

Counterpart of easyrec_tpu/tools/hitrate.py (:21-102): model_dir's latest
checkpoint restored into a Trainer on the device (CUDA unless --device
cpu), the eval rows embedded by the user and item towers (the model in
eval mode on its live parameters, as the JAX tool applies state.params),
the corpus the DISTINCT eval items (rows of the item embeddings rounded to
6 decimals, np.unique; a row's truth is its item's corpus row), and
hitrate@k of every valid eval row over an exact KnnIndex (inner product).

  python -m easyrec_torch.tools.hitrate \
      --pipeline_config_path cfg --top_k 10 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np
import torch


@torch.no_grad()
def embed_eval_rows(trainer, max_batches: int = 0):
  """(user embeddings, item embeddings) [R, D] of the valid rows of the
  trainer's eval input, from its model in eval mode."""
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.train.trainer import to_device
  trainer.model.eval()
  users, items = [], []
  for n, batch in enumerate(trainer.eval_input(), 1):
    dev = to_device(batch, trainer.device)
    packs = emb_ops.pack_all_views(trainer.layout, dev)
    pulled = emb_ops.pull_embeddings(trainer.tables, packs, trainer.metas)
    out = trainer.model(dev, pulled)
    valid = np.asarray(batch['sample_weight']) > 0
    users.append(out['user_tower_emb'].cpu().numpy()[valid])
    items.append(out['item_tower_emb'].cpu().numpy()[valid])
    if max_batches and n >= max_batches:
      break
  return np.concatenate(users), np.concatenate(items)


def compute_hitrate(pipeline_config, top_k: int = 10, max_batches: int = 0,
                    device=None) -> dict:
  """hitrate@top_k of each eval row's item among the distinct eval
  items; the result also holds `total`, `hits` and `corpus_size`."""
  from easyrec_torch.main import _restored_trainer
  from easyrec_torch.retrieval.knn import KnnIndex, hitrate_at_k
  trainer = _restored_trainer(pipeline_config, device)
  user_emb, item_emb = embed_eval_rows(trainer, max_batches)
  corpus, truth = np.unique(item_emb.round(6), axis=0, return_inverse=True)
  index = KnnIndex(corpus, metric='ip', device=trainer.device)
  result = hitrate_at_k(index, user_emb, truth.reshape(-1), top_k)
  result['corpus_size'] = int(len(corpus))
  logging.info('hitrate: %s', result)
  return result


def main(argv=None) -> int:
  logging.basicConfig(level=logging.INFO)
  parser = argparse.ArgumentParser()
  parser.add_argument('--pipeline_config_path', required=True)
  parser.add_argument('--top_k', type=int, default=10)
  parser.add_argument('--max_batches', type=int, default=0)
  parser.add_argument('--output_path', default=None)
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'")
  args = parser.parse_args(argv)
  from easyrec_torch.config import config_util
  config = config_util.get_configs_from_pipeline_file(
      args.pipeline_config_path)
  result = compute_hitrate(config, args.top_k, args.max_batches,
                           device=args.device)
  print(json.dumps(result))
  if args.output_path:
    with open(args.output_path, 'w') as f:
      json.dump(result, f)
  return 0


if __name__ == '__main__':
  raise SystemExit(main())
