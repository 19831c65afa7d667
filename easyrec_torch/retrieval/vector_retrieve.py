"""Batch vector retrieval: the API and its CLI.

Counterpart of easyrec_tpu/retrieval/vector_retrieve.py (:1-102): a query
table searched against a document table by the exact index or the IVF
index of knn.py, on the device (CUDA unless --device cpu).

  python -m easyrec_torch.retrieval.vector_retrieve \
      --query_table q.csv --doc_table d.csv --knn_distance inner_product \
      --top_k 10 --output_table out.csv [--device cpu]

A table's rows are `id,v1|v2|...|vD` (both separators configurable); the
output has a header `query,doc,score` and top_k rows a query, best first.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from easyrec_torch.retrieval.knn import IvfIndex, KnnIndex


def read_embedding_table(path: str, delimiter: str = ',',
                         vector_sep: str = '|'):
  """(ids [N] object, embeddings [N, D] f32) of an id,vector file."""
  ids, vecs = [], []
  with open(path) as f:
    for line in f:
      line = line.strip()
      if not line:
        continue
      key, vec = line.split(delimiter, 1)
      ids.append(key)
      vecs.append(np.asarray(vec.replace(vector_sep, ' ').split(),
                             np.float64))
  return np.asarray(ids, object), np.stack(vecs).astype(np.float32)


class VectorRetrieve:
  """Query-batch top-k over a document embedding table: index_type
  'flat' is the exact index, 'ivf' the k-means IVF index."""

  def __init__(self, doc_ids, doc_embeddings, metric: str = 'ip',
               index_type: str = 'flat', n_clusters: int = 64,
               nprobe: int = 8, device=None):
    if index_type == 'ivf':
      self.index = IvfIndex(doc_embeddings, item_ids=doc_ids, metric=metric,
                            n_clusters=n_clusters, device=device)
      self._nprobe = nprobe
    else:
      self.index = KnnIndex(doc_embeddings, item_ids=doc_ids, metric=metric,
                            device=device)
      self._nprobe = None

  def search(self, query_embeddings, k: int):
    if self._nprobe is not None:
      return self.index.search_ids(query_embeddings, k, nprobe=self._nprobe)
    return self.index.search_ids(query_embeddings, k)


def main(argv=None) -> int:
  logging.basicConfig(level=logging.INFO)
  parser = argparse.ArgumentParser()
  parser.add_argument('--query_table', required=True)
  parser.add_argument('--doc_table', required=True)
  parser.add_argument('--output_table', required=True)
  parser.add_argument('--knn_distance', default='inner_product',
                      choices=['inner_product', 'l2', 'cosine'])
  parser.add_argument('--top_k', type=int, default=5)
  parser.add_argument('--attr_delimiter', default=',')
  parser.add_argument('--vector_sep', default='|')
  parser.add_argument('--index_type', default='flat',
                      choices=['flat', 'ivf'])
  parser.add_argument('--n_clusters', type=int, default=64)
  parser.add_argument('--nprobe', type=int, default=8)
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'")
  args = parser.parse_args(argv)

  metric = {'inner_product': 'ip', 'l2': 'l2', 'cosine': 'cos'}[
      args.knn_distance]
  doc_ids, doc_emb = read_embedding_table(args.doc_table,
                                          args.attr_delimiter,
                                          args.vector_sep)
  q_ids, q_emb = read_embedding_table(args.query_table,
                                      args.attr_delimiter, args.vector_sep)
  retr = VectorRetrieve(doc_ids, doc_emb, metric,
                        index_type=args.index_type,
                        n_clusters=args.n_clusters, nprobe=args.nprobe,
                        device=args.device)
  scores, ids = retr.search(q_emb, args.top_k)
  with open(args.output_table, 'w') as f:
    f.write('query,doc,score\n')
    for i, q in enumerate(q_ids):
      for j in range(ids.shape[1]):
        f.write('%s,%s,%.6f\n' % (q, ids[i, j], scores[i, j]))
  logging.info('wrote %s (%d queries x top-%d)', args.output_table,
               len(q_ids), args.top_k)
  return 0


if __name__ == '__main__':
  raise SystemExit(main())
