"""Exact and IVF top-k search over item embeddings.

Counterpart of easyrec_tpu/retrieval/knn.py: KnnIndex (:22-106),
topk_search and hitrate_at_k (:109-131), the k-means of _kmeans_fit
(:137-158) and IvfIndex (:161-253). The JAX index shards the corpus over
a mesh, takes a top-k per shard and merges them; on one device the
padding and the merge fall away, and a search is one [B, D] x [D, N] f32
GEMM and one torch.topk per query batch. In a world of processes
(parallel/mesh.py) a KnnIndex holds one block of the corpus a rank, as the
JAX index holds one a device (:66-106): each rank scores its rows and takes
a local top-k, the ranks all-gather their candidates, and every rank takes
the top-k of those, in sorted_topk's order. query_batch sizes the batch from
the corpus: a [B, N] f32 block of scores is B x N x 4 bytes, so B is the
largest power of two whose block fits SCORE_BLOCK_BYTES (1,024 queries
over 1,000,000 items), at most hitrate_at_k's 4,096. The scores are f32
sums as long as torch.backends.cuda.matmul.allow_tf32 stays False,
torch's default.

Results are what the JAX index returns: the top-k rows by score, best
first, rows of equal score lowest index first, also where rows tied at
the k-th score are left out (jax.lax.top_k's order; torch.topk fixes
none: sorted_topk restores it).

_kmeans_fit draws its initial centroids with jax.random.choice, which
torch cannot draw: kmeans_init draws other rows from a torch generator
seeded with `seed`, and IvfIndex takes `init_rows` to start from the JAX
draw; the Lloyd iterations are the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from easyrec_torch.device import resolve_device

METRICS = ('ip', 'cos', 'l2')
SCORE_BLOCK_BYTES = 1 << 32     # what a query batch's f32 blocks may hold
MAX_QUERY_BATCH = 4096


def query_batch(bytes_per_query: int) -> int:
  """The largest power of two of queries whose blocks of
  `bytes_per_query` each fit SCORE_BLOCK_BYTES, from 1 to
  MAX_QUERY_BATCH."""
  rows = max(1, SCORE_BLOCK_BYTES // max(int(bytes_per_query), 1))
  return min(MAX_QUERY_BATCH, 1 << (rows.bit_length() - 1))


def _normalize(x: torch.Tensor) -> torch.Tensor:
  return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                         min=1e-9)


def _as_f32(x, device) -> torch.Tensor:
  if isinstance(x, torch.Tensor):
    return x.to(device=device, dtype=torch.float32)
  return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def sorted_topk(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(values, indices) [B, k] of each row's k largest scores, by score
  descending and, among equal scores, index ascending, as jax.lax.top_k
  returns them. torch.topk fixes no order among ties, so it takes k + 1:
  where the (k+1)-th equals the k-th, the row's k-th score is tied with
  rows left out, and that row is taken again by index, the lowest of
  the tied rows first."""
  n = scores.shape[1]
  vals, idx = torch.topk(scores, min(k + 1, n), dim=1)
  if k < n:
    tied = torch.nonzero(vals[:, k] == vals[:, k - 1]).reshape(-1).tolist()
    vals, idx = vals[:, :k].clone(), idx[:, :k].clone()
    for r in tied:
      row, kth = scores[r], vals[r, k - 1]
      above = torch.nonzero(row > kth).reshape(-1)
      equal = torch.nonzero(row == kth).reshape(-1)[:k - above.numel()]
      idx[r] = torch.cat([above, equal])
      vals[r] = row[idx[r]]
  idx, perm = torch.sort(idx, dim=1)
  vals = torch.gather(vals, 1, perm)
  vals, perm = torch.sort(vals, dim=1, descending=True, stable=True)
  return vals, torch.gather(idx, 1, perm)


class KnnIndex:
  """Exact top-k index over item embeddings [N, D] on `device` (CUDA
  unless the caller asks for the CPU)."""

  def __init__(self, item_embeddings, item_ids: Optional[np.ndarray] = None,
               metric: str = 'ip', device=None, world=None):
    """world: a mesh.World whose ranks share the corpus; every rank passes
    the whole item_embeddings and keeps its block of rows (ceil(N / W)
    a rank)."""
    if metric not in METRICS:
      raise ValueError('metric %r: one of %s' % (metric, METRICS))
    self.world = world
    self.device = world.device if world is not None else \
        resolve_device(device)
    self.metric = metric
    emb = _as_f32(item_embeddings, self.device)
    self.row0 = 0
    if world is not None:
      per = -(-emb.shape[0] // world.size)
      self.row0 = min(world.rank * per, emb.shape[0])
      self.global_items = int(emb.shape[0])
      emb = emb[self.row0:self.row0 + per]
    if metric == 'cos':
      emb = _normalize(emb)
    self.embeddings = emb
    self.num_items = int(emb.shape[0]) if world is None else \
        self.global_items
    self.query_batch = query_batch(4 * self.num_items)
    self.ids = item_ids if item_ids is not None else np.arange(
        self.num_items)
    # argmin ||q - e||^2 == argmax (2 q.e - ||e||^2)
    self.sq = torch.sum(emb * emb, dim=1) if metric == 'l2' else None

  def scores(self, q: torch.Tensor) -> torch.Tensor:
    """[B, N] scores of device queries q [B, D]."""
    if self.metric == 'cos':
      q = _normalize(q)
    s = q @ self.embeddings.T
    if self.sq is not None:
      s = 2.0 * s - self.sq[None, :]
    return s

  def search_tensor(self, q: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, rows) [B, k] on the device for one batch of device
    queries; in a world, the merge of every rank's local top-k."""
    k = min(k, self.num_items)
    if self.world is None:
      return sorted_topk(self.scores(q), k)
    local = self.scores(q)
    n = local.shape[1]
    if n < k:
      # a block shorter than k: its missing candidates score -inf
      local = torch.cat([local, local.new_full((local.shape[0], k - n),
                                               float('-inf'))], dim=1)
    s, i = sorted_topk(local, k)
    i = i + self.row0
    cand_s = torch.cat(self.world.all_gather(s), dim=1)
    cand_i = torch.cat(self.world.all_gather(i), dim=1)
    # sorted_topk's order over the candidates: by score, then row
    cand_i, perm = torch.sort(cand_i, dim=1, stable=True)
    cand_s = torch.gather(cand_s, 1, perm)
    best, pos = torch.sort(cand_s, dim=1, descending=True, stable=True)
    return best[:, :k], torch.gather(cand_i, 1, pos[:, :k])

  def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(scores [B, k], row indices [B, k]) of the exact top-k."""
    q_all = _as_f32(queries, self.device)
    out_s, out_i = [], []
    for lo in range(0, q_all.shape[0], self.query_batch):
      s, i = self.search_tensor(q_all[lo:lo + self.query_batch], k)
      out_s.append(s.cpu())
      out_i.append(i.cpu())
    k = min(k, self.num_items)
    if not out_s:
      return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
    return torch.cat(out_s).numpy(), torch.cat(out_i).numpy()

  def search_ids(self, queries, k: int):
    scores, idx = self.search(queries, k)
    return scores, np.asarray(self.ids)[idx]


def topk_search(item_embeddings, queries, k: int, metric: str = 'ip',
                item_ids=None, device=None):
  """One-shot KnnIndex search: (scores, ids)."""
  index = KnnIndex(item_embeddings, item_ids=item_ids, metric=metric,
                   device=device)
  return index.search_ids(queries, k)


def hitrate_at_k(index, user_embeddings, true_item_rows: np.ndarray,
                 k: int, batch_size: int = 4096) -> dict:
  """The share of users whose true item row is among their top-k."""
  hits, total = 0, 0
  for lo in range(0, len(user_embeddings), batch_size):
    q = user_embeddings[lo:lo + batch_size]
    truth = np.asarray(true_item_rows[lo:lo + batch_size])
    _, idx = index.search(q, k)
    hits += int((idx == truth[:, None]).any(axis=1).sum())
    total += len(q)
  return {'hitrate@%d' % k: hits / max(total, 1), 'total': total,
          'hits': hits}


# ---------------------------------------------------------------------------
# IVF index (a k-means coarse quantizer and per-cluster buckets)
# ---------------------------------------------------------------------------


def kmeans_init(n: int, n_clusters: int, seed: int = 0) -> np.ndarray:
  """n_clusters distinct rows of n drawn from a torch generator seeded
  with `seed` (not the JAX package's draw; see the module docstring)."""
  gen = torch.Generator().manual_seed(int(seed))
  return torch.randperm(n, generator=gen)[:n_clusters].numpy()


def l2_assign(emb: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
  """Each row's nearest centroid: argmax (2 x.c - ||c||^2), the first of
  equal ones."""
  sq = torch.sum(centroids * centroids, dim=1)
  return torch.argmax(2.0 * emb @ centroids.T - sq[None, :], dim=1)


def kmeans_fit(emb: torch.Tensor, init_rows, n_iters: int
               ) -> torch.Tensor:
  """Lloyd's k-means from the rows `init_rows` of emb: n_iters rounds of
  L2 assignment and cluster means (a one-hot GEMM, as the JAX package
  sums them), an empty cluster keeping its centroid."""
  rows = torch.as_tensor(np.array(init_rows), dtype=torch.int64,
                         device=emb.device)
  c = emb[rows]
  for _ in range(int(n_iters)):
    one_hot = torch.nn.functional.one_hot(
        l2_assign(emb, c), c.shape[0]).to(emb.dtype)
    counts = one_hot.sum(dim=0)
    sums = one_hot.T @ emb
    new_c = sums / torch.clamp(counts[:, None], min=1.0)
    c = torch.where(counts[:, None] > 0, new_c, c)
  return c


class IvfIndex:
  """Approximate top-k: queries probe their nprobe nearest centroids (L2)
  and score only those clusters' members. Clusters are padded to the
  largest one's size; padded slots score -inf and come back as row -1
  where fewer than k members were probed. The probe gathers [B, nprobe,
  cap, D] candidates, so the index is for corpora well below the exact
  index's reach in memory, not for a 1,000,000-row corpus in 64
  clusters."""

  def __init__(self, item_embeddings, item_ids: Optional[np.ndarray] = None,
               metric: str = 'ip', n_clusters: int = 64, n_iters: int = 10,
               seed: int = 0, init_rows=None, device=None):
    if metric not in METRICS:
      raise ValueError('metric %r: one of %s' % (metric, METRICS))
    self.device = resolve_device(device)
    self.metric = metric
    emb = _as_f32(item_embeddings, self.device)
    n, d = emb.shape
    n_clusters = min(n_clusters, n)
    self.num_items = int(n)
    self.ids = item_ids if item_ids is not None else np.arange(n)
    if metric == 'cos':
      emb = _normalize(emb)
    if init_rows is None:
      init_rows = kmeans_init(n, n_clusters, seed)
    self.centroids = kmeans_fit(emb, init_rows, n_iters)
    assign = l2_assign(emb, self.centroids)
    counts = torch.bincount(assign, minlength=n_clusters)
    cap = max(int(counts.max()), 1)
    # members in row order within each cluster
    order = torch.sort(assign, stable=True).indices
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(n, device=self.device) - starts[assign[order]]
    self.buckets = torch.zeros((n_clusters, cap, d), device=self.device)
    self.bucket_rows = torch.full((n_clusters, cap), -1, dtype=torch.int64,
                                  device=self.device)
    self.buckets[assign[order], slot] = emb[order]
    self.bucket_rows[assign[order], slot] = order
    self.bucket_valid = self.bucket_rows >= 0

  def search_tensor(self, q: torch.Tensor, k: int, nprobe: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    if self.metric == 'cos':
      q = _normalize(q)
    c = self.centroids
    csq = torch.sum(c * c, dim=1)
    _, probe = sorted_topk(2.0 * q @ c.T - csq[None, :], nprobe)
    cand = self.buckets[probe]                          # [B, np, cap, D]
    rows = self.bucket_rows[probe]
    scores = torch.einsum('bd,bpcd->bpc', q, cand)
    if self.metric == 'l2':
      scores = 2.0 * scores - torch.sum(cand * cand, dim=-1)
    scores = torch.where(self.bucket_valid[probe], scores,
                         torch.full_like(scores, -float('inf')))
    b = scores.shape[0]
    best_s, pos = sorted_topk(scores.reshape(b, -1), k)
    return best_s, torch.gather(rows.reshape(b, -1), 1, pos)

  def search(self, queries, k: int, nprobe: int = 8
             ) -> Tuple[np.ndarray, np.ndarray]:
    """(scores, item rows); rows are -1 (score -inf) where fewer than k
    members fell inside the probed clusters."""
    nprobe = min(nprobe, self.centroids.shape[0])
    _, cap, d = self.buckets.shape
    k = min(k, self.num_items, nprobe * cap)
    # a query's gathered candidates [nprobe, cap, D] and their scores
    batch = query_batch(4 * nprobe * cap * (d + 1))
    q_all = _as_f32(queries, self.device)
    out_s, out_i = [], []
    for lo in range(0, q_all.shape[0], batch):
      s, i = self.search_tensor(q_all[lo:lo + batch], k, nprobe)
      out_s.append(s.cpu())
      out_i.append(i.cpu())
    if not out_s:
      return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
    return torch.cat(out_s).numpy(), torch.cat(out_i).numpy()

  def search_ids(self, queries, k: int, nprobe: int = 8):
    scores, idx = self.search(queries, k, nprobe)
    ids = np.where(idx >= 0, np.asarray(self.ids)[np.maximum(idx, 0)], -1)
    return scores, ids
