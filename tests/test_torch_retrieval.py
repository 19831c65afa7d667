"""Retrieval after a match model against the JAX package on the CPU: the
exact KnnIndex (ip, cos, l2; odd sizes, string ids, query batches), the
IvfIndex from the JAX initial draw (centroids, buckets, search ids),
hitrate_at_k, the vector_retrieve CLI's output file, split_export's
metas, the split exports' Predictor answers, and compute_hitrate on a
small DSSM from one state. Inputs are made from a seed with numpy; the
JAX side runs as tests/test_retrieval.py and
tests/test_seq_split_online.py run it."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from easyrec_torch.config import config_util as t_config
from easyrec_torch.export import saved_model as t_sm
from easyrec_torch.export.predictor import Predictor as TPredictor
from easyrec_torch.retrieval import knn as t_knn
from easyrec_torch.retrieval import vector_retrieve as t_vr
from easyrec_torch.tools import hitrate as t_hitrate
from easyrec_torch.tools import split_model as t_split
from easyrec_torch.train import checkpoints as t_ckpt
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_tpu.retrieval import knn as j_knn
from tests.test_torch_match import jax_batches, sample_configs

def _close(got, want):
  """Scores within 1e-5 relative of their scale (an l2 score 2 q.e -
  ||e||^2 cancels terms of its rows' largest size), -inf where -inf."""
  fin = np.isfinite(want)
  np.testing.assert_array_equal(np.isfinite(got), fin)
  scale = np.abs(want[fin]).max() if fin.any() else 1.0
  np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                             atol=1e-5 * scale)


def _corpus(seed, n=1003, d=16, b=37):
  rng = np.random.default_rng(seed)
  return (rng.normal(size=(n, d)).astype(np.float32),
          rng.normal(size=(b, d)).astype(np.float32))


@pytest.mark.parametrize('metric', ['ip', 'cos', 'l2'])
def test_knn_matches_jax(metric, monkeypatch):
  """Scores within 1e-5 relative and ids equal, with string ids over a
  corpus of 1,003 rows (not a multiple of the JAX mesh's 8 devices); the
  port's query batches of 4 rows (a score budget of 7 queries' blocks)
  give the ids one batch gives and its scores to f32 rounding (the CPU's
  GEMM rounds a [4, D] block otherwise than a [37, D] one); and the ids
  are those of a float64 numpy ranking."""
  items, queries = _corpus(1)
  ids = np.array(['item_%d' % i for i in range(len(items))], object)
  j_s, j_ids = j_knn.KnnIndex(items, item_ids=ids,
                              metric=metric).search_ids(queries, 10)
  index = t_knn.KnnIndex(items, item_ids=ids, metric=metric, device='cpu')
  t_s, t_ids = index.search_ids(queries, 10)
  _close(t_s, j_s)
  np.testing.assert_array_equal(t_ids, j_ids)
  monkeypatch.setattr(t_knn, 'SCORE_BLOCK_BYTES', 7 * 4 * len(items))
  small = t_knn.KnnIndex(items, item_ids=ids, metric=metric, device='cpu')
  assert small.query_batch == 4 and index.query_batch == 4096
  s7, ids7 = small.search_ids(queries, 10)
  np.testing.assert_array_equal(ids7, t_ids)
  _close(s7, t_s)
  q, e = queries.astype(np.float64), items.astype(np.float64)
  if metric == 'cos':
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    e = e / np.linalg.norm(e, axis=1, keepdims=True)
  ref = q @ e.T
  if metric == 'l2':
    ref = 2 * ref - np.sum(e * e, axis=1)[None, :]
  np.testing.assert_array_equal(t_ids, ids[np.argsort(-ref, axis=1)[:, :10]])
  # k beyond the corpus is clamped to it
  s_all, _ = t_knn.KnnIndex(items[:5], metric=metric,
                            device='cpu').search(queries, 10)
  assert s_all.shape == (len(queries), 5)


def test_knn_ties_lowest_index_first():
  """Rows of equal score inside the top-k come lowest index first, as
  jax.lax.top_k orders them."""
  # 48 rows, 6 a device of the JAX mesh (its top_k runs per shard)
  items = np.repeat(np.eye(4, dtype=np.float32), 12, axis=0)
  q = np.array([[1, 0.5, 0, 0], [0, 0, 0, 1]], np.float32)
  j_s, j_i = j_knn.KnnIndex(items).search(q, 5)
  t_s, t_i = t_knn.KnnIndex(items, device='cpu').search(q, 5)
  np.testing.assert_array_equal(t_i, j_i)
  np.testing.assert_array_equal(t_s, j_s)
  assert list(t_i[0]) == [0, 1, 2, 3, 4]
  assert list(t_i[1]) == [36, 37, 38, 39, 40]


def _jax_draw(n, n_clusters, seed=0):
  return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                      (n_clusters,), replace=False))


@pytest.mark.parametrize('metric', ['ip', 'cos', 'l2'])
def test_ivf_matches_jax_from_its_draw(metric, monkeypatch):
  """From the JAX initial draw: centroids within 1e-5, the same buckets
  (each cluster's rows in row order, so the same assignments), the same
  search ids at nprobe 4 and at every cluster, where the IVF equals the
  exact index, in query batches of a few rows (a 64 KiB budget for their
  gathered candidates); a k past the probed pool is clamped and padded
  with row -1 at -inf."""
  rng = np.random.default_rng(2)
  centers = rng.normal(size=(8, 12)) * 3
  items = (centers[rng.integers(0, 8, 601)] +
           rng.normal(size=(601, 12))).astype(np.float32)
  queries = (centers[rng.integers(0, 8, 29)] +
             rng.normal(size=(29, 12))).astype(np.float32)
  j_ivf = j_knn.IvfIndex(items, metric=metric, n_clusters=16, n_iters=6)
  t_ivf = t_knn.IvfIndex(items, metric=metric, n_clusters=16, n_iters=6,
                         init_rows=_jax_draw(601, 16), device='cpu')
  monkeypatch.setattr(t_knn, 'SCORE_BLOCK_BYTES', 1 << 16)
  np.testing.assert_allclose(t_ivf.centroids.numpy(),
                             np.asarray(j_ivf.centroids), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_array_equal(t_ivf.bucket_rows.numpy(),
                                np.asarray(j_ivf.bucket_rows))
  for nprobe in (4, 16):
    j_s, j_i = j_ivf.search_ids(queries, 10, nprobe=nprobe)
    t_s, t_i = t_ivf.search_ids(queries, 10, nprobe=nprobe)
    np.testing.assert_array_equal(t_i, j_i)
    _close(t_s, j_s)
  _, exact = t_knn.KnnIndex(items, metric=metric,
                            device='cpu').search(queries, 10)
  np.testing.assert_array_equal(t_ivf.search(queries, 10, nprobe=16)[1],
                                exact)
  few = items[:40]
  j_few = j_knn.IvfIndex(few, metric=metric, n_clusters=10, n_iters=3)
  t_few = t_knn.IvfIndex(few, metric=metric, n_clusters=10, n_iters=3,
                         init_rows=_jax_draw(40, 10), device='cpu')
  j_s, j_r = j_few.search(queries, 5000, nprobe=2)
  t_s, t_r = t_few.search(queries, 5000, nprobe=2)
  np.testing.assert_array_equal(t_r, j_r)
  _close(t_s, j_s)
  assert (t_r < 0).any() and np.all(np.isneginf(t_s[t_r < 0]))


def test_query_batch_from_the_corpus():
  """The largest power of two of queries whose f32 blocks fit 4 GiB, at
  most 4,096: 1,024 queries over 1,000,000 items, 4,096 over a small
  corpus, one query where a single block passes the budget."""
  assert t_knn.query_batch(4 * 1000000) == 1024
  assert t_knn.query_batch(4 * 1003) == 4096
  assert t_knn.query_batch(4 * 64 * 1000 * 65) == 256
  assert t_knn.query_batch(5 << 30) == 1


def test_ivf_own_draw_is_seeded():
  items, queries = _corpus(3, n=300, d=8)
  a = t_knn.IvfIndex(items, n_clusters=12, n_iters=4, seed=5, device='cpu')
  b = t_knn.IvfIndex(items, n_clusters=12, n_iters=4, seed=5, device='cpu')
  np.testing.assert_array_equal(a.centroids.numpy(), b.centroids.numpy())
  np.testing.assert_array_equal(a.search(queries, 5, nprobe=12)[1],
                                t_knn.KnnIndex(items, device='cpu')
                                .search(queries, 5)[1])


def test_hitrate_at_k_matches_jax():
  rng = np.random.default_rng(4)
  items = rng.normal(size=(500, 16)).astype(np.float32)
  queries = items + rng.normal(scale=0.5, size=items.shape).astype(
      np.float32)
  truth = np.arange(500)
  for k in (1, 5, 50):
    want = j_knn.hitrate_at_k(j_knn.KnnIndex(items), queries, truth, k,
                              batch_size=128)
    got = t_knn.hitrate_at_k(t_knn.KnnIndex(items, device='cpu'), queries,
                             truth, k, batch_size=128)
    assert got == want
  assert 0.3 < want['hitrate@50'] <= 1.0


def _write_table(path, names, vecs):
  with open(path, 'w') as f:
    for name, v in zip(names, vecs):
      f.write('%s,%s\n' % (name, '|'.join('%.5f' % x for x in v)))


def _same_output(got_path, want_path, lines):
  want = open(want_path).read().splitlines()
  got = open(got_path).read().splitlines()
  assert len(want) == len(got) == lines and got[0] == want[0]
  split = [[line.rsplit(',', 1) for line in x[1:]] for x in (got, want)]
  assert [a for a, _ in split[0]] == [a for a, _ in split[1]]
  _close(np.array([float(b) for _, b in split[0]]),
         np.array([float(b) for _, b in split[1]]))


@pytest.mark.parametrize('distance', ['inner_product', 'cosine', 'l2'])
def test_vector_retrieve_cli_matches_jax(distance, tmp_path):
  """The CLI's output file against the JAX CLI's: the same header and
  query and doc columns, the scores (printed to 6 decimals) within 1e-5
  of their scale; an IVF probing every cluster writes the flat index's
  file."""
  from easyrec_tpu.retrieval import vector_retrieve as j_vr
  docs, queries = _corpus(5, n=211, d=8, b=13)
  doc_path, q_path = str(tmp_path / 'docs.csv'), str(tmp_path / 'q.csv')
  _write_table(doc_path, ['d%d' % i for i in range(len(docs))], docs)
  _write_table(q_path, ['q%d' % i for i in range(len(queries))], queries)
  args = ['--query_table', q_path, '--doc_table', doc_path, '--top_k', '7',
          '--knn_distance', distance]
  j_vr.main(args + ['--output_table', str(tmp_path / 'j.csv')])
  assert t_vr.main(args + ['--output_table', str(tmp_path / 't.csv'),
                           '--device', 'cpu']) == 0
  _same_output(tmp_path / 't.csv', tmp_path / 'j.csv', 1 + 13 * 7)
  t_vr.main(args + ['--output_table', str(tmp_path / 'ivf.csv'),
                    '--index_type', 'ivf', '--n_clusters', '6',
                    '--nprobe', '6', '--device', 'cpu'])
  _same_output(tmp_path / 'ivf.csv', tmp_path / 'j.csv', 1 + 13 * 7)
  ids, emb = t_vr.read_embedding_table(doc_path)
  j_ids, j_emb = j_vr.read_embedding_table(doc_path)
  np.testing.assert_array_equal(emb, j_emb)
  assert list(ids) == list(j_ids)


# ---------------------------------------------------------------------------
# the split exports and compute_hitrate on a small DSSM from one state
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def dssm(tmp_path_factory):
  """A small dssm_neg_sampler (tests/test_torch_match.py's cut: hash
  buckets 1,000, batch 32) in one state on both sides: the JAX Trainer's
  initial state, carried into the port's Trainer; each side's export
  and a checkpoint of that state in a model_dir of its own."""
  from easyrec_tpu.export import saved_model as j_sm
  from easyrec_tpu.train import checkpoints as j_ckpt
  from easyrec_tpu.train.trainer import Trainer as JTrainer
  from tests.test_torch_match_train import _carry_state
  old = os.environ.get('EASYREC_PACKED_TABLES')
  os.environ['EASYREC_PACKED_TABLES'] = '1'
  try:
    tmp = tmp_path_factory.mktemp('dssm')
    t_cfg, j_cfg = sample_configs('dssm_neg_sampler', str(tmp))
    jt = JTrainer(j_cfg, devices=jax.devices('cpu')[:1])
    state = jt.init_state(jax_batches(j_cfg, 1)[0])
    tt = TTrainer(t_cfg, device='cpu')
    _carry_state(jt, state, tt)
    j_exp = j_sm.export_saved_model(jt, state, str(tmp / 'j_export'))
    t_exp = t_sm.export_saved_model(tt, str(tmp / 't_export'))
    j_cfg.model_dir, t_cfg.model_dir = str(tmp / 'j_md'), str(tmp / 't_md')
    j_ckpt.CheckpointManager(j_cfg.model_dir,
                             layout_stamp=jt.layout_stamp()).save(state, 1)
    t_ckpt.CheckpointManager(t_cfg.model_dir,
                             layout_stamp=tt.layout_stamp()).save(
                                 tt.state_dict(), 1)
    yield dict(tmp=tmp, t_cfg=t_cfg, j_cfg=j_cfg, j_exp=j_exp, t_exp=t_exp,
               tt=tt)
  finally:
    if old is None:
      os.environ.pop('EASYREC_PACKED_TABLES', None)
    else:
      os.environ['EASYREC_PACKED_TABLES'] = old


def test_split_export_metas_match_jax(dssm):
  from easyrec_tpu.tools.split_model import split_export as j_split
  j_out = j_split(dssm['j_exp'], str(dssm['tmp'] / 'j_split'))
  t_out = t_split.split_export(dssm['t_exp'], str(dssm['tmp'] / 't_split'),
                               device='cpu')
  assert sorted(t_out) == sorted(j_out) == ['item', 'user']
  for tower in ('user', 'item'):
    j_meta = json.load(open(os.path.join(j_out[tower], 'export_meta.json')))
    t_meta = json.load(open(os.path.join(t_out[tower], 'export_meta.json')))
    for key in ('tower', 'outputs', 'inputs', 'required_columns',
                'model_class'):
      assert t_meta[key] == j_meta[key], (tower, key)
  assert t_meta['outputs'] == ['item_emb']
  assert t_meta['required_columns'] == ['cate', 'iid', 'price']


def test_split_exports_answer_the_full_exports_tower_outputs(dssm):
  """Each tower's Predictor, fed only its own columns, answers its
  embedding and nothing else, equal to the full export's answer on every
  column; the CLI splits and checks the towers too."""
  from easyrec_torch.tools.split_model import main as split_main
  out_dir = str(dssm['tmp'] / 'cli_split')
  assert split_main(['--export_dir', dssm['t_exp'], '--output_dir',
                     out_dir, '--device', 'cpu']) == 0
  full = TPredictor(dssm['t_exp'], device='cpu', batch_size=16)
  rows = [line.rstrip('\n').split(',') for line in
          open(os.path.join(str(dssm['tmp']), 'train.csv'))][:40]
  cols = [f.input_name for f in dssm['t_cfg'].data_config.input_fields]
  columns = {c: np.array([r[i] for r in rows], object)
             for i, c in enumerate(cols)}
  want = full.predict_columns(columns)
  for tower, out in (('user', 'user_emb'), ('item', 'item_emb')):
    pred = TPredictor(os.path.join(out_dir, tower), device='cpu',
                      batch_size=16)
    own = {c: columns[c] for c in pred.meta['required_columns']}
    got = pred.predict_columns(own)
    assert sorted(got) == [out]
    np.testing.assert_array_equal(got[out], want[out])


def test_compute_hitrate_matches_jax(dssm):
  """hitrate@k of the eval rows among the distinct eval items, from one
  state restored from each side's checkpoint: equal hits, total and
  corpus; the CLI prints the same."""
  from easyrec_tpu.tools.hitrate import compute_hitrate as j_hitrate
  for k in (1, 10):
    want = j_hitrate(dssm['j_cfg'], top_k=k)
    got = t_hitrate.compute_hitrate(dssm['t_cfg'], top_k=k, device='cpu')
    assert got == want, k
  t_config.save_pipeline_config(dssm['t_cfg'], str(dssm['tmp']), 'h.config')
  out = str(dssm['tmp'] / 'hitrate.json')
  assert t_hitrate.main(['--pipeline_config_path',
                         str(dssm['tmp'] / 'h.config'), '--top_k', '10',
                         '--device', 'cpu', '--output_path', out]) == 0
  assert json.load(open(out)) == want


def test_retrieval_entry_points_default_to_cuda(tmp_path):
  """Without --device cpu every new entry point asks for CUDA, which
  raises where it is missing."""
  from tests import fixtures
  if torch.cuda.is_available():
    pytest.skip('CUDA is present: the default device is taken')
  items, queries = _corpus(6, n=20, d=4, b=3)
  for make in (lambda: t_knn.KnnIndex(items),
               lambda: t_knn.IvfIndex(items, n_clusters=2),
               lambda: t_vr.VectorRetrieve(np.arange(20), items)):
    with pytest.raises(RuntimeError, match='cuda'):
      make()
  doc_path, q_path = str(tmp_path / 'docs.csv'), str(tmp_path / 'q.csv')
  _write_table(doc_path, range(20), items)
  _write_table(q_path, range(3), queries)
  cfg_path = fixtures.write_pipeline(tmp_path)
  for main, argv in ((t_vr.main, ['--query_table', q_path, '--doc_table',
                                  doc_path, '--output_table',
                                  str(tmp_path / 'o.csv')]),
                     (t_split.main, ['--export_dir', str(tmp_path),
                                     '--output_dir', str(tmp_path / 'o')]),
                     (t_hitrate.main, ['--pipeline_config_path', cfg_path])):
    with pytest.raises(RuntimeError, match='cuda'):
      main(argv)
