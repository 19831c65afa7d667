"""The port's combined table and its sparse update (easyrec_torch/ops/
packed_table.py, convert.py) against the JAX package's packed table: layout
round trip, the forward pull, and the plain versions of kernel K1
(segmented gradient sum) and K2 (row read-modify-write with compact Adam)
against the Pallas kernels run in interpret mode and the XLA path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.ops import kernels
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.optim.sparse import SparseAdam
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.optim import sparse as sparse_lib

BF16_ULP = 2.0 ** -7      # one bf16 unit in the last place, relative


def _moments(rng, rows, dim):
  m = (rng.standard_normal((rows, dim)) * 1e-3).astype(np.float32)
  v = (rng.random((rows, dim)) * 1e-4).astype(np.float32)
  return m, v


@pytest.mark.parametrize('rows,dim', [(1000, 16), (777, 32), (5, 8)])
def test_table_roundtrip_through_convert(rows, dim):
  rng = np.random.default_rng(rows)
  meta = jpt.PackMeta(rows, dim, 3, compact=True)
  w = rng.standard_normal((rows, dim)).astype(np.float32)
  m, v = _moments(rng, rows, dim)
  packed = jpt.pack_host(w, [m, v], meta)
  table = convert.jax_packed_to_table(packed, dim, rows)
  np.testing.assert_array_equal(table.view(np.uint32),
                                tpt.pack_host(w, m, v).view(np.uint32))
  tw, tm, tv = tpt.unpack_host(table)
  jw, (jm, jv) = jpt.unpack_host(packed, meta)
  for a, b in ((tw, jw), (tm, jm), (tv, jv)):
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
  back = convert.table_to_jax_packed(table, meta.phys_rows, meta.width)
  np.testing.assert_array_equal(back.view(np.uint32), packed.view(np.uint32))


def test_pull_matches_jax():
  rows, dim = 777, 32
  rng = np.random.default_rng(1)
  meta = jpt.PackMeta(rows, dim, 3, compact=True)
  w = rng.standard_normal((rows, dim)).astype(np.float32)
  m, v = _moments(rng, rows, dim)
  packed = jpt.pack_host(w, [m, v], meta)
  ids = rng.integers(0, rows, (4, 9))
  want = jpt.pull(jnp.asarray(packed), jnp.asarray(ids, jnp.int32), meta)
  got = tpt.pull(torch.from_numpy(convert.jax_packed_to_table(packed, dim,
                                                              rows)),
                 torch.from_numpy(ids), tpt.TableMeta(rows, dim))
  assert tuple(got.shape) == (4, 9, dim)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------- K1: segmented grad sum


def _jax_logical_sums(ugids, gg, meta):
  """JAX group_prep output -> {logical row: summed gradient}."""
  ugids, gg = np.asarray(ugids), np.asarray(gg, np.float32)
  pk, dim = meta.pack, meta.dim
  vec = gg[:, :, :pk * dim].reshape(len(ugids), 8, pk, dim)
  rows = (ugids[:, None, None] * meta.group_rows +
          np.arange(8)[None, :, None] * pk + np.arange(pk)[None, None, :])
  live = np.broadcast_to((ugids < meta.groups)[:, None, None], rows.shape)
  return dict(zip(rows[live].tolist(), vec[live]))


def _port_sums(ids, grads, mode, sentinel):
  sids, order, starts = tpt.sort_segments(torch.from_numpy(ids))
  uids, sums = tpt.seg_sum(sids, order, starts, torch.from_numpy(grads),
                           sentinel, mode)
  live = (uids != sentinel).numpy()
  return uids.numpy()[live], sums.numpy()[live]


def _ids_grads(rng, n, rows, dim, hot):
  ids = rng.integers(0, hot, n)            # heavy duplication
  grads = rng.standard_normal((n, dim)).astype(np.float32)
  return ids, grads


def test_seg_sum_plain_matches_pallas_interpret():
  """Sorted path of group_prep: _seg_sum_pallas in interpret mode (f32;
  its bf16 hi/lo split keeps ~2^-17 relative error, hence atol 2e-4 on
  sums of up to ~30 unit-normal rows)."""
  rows, dim, n = 10000, 16, 200
  meta = jpt.PackMeta(rows, dim, 3, compact=True)
  rng = np.random.default_rng(2)
  ids, grads = _ids_grads(rng, n, rows, dim, hot=40)
  ugids, gg = jpt.group_prep(jnp.asarray(ids, jnp.int32), jnp.asarray(grads),
                             meta, interpret=True)
  want = _jax_logical_sums(ugids, gg, meta)
  uids, sums = _port_sums(ids, grads, '0', rows)
  assert sorted(uids.tolist()) == sorted(set(ids.tolist()))
  for r, s in zip(uids.tolist(), sums):
    np.testing.assert_allclose(s, want[r], rtol=0, atol=2e-4)


@pytest.mark.parametrize('mode', ['0', 'mix', '1'])
def test_seg_sum_plain_matches_group_prep(mode, monkeypatch):
  """XLA segment_sum of group_prep, in each EASYREC_GG_BF16 mode. Modes 0
  and mix sum f32 in a possibly different order among equal ids (both
  sorts are unstable): atol 1e-5. Mode 1: JAX rounds the running sum to
  bf16 after every add, the port rounds its f32 sum once, so a segment of
  k rows may differ by k bf16 roundings of partial sums bounded by the
  sum of |rows|."""
  monkeypatch.setenv('EASYREC_GG_BF16', mode)
  rows, dim, n = 500, 16, 300
  meta = jpt.PackMeta(rows, dim, 3, compact=True)
  rng = np.random.default_rng(3)
  ids, grads = _ids_grads(rng, n, rows, dim, hot=rows)
  ids[:40] = 7                              # one hot id of 40 rows
  ugids, gg = jpt.group_prep(jnp.asarray(ids, jnp.int32), jnp.asarray(grads),
                             meta)
  want = _jax_logical_sums(ugids, gg, meta)
  uids, sums = _port_sums(ids, grads, mode, rows)
  payload = grads if mode == '0' else \
      tpt.bf16_round(torch.from_numpy(grads)).numpy()
  for r, s in zip(uids.tolist(), sums):
    if mode == '1':
      sel = ids == r
      bound = sel.sum() * BF16_ULP * np.abs(payload[sel]).sum(axis=0)
      assert np.all(np.abs(s - want[r]) <= bound), r
    else:
      np.testing.assert_allclose(s, want[r], rtol=0, atol=1e-5)


def test_seg_sum_plain_layout():
  """Unique ids at the head in ascending order, a sentinel tail, and zero
  rows on the tail: the static-capacity contract of the kernel."""
  ids = np.array([5, 3, 5, 9, 3, 3], np.int64)
  grads = np.arange(12, dtype=np.float32).reshape(6, 2)
  sids, order, starts = tpt.sort_segments(torch.from_numpy(ids))
  np.testing.assert_array_equal(starts.numpy(), [0, 3, 5, 6, 6, 6, 6])
  uids, sums = tpt.seg_sum(sids, order, starts, torch.from_numpy(grads),
                           99, '0')
  np.testing.assert_array_equal(uids.numpy(), [3, 5, 9, 99, 99, 99])
  np.testing.assert_array_equal(
      sums.numpy(), [[2 + 8 + 10, 3 + 9 + 11], [0 + 4, 1 + 5], [6, 7],
                     [0, 0], [0, 0], [0, 0]])


# -------------------------------------- K2: row RMW with compact Adam


def _update_ids(rng, rows, n, dup_at_most_two):
  if dup_at_most_two:
    base = rng.choice(rows - 10, size=n // 2 + 10, replace=False)
    ids = np.concatenate([base, base[:n - len(base)]])
  else:
    ids = rng.integers(0, 60, n)
  ids[:2] = rows - 5          # a cancelling pair: sums to exactly 0
  ids[2] = rows - 4           # a row whose only gradient is 0
  return ids


@pytest.mark.parametrize('rows,n,mode,dup2', [
    (500, 300, '0', False),    # sort-free group_prep, XLA segment_sum
    (500, 300, '1', True),     # bf16 sums; <= 2 rows per id (see below)
    (10000, 200, '0', False),  # sorted group_prep, Pallas segmented sum
])
def test_rmw_adam_plain_matches_pallas_interpret(rows, n, mode, dup2,
                                                 monkeypatch):
  """Two steps of the port's update against apply_packed_update with
  sparse_adam().compact_math and the _rmw_pallas kernel in interpret mode.

  Tolerances: w within 2e-7 (sums differ by f32 ordering or, on the
  sorted path, the Pallas segmented sum's ~2^-17 relative error; Adam
  scales that by lr 1e-2); m and v within one bf16 ulp (an f32 moment a
  hair from a bf16 rounding boundary may round the other way) or 1e-9,
  about one f32 ulp of the moments' operands (a near-cancelling
  b1*m + (1-b1)*g rounds differently where XLA contracts it into an
  FMA). With at
  most two rows per id, JAX's running bf16 sum rounds once, like the
  port's. Untouched rows, the cancelling pair's and the zero row's
  included, keep their bytes on both sides."""
  monkeypatch.setenv('EASYREC_GG_BF16', mode)
  dim = 16
  meta = jpt.PackMeta(rows, dim, 3, compact=True)
  tmeta = tpt.TableMeta(rows, dim)
  rng = np.random.default_rng(4)
  w0 = rng.standard_normal((rows, dim)).astype(np.float32) * 0.05
  m0, v0 = _moments(rng, rows, dim)
  packed = jnp.asarray(jpt.pack_host(w0, [m0, v0], meta))
  table = torch.from_numpy(tpt.pack_host(w0, m0, v0))
  orig = table.clone()
  j_opt, t_opt = sparse_lib.sparse_adam(), SparseAdam()
  seen = set()
  for step in range(2):
    ids = _update_ids(rng, rows, n, dup2)
    grads = (rng.standard_normal((n, dim)) * 1e-2).astype(np.float32)
    grads[:, 13:] = 0.0                    # alignment lanes
    grads[1] = -grads[0]
    grads[2] = 0.0
    seen.update(ids[3:].tolist())
    hyp = j_opt.hypers(jnp.float32(1e-2), jnp.int32(step))
    packed = jpt.apply_packed_update(
        packed, jnp.asarray(ids, jnp.int32), jnp.asarray(grads), hyp,
        j_opt.compact_math, meta, use_pallas=False, interpret=True)
    tpt.apply_packed_update(
        table, torch.from_numpy(ids), torch.from_numpy(grads),
        t_opt.hypers(torch.tensor(1e-2),
                     torch.tensor(step, dtype=torch.int32)),
        t_opt, tmeta)
  jw, (jm, jv) = jpt.unpack_host(np.asarray(packed), meta)
  tw, tm, tv = tpt.unpack_host(table.numpy())
  untouched = np.ones(rows, bool)
  untouched[list(seen)] = False
  assert untouched[rows - 5] and untouched[rows - 4]
  o = orig.numpy()
  for got, want, col in ((tw, jw, 0), (tm, jm, 1), (tv, jv, 2)):
    np.testing.assert_array_equal(got[untouched].view(np.uint32),
                                  want[untouched].view(np.uint32))
  np.testing.assert_array_equal(table.numpy()[untouched].view(np.uint32),
                                o[untouched].view(np.uint32))
  t = ~untouched
  np.testing.assert_allclose(tw[t], jw[t], rtol=0, atol=2e-7)
  np.testing.assert_allclose(tm[t], jm[t], rtol=BF16_ULP, atol=1e-9)
  np.testing.assert_allclose(tv[t], jv[t], rtol=BF16_ULP, atol=1e-9)
  assert np.mean(tm[t] == jm[t]) > 0.99 and np.mean(tv[t] == jv[t]) > 0.99


def test_rmw_adam_plain_repeats_compact_block():
  """The wrapper's plain path is SparseAdam.compact_block on the touched
  rows, in place, and the moments carry as bf16 pairs."""
  rng = np.random.default_rng(5)
  rows, dim = 6, 4
  w0 = rng.standard_normal((rows, dim)).astype(np.float32)
  m0, v0 = _moments(rng, rows, dim)
  table = torch.from_numpy(tpt.pack_host(w0, m0, v0))
  uids = torch.tensor([1, 4, 6, 6])                  # 6 = sentinel
  gsum = torch.from_numpy(rng.standard_normal((4, dim)).astype(np.float32))
  gsum[1] = 0.0                                      # row 4 untouched
  opt = SparseAdam()
  hyp = opt.hypers(torch.tensor(0.1), torch.tensor(0, dtype=torch.int32))
  before = table.clone()
  out = tpt.rmw_adam(table, uids, gsum, hyp, opt)
  assert out is table
  changed = (table != before).any(dim=1).numpy()
  np.testing.assert_array_equal(changed, [0, 1, 0, 0, 0, 0])
  w, mv = opt.compact_block(before[1:2, :dim], before[1:2, dim:], gsum[:1],
                            hyp)
  np.testing.assert_array_equal(table[1, :dim].numpy(), w[0].numpy())
  np.testing.assert_array_equal(table[1, dim:].view(torch.int32).numpy(),
                                mv[0].view(torch.int32).numpy())


def test_wrappers_take_plain_path_on_cpu_and_check_inputs():
  kernels.reset_launches()
  ids = torch.tensor([2, 0, 2])
  grads = torch.ones((3, 4))
  sids, order, starts = tpt.sort_segments(ids)
  uids, gsum = tpt.seg_sum(sids, order, starts, grads, 3)
  table = torch.zeros((3, 8))
  opt = SparseAdam()
  hyp = opt.hypers(torch.tensor(0.1), torch.tensor(0, dtype=torch.int32))
  tpt.rmw_adam(table, uids, gsum, hyp, opt)
  assert kernels.launch_counts() == {'seg_sum': 0, 'rmw_adam': 0,
                                     'rmw_fused_adam': 0}
  with pytest.raises(TypeError):
    tpt.seg_sum(sids, order, starts, grads.double(), 3)
  with pytest.raises(ValueError):
    tpt.seg_sum(sids, order, starts[:-1], grads, 3)
  with pytest.raises(ValueError):
    tpt.rmw_adam(torch.zeros((8, 3)).t(), uids, gsum, hyp, opt)
  with pytest.raises(ValueError):
    tpt.seg_sum(sids, order, starts, grads, 3, mode='bf16')
  with pytest.raises(NotImplementedError):
    tpt.rmw_adam(table, uids, gsum, hyp, sparse_lib.sparse_sgd())
