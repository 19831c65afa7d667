"""The port's packed-group benchmark modules (easyrec_torch/benchmarks/)
and the sparse helpers they need (easyrec_torch/optim/sparse.py dedup_sum
and SparseAdam.update_rows) against the JAX package's benchmarks/
bench_packed_v2.py, bench_packed_stages.py, experimental_packed_update.py
and easyrec_tpu/optim/sparse.py, on the CPU, from the same numpy inputs.

experimental_packed_update.py cannot be imported (its `from __future__`
line follows a second docstring), so it is executed here from its source
with that line removed. It needs an optimizer with `update_parts` and a
meta with `combined_cols`, which the JAX package does not define: both
sides get the same stubs below.

Tolerances, each with its reason:
- geometry, packing, the forward gather, group_prep and every gather or
  copy: exact (one nonzero term a sum, or no arithmetic at all);
- dedup_sum: exact (both add in sorted slot order on the CPU);
- the Adam and SGD math: 1e-6 absolute on O(1) data. XLA on the CPU may
  contract a product and a sum into one fused multiply-add and computes
  pow and sqrt with its own routines; the port rounds every op
  separately. The JAX script's own limit (bench_packed_v2.py:292) is
  1e-5; the measured difference at check_parity's sizes is at most 3e-8.
  The Adam tests also hold each side to a float64 evaluation of the same
  formula within 1e-6 (both measure 6.9e-7: the f32 rounding of w + upd),
  so a side that moves is named.
"""

import functools
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks import bench_packed_v2 as j_v2
from easyrec_torch.benchmarks import bench_packed_stages as t_stages
from easyrec_torch.benchmarks import bench_packed_v2 as t_v2
from easyrec_torch.benchmarks import experimental_packed_update as t_xp
from easyrec_torch.optim import sparse as t_sparse
from easyrec_tpu.optim import sparse as j_sparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6
DIMS = [16, 1, 8]


def _t(x):
  return torch.from_numpy(np.array(x))


def _adam_f64(w, m, v, ids, g, scratch, lr, step, b1=0.9, b2=0.999,
              eps=1e-8):
  """Lazy Adam of dedup_sum + update_rows in float64: the rows `ids`
  names, the scratch row excluded, move; the others keep their values."""
  w, m, v = (np.array(x, np.float64) for x in (w, m, v))
  sums = {}
  for i, r in enumerate(np.asarray(ids).tolist()):
    sums[r] = sums.get(r, 0.0) + np.asarray(g[i], np.float64)
  t = step + 1
  for r, gs in sums.items():
    if r == scratch:
      continue
    m[r] = b1 * m[r] + (1 - b1) * gs
    v[r] = b2 * v[r] + (1 - b2) * gs * gs
    w[r] = w[r] - lr * (m[r] / (1 - b1 ** t)) / (
        np.sqrt(v[r] / (1 - b2 ** t)) + eps)
  return w, m, v


def _close(got, want, what):
  np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                             atol=ATOL, err_msg=what)


def _parity_inputs(dim):
  """check_parity's inputs (bench_packed_v2.py:262-269)."""
  rows, n_ids = 4096, 777
  rng = np.random.RandomState(0)
  w = rng.randn(rows, dim).astype(np.float32)
  ids = rng.randint(0, rows, n_ids).astype(np.int32)
  g = rng.randn(n_ids, dim).astype(np.float32)
  ids[:50] = ids[50:100]
  return rows, w, ids, g


# ------------------------------------------------------ bench_packed_v2

@pytest.mark.parametrize('dim', DIMS + [3, 128, 48])
def test_pack_meta_geometry(dim):
  j, t = j_v2.PackMeta(26_000_000, dim), t_v2.PackMeta(26_000_000, dim)
  assert vars(j) == vars(t)


@pytest.mark.parametrize('dim', DIMS)
def test_pack_forward_and_group_prep_match(dim):
  """pack_table_host, phys_rows, fwd_packed, group_prep and take_groups,
  exact, at check_parity's sizes."""
  rows, w, ids, g = _parity_inputs(dim)
  jm, tm = j_v2.PackMeta(rows, dim), t_v2.PackMeta(rows, dim)
  packed = j_v2.pack_table_host(w, jm)
  assert np.array_equal(t_v2.pack_table_host(w, tm), packed)
  jp, jl = j_v2.phys_rows(jnp.asarray(ids), jm)
  tp, tl = t_v2.phys_rows(_t(ids), tm)
  assert np.array_equal(tp.numpy(), jp) and np.array_equal(tl.numpy(), jl)
  tmat = t_v2._lane_gather_matrix(tm)
  assert np.array_equal(tmat.numpy(), j_v2._lane_gather_matrix(jm))
  jf = j_v2.fwd_packed(jnp.asarray(packed), jnp.asarray(ids), jm,
                       j_v2._lane_gather_matrix(jm))
  tf = t_v2.fwd_packed(_t(packed), _t(ids), tm, tmat)
  assert np.array_equal(tf.numpy(), jf)
  assert np.array_equal(tf.numpy(), w[ids])
  uids, ug = j_sparse.dedup_sum(jnp.asarray(ids), jnp.asarray(g), jm.scratch)
  j_out = j_v2.group_prep(uids, ug, jm)
  t_out = t_v2.group_prep(_t(uids), _t(ug), tm)
  for a, b in zip(t_out, j_out):
    assert np.array_equal(a.numpy(), np.asarray(b))
  jg = j_v2.take_groups(jnp.asarray(packed), j_out[0], jm)
  tg = t_v2.take_groups(_t(packed), t_out[0], tm)
  assert np.array_equal(tg.numpy(), jg)


@pytest.mark.parametrize('dim', DIMS)
def test_adam_updates_match(dim):
  """adam_update_plain and adam_update_packed (the port's through
  group_push_plain, JAX's through its XLA write-back, use_pallas=False as
  its check_parity runs on the CPU): w, m and v of each side within ATOL
  of the float64 formula, then of each other."""
  rows, w, ids, g = _parity_inputs(dim)
  jm, tm = j_v2.PackMeta(rows, dim), t_v2.PackMeta(rows, dim)
  lr_j, step_j = jnp.float32(0.1), jnp.int32(3)
  lr_t, step_t = torch.tensor(0.1), torch.tensor(3, dtype=torch.int32)
  zeros = np.zeros_like(w)
  ref = _adam_f64(w, zeros, zeros, ids, g, rows - 1, np.float32(0.1), 3)
  want = j_v2.adam_update_plain(jnp.asarray(w), jnp.asarray(zeros),
                                jnp.asarray(zeros), jnp.asarray(ids),
                                jnp.asarray(g), rows - 1, lr_j, step_j)
  got = t_v2.adam_update_plain(_t(w), _t(zeros), _t(zeros), _t(ids), _t(g),
                               rows - 1, lr_t, step_t)
  for name, a, b, r in zip('wmv', got, want, ref):
    _close(a.numpy(), r, 'port plain %s against float64' % name)
    _close(b, r, 'JAX plain %s against float64' % name)
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL)
  packed = j_v2.pack_table_host(w, jm)
  pz = np.zeros_like(packed)
  want = j_v2.adam_update_packed(jnp.asarray(packed), jnp.asarray(pz),
                                 jnp.asarray(pz), jnp.asarray(ids),
                                 jnp.asarray(g), jm, lr_j, step_j,
                                 use_pallas=False)
  got = t_v2.adam_update_packed(_t(packed), _t(pz), _t(pz), _t(ids), _t(g),
                                tm, lr_t, step_t)
  for name, a, b, r in zip('wmv', got, want, ref):
    _close(t_v2.fwd_packed(a, _t(np.arange(rows - 1)), tm,
                           t_v2._lane_gather_matrix(tm)).numpy(),
           r[:rows - 1], 'port packed %s against float64' % name)
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL)


def test_packed_v2_and_stages_mains_on_cpu(capsys):
  """Both scripts end to end at a small size: every correctness line
  true, check_parity at dims 16, 1 and 8 included."""
  out = t_v2.main(['--device', 'cpu', '--rows', '70000', '--ids', '2048',
                   '--iters', '1'])
  assert out['correct'] and set(out) >= {'deep', 'wide'}
  out = t_stages.main(['--device', 'cpu', '--rows', '70000', '--ids',
                       '2048', '--iters', '1'])
  assert out['correct'] and {'push', 'rmw', 'dedup_sum'} <= set(out['ms'])
  assert 'correct=False' not in capsys.readouterr().out


# ------------------------------------------------------- sparse helpers

@pytest.mark.parametrize('dtype', [np.int32, np.int64])
def test_dedup_sum_matches(dtype):
  rng = np.random.default_rng(3)
  ids = rng.integers(0, 60, 300).astype(dtype)
  g = rng.standard_normal((300, 4)).astype(np.float32)
  ju, jg = j_sparse.dedup_sum(jnp.asarray(ids), jnp.asarray(g), 99)
  tu, tg = t_sparse.dedup_sum(_t(ids), _t(g), 99)
  assert tu.dtype == torch.from_numpy(ids).dtype
  assert np.array_equal(tu.numpy(), ju)
  assert np.array_equal(tg.numpy(), jg)


@pytest.mark.parametrize('weight_decay', [0.0, 0.01])
def test_update_rows_matches(weight_decay):
  """Two steps of separate-array lazy Adam from nonzero moments, with
  duplicate scratch slots of zero gradient; w, m and v within ATOL."""
  rng = np.random.default_rng(4)
  rows, dim = 50, 8
  w = rng.standard_normal((rows, dim)).astype(np.float32)
  m = (rng.standard_normal((rows, dim)) * 1e-2).astype(np.float32)
  v = (rng.random((rows, dim)) * 1e-3).astype(np.float32)
  j_opt = j_sparse.sparse_adam(weight_decay=weight_decay)
  t_opt = t_sparse.SparseAdam(weight_decay=weight_decay)
  jt, jst = jnp.asarray(w), {'m': jnp.asarray(m), 'v': jnp.asarray(v)}
  tt, tst = _t(w), {'m': _t(m), 'v': _t(v)}
  for step in range(2):
    ids = rng.integers(0, rows - 1, 40).astype(np.int32)
    g = rng.standard_normal((40, dim)).astype(np.float32)
    uids, ug = j_sparse.dedup_sum(jnp.asarray(ids), jnp.asarray(g),
                                  rows - 1)
    jt, jst = j_opt.update_rows(jt, jst, uids, ug, jnp.float32(1e-2),
                                jnp.int32(step))
    tt, tst = t_opt.update_rows(tt, tst, _t(uids), _t(ug),
                                torch.tensor(1e-2),
                                torch.tensor(step, dtype=torch.int32))
  np.testing.assert_allclose(tt.numpy(), jt, rtol=0, atol=ATOL)
  for k in ('m', 'v'):
    np.testing.assert_allclose(tst[k].numpy(), jst[k], rtol=0, atol=ATOL)


# -------------------------------------------- experimental_packed_update

class StubMeta:
  """A FusedTable-like geometry: `dim` weight columns plus two slots a
  logical row (combined_cols = 3*dim), pack*combined_cols = 384 lanes."""

  def __init__(self, rows, dim):
    self.rows, self.dim, self.combined_cols = rows, dim, 3 * dim
    self.pack = 384 // self.combined_cols
    self.width = self.pack * self.combined_cols
    self.group_rows = 8 * self.pack
    self.groups = rows // self.group_rows + 2
    self.scratch = (self.groups - 1) * self.group_rows


class StubOptimizer:
  """update_parts for both sides: lazy SGD on the weights, the slots
  decayed toward the gradient (works on jax and torch arrays alike)."""

  def update_parts(self, w, slots, g, lr, step):
    return w - lr * g, [0.9 * s + 0.1 * g for s in slots]


@pytest.fixture(scope='module')
def j_xp():
  path = os.path.join(REPO, 'benchmarks', 'experimental_packed_update.py')
  with open(path) as f:
    src = f.read()
  line = 'from __future__ import annotations\n'
  assert line in src
  mod = types.ModuleType('experimental_packed_update')
  exec(compile(src.replace(line, ''), path, 'exec'), mod.__dict__)
  return mod


def _xp_inputs(dim, seed=0):
  meta = StubMeta(3000, dim)
  rng = np.random.default_rng(seed)
  table = rng.standard_normal((meta.groups, 8, meta.width)).astype(
      np.float32)
  ids = rng.integers(0, meta.rows, 400).astype(np.int32)
  g = rng.standard_normal((400, dim)).astype(np.float32)
  g[::9] = 0.0
  uids, ug = j_sparse.dedup_sum(jnp.asarray(ids), jnp.asarray(g),
                                meta.scratch)
  return meta, table, np.asarray(uids), np.asarray(ug)


@pytest.mark.parametrize('dim', [16, 8])
def test_experimental_prep_columns_and_update_match(j_xp, dim):
  """_group_prep (exact), _part_columns (exact), _take_groups (exact),
  _update_groups and _xla_apply (within ATOL) against the JAX module,
  with the same stub optimizer and meta."""
  meta, table, uids, ug = _xp_inputs(dim)
  jg, jgg = j_xp._group_prep(jnp.asarray(uids), jnp.asarray(ug), meta)
  tg, tgg = t_xp._group_prep(_t(uids), _t(ug), meta)
  assert np.array_equal(tg.numpy(), jg)
  assert np.array_equal(tgg.numpy(), jgg)
  for a, b in zip(t_xp._part_columns(meta), j_xp._part_columns(meta)):
    assert len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))
  rows = t_xp._take_groups(_t(table), tg, meta)
  assert np.array_equal(rows.numpy(),
                        j_xp._take_groups(jnp.asarray(table), jg, meta))
  opt = StubOptimizer()
  want = j_xp._update_groups(jnp.asarray(rows.numpy()), jgg, opt, 0.1, 0,
                             meta)
  got = t_xp._update_groups(rows, tgg, opt, 0.1, 0, meta)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
  want = j_xp._xla_apply(jnp.asarray(table), jg, jgg, opt, 0.1, 0, meta)
  got = t_xp._plain_apply(_t(table), tg, tgg, opt, 0.1, 0, meta)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
  # the write-back through group_push (plain on the CPU) equals index_copy_
  ref = t_xp._plain_apply(_t(table), *t_xp._group_prep(_t(uids), _t(ug),
                                                       meta),
                          opt, 0.1, 0, meta)
  out = t_xp.apply_group_updates(_t(table), _t(uids), _t(ug), opt, 0.1, 0,
                                 meta)
  assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def test_kernel_apply_matches_pallas_apply(j_xp, monkeypatch):
  """_pallas_apply in interpret mode vs the port's _kernel_apply (K4's
  plain version on the CPU), both with _update_groups stubbed to return
  the same new rows: byte-equal over the whole table, the chunk padding
  with the scratch group's current bytes included."""
  monkeypatch.setattr(pl, 'pallas_call',
                      functools.partial(pl.pallas_call, interpret=True))
  meta, table, uids, ug = _xp_inputs(16, seed=1)
  jg, jgg = j_xp._group_prep(jnp.asarray(uids), jnp.asarray(ug), meta)
  tg, tgg = t_xp._group_prep(_t(uids), _t(ug), meta)
  rng = np.random.default_rng(2)
  new = rng.standard_normal((len(uids), 8, meta.width)).astype(np.float32)
  # the dedup tail names the scratch group: it carries its current bytes
  new[np.asarray(jg) == meta.groups - 1] = table[-1]
  monkeypatch.setattr(j_xp, '_update_groups',
                      lambda *a: jnp.asarray(new))
  monkeypatch.setattr(t_xp, '_update_groups', lambda *a: _t(new))
  want = j_xp._pallas_apply(jnp.asarray(table), jg, jgg, None, 0.1, 0, meta)
  got = t_xp._kernel_apply(_t(table), tg, tgg, None, 0.1, 0, meta)
  assert np.array_equal(got.numpy().view(np.int32),
                        np.asarray(want).view(np.int32))
