"""The port's fused sparse update, kernel K3 (easyrec_torch/ops/
packed_table.py rmw_fused_adam, csrc/rmw_fused_adam.cu), through its plain
version on the CPU: against the JAX package's _rmw_fused_pallas run in
interpret mode, against the port's own K1 + K2, the chunk map its wrapper
builds for the kernel, and the EASYREC_PACKED_FUSED dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyrec_torch.ops import kernels
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.ops.native_build import NVCC_FLAGS, NativeBuild
from easyrec_torch.optim.sparse import SparseAdam
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.optim import sparse as sparse_lib

BF16_ULP = 2.0 ** -7      # one bf16 unit in the last place, relative
C = tpt.FUSED_CHUNK


def _moments(rng, rows, dim):
  m = (rng.standard_normal((rows, dim)) * 1e-3).astype(np.float32)
  v = (rng.random((rows, dim)) * 1e-4).astype(np.float32)
  return m, v


def _step_ids(rng, rows, n):
  """Duplicated ids with one hot id of more than C slots, a cancelling
  pair (its row sums to exactly 0) and a row whose only gradient is 0."""
  ids = rng.integers(0, rows - 10, n)
  ids[3:3 + C + 44] = 17                    # 300 duplicates: two chunks
  ids[:2] = rows - 5
  ids[2] = rows - 4
  return ids


@pytest.mark.parametrize('dim', [16, 32])
def test_plain_matches_fused_pallas_interpret(dim, monkeypatch):
  """Two steps of the port's fused update against apply_packed_update with
  EASYREC_PACKED_FUSED=1, which runs _rmw_fused_pallas in interpret mode.

  Tolerances, with their reasons: the TPU kernel sums each f32 gradient
  as bf16 hi + lo (about 2^-16 relative per term, the allowance of
  tests/test_packed_table.py's fused parity test), the port in full f32,
  so the 300-slot segment's sum differs by up to ~300 * 2^-16 of its terms
  and the others by the f32 order of additions. Adam at lr 1e-2 scales a
  relative error of the sum into w by less than lr: w within 2e-6. m and v
  within one bf16 ulp (a moment a hair from a rounding boundary rounds the
  other way) or, where b1*m + (1-b1)*g nearly cancels, 2e-8: (1-b1) times
  the hi/lo error of a sum of a few 1e-2 terms (2^-16 of each). Untouched
  rows, the cancelling pair's and the zero row's included, keep their
  bytes on both sides."""
  monkeypatch.setenv('EASYREC_PACKED_FUSED', '1')
  rows, n = 300, 700
  meta = jpt.PackMeta(rows, dim, 3, compact=True)
  tmeta = tpt.TableMeta(rows, dim)
  rng = np.random.default_rng(dim)
  w0 = (rng.standard_normal((rows, dim)) * 0.05).astype(np.float32)
  m0, v0 = _moments(rng, rows, dim)
  packed = jnp.asarray(jpt.pack_host(w0, [m0, v0], meta))
  table = torch.from_numpy(tpt.pack_host(w0, m0, v0))
  orig = table.clone()
  j_opt, t_opt = sparse_lib.sparse_adam(), SparseAdam()
  seen = set()
  kernels.reset_launches()
  for step in range(2):
    ids = _step_ids(rng, rows, n)
    grads = (rng.standard_normal((n, dim)) * 1e-2).astype(np.float32)
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
  assert kernels.launch_counts()['rmw_fused_adam'] == 0     # CPU: plain
  jw, (jm, jv) = jpt.unpack_host(np.asarray(packed), meta, rows)
  tw, tm, tv = tpt.unpack_host(table.numpy())
  untouched = np.ones(rows, bool)
  untouched[list(seen)] = False
  assert untouched[rows - 5] and untouched[rows - 4]
  for got, want in ((tw, jw), (tm, jm), (tv, jv)):
    np.testing.assert_array_equal(got[untouched].view(np.uint32),
                                  want[untouched].view(np.uint32))
  np.testing.assert_array_equal(table.numpy()[untouched].view(np.uint32),
                                orig.numpy()[untouched].view(np.uint32))
  t = ~untouched
  np.testing.assert_allclose(tw[t], jw[t], rtol=0, atol=2e-6)
  np.testing.assert_allclose(tm[t], jm[t], rtol=BF16_ULP, atol=2e-8)
  np.testing.assert_allclose(tv[t], jv[t], rtol=BF16_ULP, atol=2e-8)
  assert np.mean(tm[t] == jm[t]) > 0.99 and np.mean(tv[t] == jv[t]) > 0.99
  assert not np.array_equal(tw[17], w0[17])


def _port_update(ids, grads, table, step, fused):
  opt = SparseAdam()
  hyp = opt.hypers(torch.tensor(1e-2), torch.tensor(step, dtype=torch.int32))
  sids, order, starts = tpt.sort_segments(torch.from_numpy(ids))
  g = torch.from_numpy(grads)
  if fused:
    tpt.rmw_fused_adam(table, sids, order, starts, g, hyp, opt)
  else:
    uids, gsum = tpt.seg_sum(sids, order, starts, g, table.shape[0], '0')
    tpt.rmw_adam(table, uids, gsum, hyp, opt)


@pytest.mark.parametrize('hot', [C, 5 * C + 3])
def test_plain_against_k1_k2_plain(hot):
  """Against K1 (mode 0, f32) followed by K2: where no segment is longer
  than the chunk, the same f32 additions in the same order, so the tables
  are bit-equal; a longer segment adds its chunk sums in chunk order
  instead of slot by slot, so its row differs by f32 rounding only (w
  within 1e-7, 1e-2 of lr; m and v within one bf16 ulp)."""
  rows, dim, n = 400, 16, 2000
  rng = np.random.default_rng(hot)
  w0 = (rng.standard_normal((rows, dim)) * 0.05).astype(np.float32)
  m0, v0 = _moments(rng, rows, dim)
  tables = [torch.from_numpy(tpt.pack_host(w0, m0, v0)) for _ in range(2)]
  for step in range(2):
    ids = rng.integers(0, rows, n)
    ids[ids == 11] = 12
    ids[:hot] = 11                          # exactly `hot` slots of id 11
    grads = rng.standard_normal((n, dim)).astype(np.float32)
    for fused, table in zip((True, False), tables):
      _port_update(ids, grads, table, step, fused)
  a, b = tables[0].numpy(), tables[1].numpy()
  if hot <= C:
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    return
  same = (a.view(np.uint32) == b.view(np.uint32)).all(axis=1)
  assert same.sum() == rows - 1 and not same[11]
  aw, am, av = tpt.unpack_host(a)
  bw, bm, bv = tpt.unpack_host(b)
  np.testing.assert_allclose(aw, bw, rtol=0, atol=1e-7)
  np.testing.assert_allclose(am, bm, rtol=BF16_ULP, atol=0)
  np.testing.assert_allclose(av, bv, rtol=BF16_ULP, atol=0)


def test_plain_order_of_additions():
  """The plain version's sums are the two-level tree the kernel runs: each
  chunk of C sorted slots from 0 in slot order, then 0 + chunk sums in
  chunk order; an unused segment and an id outside the table change
  nothing."""
  rows, dim = 10, 2
  n = 2 * C + 40
  ids = np.full(n, 3)
  ids[-7:] = 5
  ids[-1] = rows                               # outside the table
  rng = np.random.default_rng(1)
  grads = rng.standard_normal((n, dim)).astype(np.float32) * \
      np.float32(1e3) ** rng.integers(-2, 3, (n, 1)).astype(np.float32)
  sids, order, starts = tpt.sort_segments(torch.from_numpy(ids))
  sums = tpt.segment_sums_by_chunk(order, starts, torch.from_numpy(grads))
  o = order.numpy()
  g = grads[o[:n - 7]]                         # id 3's rows in slot order
  want = np.float32(0)
  for lo in range(0, g.shape[0], C):
    part = np.zeros(dim, np.float32)
    for row in g[lo:lo + C]:
      part = (part + row).astype(np.float32)
    want = (want + part).astype(np.float32)
  np.testing.assert_array_equal(sums[0].numpy(), want)
  table = torch.zeros((rows, 2 * dim))
  opt = SparseAdam()
  tpt.rmw_fused_adam(table, sids, order, starts, torch.from_numpy(grads),
                     opt.hypers(torch.tensor(0.1),
                                torch.tensor(0, dtype=torch.int32)), opt)
  changed = (table != 0).any(dim=1).numpy()
  np.testing.assert_array_equal(np.nonzero(changed)[0], [3, 5])


@pytest.mark.parametrize('lens', [[1, 2, 3], [C + 1], [700, 3, C, 2 * C + 1],
                                  [3000]])
def test_chunk_map_gives_long_segments_their_chunk_slots(lens):
  """fused_chunk_map, which the CUDA wrapper builds on the device: every
  segment longer than C owns ceil(len / C) consecutive chunk slots from
  chunk_base, chunk_seg names it on each of them, and the slot count
  bound covers the input."""
  ids = np.repeat(np.arange(len(lens)), lens)
  n = ids.shape[0]
  _, _, starts = tpt.sort_segments(torch.from_numpy(ids))
  chunk_seg, base, n_chunks = tpt.fused_chunk_map(starts, n)
  assert n_chunks == 2 * n // C + 1 and chunk_seg.shape == (n_chunks,)
  want = np.full(n_chunks, -1)
  nxt = 0
  for k, length in enumerate(lens):
    if length > C:
      nch = -(-length // C)
      assert int(base[k]) == nxt
      want[nxt:nxt + nch] = k
      nxt += nch
  assert nxt <= n_chunks
  got = chunk_seg.numpy()
  np.testing.assert_array_equal(got[:nxt], want[:nxt])
  # slots past the last chunk keep the last long segment (the kernel skips
  # them: their chunk starts past the segment's end) or -1
  assert np.all(got[nxt:] == (want[nxt - 1] if nxt else -1))


@pytest.mark.parametrize('env,fused', [(None, False), ('0', False),
                                       ('1', True), ('true', False)])
def test_apply_packed_update_dispatch(env, fused, monkeypatch):
  """EASYREC_PACKED_FUSED keeps the JAX package's meaning: '1' takes K3,
  anything else K1 then K2."""
  if env is None:
    monkeypatch.delenv('EASYREC_PACKED_FUSED', raising=False)
  else:
    monkeypatch.setenv('EASYREC_PACKED_FUSED', env)
  calls = []
  for name in ('rmw_fused_adam', 'seg_sum', 'rmw_adam'):
    real = getattr(tpt, name)
    monkeypatch.setattr(tpt, name,
                        lambda *a, _n=name, _f=real, **k:
                        calls.append(_n) or _f(*a, **k))
  meta = tpt.TableMeta(20, 4)
  opt = SparseAdam()
  tpt.apply_packed_update(
      torch.zeros((20, 8)), torch.tensor([[1, 2], [2, 3]]),
      torch.ones((2, 2, 4)),
      opt.hypers(torch.tensor(0.1), torch.tensor(0, dtype=torch.int32)),
      opt, meta)
  assert calls == (['rmw_fused_adam'] if fused else ['seg_sum', 'rmw_adam'])


def test_wrapper_checks_inputs():
  ids = torch.tensor([2, 0, 2])
  grads = torch.ones((3, 4))
  sids, order, starts = tpt.sort_segments(ids)
  table = torch.zeros((3, 8))
  opt = SparseAdam()
  hyp = opt.hypers(torch.tensor(0.1), torch.tensor(0, dtype=torch.int32))
  with pytest.raises(TypeError):
    tpt.rmw_fused_adam(table, sids, order, starts, grads.double(), hyp, opt)
  with pytest.raises(ValueError):
    tpt.rmw_fused_adam(table, sids, order, starts[:-1], grads, hyp, opt)
  with pytest.raises(ValueError):
    tpt.rmw_fused_adam(torch.zeros((8, 3)).t(), sids, order, starts, grads,
                       hyp, opt)
  with pytest.raises(NotImplementedError):
    tpt.rmw_fused_adam(table, sids, order, starts, grads, hyp,
                       sparse_lib.sparse_sgd())


def test_build_key_covers_the_shared_adam_header(tmp_path):
  """K2 and K3 take their Adam from one header, compact_adam.cuh, and a
  library is named by a hash that covers the headers its source includes
  by a quoted path: a changed header builds both kernels anew, so a stale
  copy of the update is never loaded. A quoted include that does not lie
  beside the source is left to the compiler's search path."""
  for k in (kernels.RMW_ADAM, kernels.RMW_FUSED_ADAM):
    with open(k.source) as f:
      assert '#include "compact_adam.cuh"' in f.read()
  src, hdr = tmp_path / 'k.cu', tmp_path / 'h.cuh'
  src.write_text('#include <cstdint>\n#include "h.cuh"\n'
                 '#include "absent.h"\n')
  hdr.write_text('// one\n')
  first = NativeBuild(str(src), ['nvcc'], NVCC_FLAGS).path
  assert NativeBuild(str(src), ['nvcc'], NVCC_FLAGS).path == first
  hdr.write_text('// two\n')
  assert NativeBuild(str(src), ['nvcc'], NVCC_FLAGS).path != first
