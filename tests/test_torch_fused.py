"""The port's fused sparse update, kernel K3 (easyrec_torch/ops/
packed_table.py rmw_fused, csrc/rmw_fused.cu), through its plain version on
the CPU: against the JAX package's _rmw_fused_pallas run in interpret mode
(compact Adam here; Adagrad and FTRL in test_torch_optim.py), against the
port's own K1 + K2, the chunk map its wrapper builds for the kernel, and
the EASYREC_PACKED_FUSED dispatch."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyrec_torch.ops import kernels
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.ops.native_build import (NVCC_FLAGS, NativeBuild,
                                            hash_sources)
from easyrec_torch.optim.sparse import SparseAdam
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.optim import sparse as sparse_lib

BF16_ULP = 2.0 ** -7      # one bf16 unit in the last place, relative
C = tpt.FUSED_CHUNK


def _moments(rng, rows, dim):
  m = (rng.standard_normal((rows, dim)) * 1e-3).astype(np.float32)
  v = (rng.random((rows, dim)) * 1e-4).astype(np.float32)
  return m, v


def _tmeta(rows, dim):
  """The port's compact Adam layout."""
  return tpt.TableMeta(rows, dim, 3, compact=True)


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
  tmeta = _tmeta(rows, dim)
  rng = np.random.default_rng(dim)
  w0 = (rng.standard_normal((rows, dim)) * 0.05).astype(np.float32)
  m0, v0 = _moments(rng, rows, dim)
  packed = jnp.asarray(jpt.pack_host(w0, [m0, v0], meta))
  table = torch.from_numpy(tpt.pack_host(w0, [m0, v0], tmeta))
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
  assert kernels.launch_counts()['rmw_fused'] == 0     # CPU: plain
  jw, (jm, jv) = jpt.unpack_host(np.asarray(packed), meta, rows)
  tw, (tm, tv) = tpt.unpack_host(table.numpy(), tmeta)
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
    tpt.rmw_fused(table, sids, order, starts, g, hyp, opt)
  else:
    uids, gsum = tpt.seg_sum(sids, order, starts, g, table.shape[0], '0')
    tpt.rmw_rows(table, uids, gsum, hyp, opt)


@pytest.mark.parametrize('hot', [C, 5 * C + 3])
def test_plain_against_k1_k2_plain(hot):
  """Against K1 (mode 0, f32) followed by K2: both sum by the one chunk
  tree, so the tables are bit-equal whatever the segments' lengths, a
  segment of several chunks included."""
  rows, dim, n = 400, 16, 2000
  rng = np.random.default_rng(hot)
  w0 = (rng.standard_normal((rows, dim)) * 0.05).astype(np.float32)
  m0, v0 = _moments(rng, rows, dim)
  tmeta = _tmeta(rows, dim)
  tables = [torch.from_numpy(tpt.pack_host(w0, [m0, v0], tmeta))
            for _ in range(2)]
  for step in range(2):
    ids = rng.integers(0, rows, n)
    ids[ids == 11] = 12
    ids[:hot] = 11                          # exactly `hot` slots of id 11
    grads = rng.standard_normal((n, dim)).astype(np.float32)
    for fused, table in zip((True, False), tables):
      _port_update(ids, grads, table, step, fused)
  a, b = tables[0].numpy(), tables[1].numpy()
  np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
  assert not np.array_equal(a[11], tpt.pack_host(w0, [m0, v0], tmeta)[11])


def _np_tree(rows):
  """The documented tree, walked by hand: slot-lane p adds rows p, p + 8,
  ... to 0 in f32, then lanes p and p + o combine for o = 4, 2, 1."""
  lanes = [np.zeros(rows.shape[1], np.float32) for _ in range(tpt.SLOT_LANES)]
  for i, row in enumerate(rows):
    lanes[i % tpt.SLOT_LANES] = lanes[i % tpt.SLOT_LANES] + row
  o = tpt.SLOT_LANES // 2
  while o:
    lanes = [lanes[p] + lanes[p + o] for p in range(o)]
    o //= 2
  return lanes[0]


def _np_segment_sum(rows):
  """Level 1: chunks of C rows by _np_tree; level 2: one chunk's sum as
  it is, several chunks' sums by _np_tree again."""
  chunks = [_np_tree(rows[lo:lo + C]) for lo in range(0, len(rows), C)]
  return chunks[0] if len(chunks) == 1 else _np_tree(np.stack(chunks))


@pytest.mark.parametrize('mode', ['0', 'mix', '1'])
@pytest.mark.parametrize('length', [1, tpt.SLOT_LANES - 1, C, C + 1,
                                    5 * C + 3, 3001])
def test_plain_order_of_additions(length, mode):
  """The plain tree (segment_sums_by_chunk, which seg_sum_plain and
  rmw_fused_plain share) against a hand walk of the tree documented
  in csrc/seg_chunk_sum.cuh, bit for bit, on terms of magnitudes 1e-6 to
  1e6, where any other order of additions rounds differently; a short
  segment and an unused segment beside it. Then the fused update: an
  unused segment and an id outside the table change nothing."""
  rows, dim = 10, 3
  n = length + 7
  ids = np.full(n, 3)
  ids[-7:] = 5
  ids[-1] = rows                               # outside the table
  rng = np.random.default_rng(length)
  grads = rng.standard_normal((n, dim)).astype(np.float32) * \
      np.float32(1e3) ** rng.integers(-2, 3, (n, 1)).astype(np.float32)
  sids, order, starts = tpt.sort_segments(torch.from_numpy(ids))
  sums = tpt.segment_sums_by_chunk(order, starts, torch.from_numpy(grads),
                                   mode)
  payload = grads if mode == '0' else \
      tpt.bf16_round(torch.from_numpy(grads)).numpy()
  o = order.numpy()
  want = [_np_segment_sum(payload[o[:length]]),      # id 3, slot order
          _np_segment_sum(payload[o[length:length + 6]]),
          _np_segment_sum(payload[o[n - 1:]])]
  if mode == '1':
    want = tpt.bf16_round(torch.from_numpy(np.stack(want))).numpy()
  np.testing.assert_array_equal(sums[:3].numpy().view(np.uint32),
                                np.stack(want).view(np.uint32))
  np.testing.assert_array_equal(sums[3:].numpy(), 0.0)
  uids, k1 = tpt.seg_sum_plain(sids, order, starts, torch.from_numpy(grads),
                               99, mode)
  np.testing.assert_array_equal(uids.numpy()[:4], [3, 5, rows, 99])
  np.testing.assert_array_equal(k1.numpy().view(np.uint32),
                                sums.numpy().view(np.uint32))
  table = torch.zeros((rows, 2 * dim))
  opt = SparseAdam()
  tpt.rmw_fused(table, sids, order, starts, torch.from_numpy(grads),
                opt.hypers(torch.tensor(0.1),
                           torch.tensor(0, dtype=torch.int32)), opt)
  changed = (table != 0).any(dim=1).numpy()
  np.testing.assert_array_equal(np.nonzero(changed)[0], [3, 5])


def _chunk_rows(starts, n):
  """Where the kernels put the chunk sums of long segments (more than C
  slots), by the formula of seg_chunk_sum.cuh chunk_row: the sorted slots
  are cut into windows of C; chunk j of segment k (first slot s) starts in
  window w = (s + j*C) // C and takes scratch row 2w, or 2w + 1 where it
  is a first chunk (j == 0) starting after its window's first slot.
  Returns {(k, j): row}."""
  lens = (starts[1:] - starts[:n]).tolist()
  first = starts[:n].tolist()
  rows = {}
  for k, length in enumerate(lens):
    if length > C:
      s = first[k]
      for j in range(-(-length // C)):
        rows[(k, j)] = 2 * ((s + j * C) // C) + int(j == 0 and s % C != 0)
  return rows


def _window_items(starts, n):
  """The kernels' window search (seg_chunk_sum.cuh window_item), in numpy:
  for window w, t = 0 is the segment holding slot w*C if it is long and
  one of its chunks starts in the window, t = 1 the last segment starting
  inside the window after its first slot if it is long (its chunk 0).
  Returns {(k, j): 2w + t}."""
  st = starts.numpy()
  found = {}
  for w in range(-(-n // C)):
    lo, hi = w * C, min(w * C + C, n)
    for t, at in ((0, lo), (1, hi - 1)):
      k = int(np.searchsorted(st, at, side='right')) - 1
      s, e = int(st[k]), int(st[k + 1])
      if e - s <= C:
        continue
      if t == 1:
        if s > lo:
          found[(k, 0)] = 2 * w + 1
        continue
      j = -(-(lo - s) // C)
      if s + j * C < min(hi, e):
        found[(k, j)] = 2 * w
  return found


_MIXED = [1, 2, 8, 9, C - 1, C, C + 1, 2 * C, 3 * C + 7, 1000]


@pytest.mark.parametrize('lens', [
    [1, 2, 3], [C + 1], [700, 3, C, 2 * C + 1], [3000]] + [
        np.random.default_rng(seed).choice(_MIXED, 40).tolist()
        for seed in range(3)])
def test_chunk_map_gives_long_segments_their_chunk_slots(lens):
  """_chunk_rows, where the kernels put each long segment's chunk sums:
  every segment longer than C has ceil(len / C) chunks, each on its own
  scratch row below long_chunk_bound; and the kernels' window search
  finds exactly those chunks at exactly those rows, with no work list;
  the last three cases mix tiny, short and long segments starting
  anywhere in their windows. (On the card, test_kernels_find_every_long_
  chunk holds the kernels themselves to the plain sums.)"""
  ids = np.repeat(np.arange(len(lens)), lens)
  n = ids.shape[0]
  _, _, starts = tpt.sort_segments(torch.from_numpy(ids))
  rows = _chunk_rows(starts, n)
  want = [(k, j) for k, length in enumerate(lens) if length > C
          for j in range(-(-length // C))]
  assert sorted(rows) == want
  assert len(set(rows.values())) == len(rows)
  assert all(0 <= r < tpt.long_chunk_bound(n) for r in rows.values())
  assert tpt.long_chunk_bound(n) == 2 * -(-n // C)
  assert _window_items(starts, n) == rows


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
  for name in ('rmw_fused', 'seg_sum', 'rmw_rows'):
    real = getattr(tpt, name)
    monkeypatch.setattr(tpt, name,
                        lambda *a, _n=name, _f=real, **k:
                        calls.append(_n) or _f(*a, **k))
  meta = _tmeta(20, 4)
  opt = SparseAdam()
  tpt.apply_packed_update(
      torch.zeros((20, 8)), torch.tensor([[1, 2], [2, 3]]),
      torch.ones((2, 2, 4)),
      opt.hypers(torch.tensor(0.1), torch.tensor(0, dtype=torch.int32)),
      opt, meta)
  assert calls == (['rmw_fused'] if fused else ['seg_sum', 'rmw_rows'])


def test_wrapper_checks_inputs():
  ids = torch.tensor([2, 0, 2])
  grads = torch.ones((3, 4))
  sids, order, starts = tpt.sort_segments(ids)
  table = torch.zeros((3, 8))
  opt = SparseAdam()
  hyp = opt.hypers(torch.tensor(0.1), torch.tensor(0, dtype=torch.int32))
  with pytest.raises(TypeError):
    tpt.rmw_fused(table, sids, order, starts, grads.double(), hyp, opt)
  with pytest.raises(ValueError):
    tpt.rmw_fused(table, sids, order, starts[:-1], grads, hyp, opt)
  with pytest.raises(ValueError):
    tpt.rmw_fused(torch.zeros((8, 3)).t(), sids, order, starts, grads,
                  hyp, opt)
  with pytest.raises(TypeError):       # the JAX package's optimizer
    tpt.rmw_fused(table, sids, order, starts, grads, hyp,
                  sparse_lib.sparse_sgd())


def test_build_key_covers_the_shared_adam_header(tmp_path):
  """K2 and K3 take their block math from one header, block_math.cuh, and
  K1 and K3 their sum from another, seg_chunk_sum.cuh; a library is named by
  a hash that covers the headers its source includes by a quoted path: a
  changed header builds its kernels anew, so a stale copy of the update or
  the tree is never loaded. A quoted include that does not lie beside the
  source is left to the compiler's search path."""
  for header, users in (('block_math.cuh', (kernels.RMW_ROWS,
                                            kernels.RMW_FUSED)),
                        ('seg_chunk_sum.cuh', (kernels.SEG_SUM,
                                               kernels.RMW_FUSED))):
    for k in users:
      with open(k.source) as f:
        assert '#include "%s"' % header in f.read()
      digest = hashlib.sha256()
      hash_sources(k.source, digest)
      plain = hashlib.sha256()
      with open(k.source, 'rb') as f:
        plain.update(f.read())
      assert digest.hexdigest() != plain.hexdigest()
  src, hdr = tmp_path / 'k.cu', tmp_path / 'h.cuh'
  src.write_text('#include <cstdint>\n#include "h.cuh"\n'
                 '#include "absent.h"\n')
  hdr.write_text('// one\n')
  first = NativeBuild(str(src), ['nvcc'], NVCC_FLAGS).path
  assert NativeBuild(str(src), ['nvcc'], NVCC_FLAGS).path == first
  hdr.write_text('// two\n')
  assert NativeBuild(str(src), ['nvcc'], NVCC_FLAGS).path != first
