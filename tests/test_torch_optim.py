"""The port's optimizers (easyrec_torch/optim/sparse.py, builder.py) and
the plain versions of K2 and K3 for every block math (ops/packed_table.py)
against the JAX package: each sparse optimizer's block math and its
plain-layout update_rows, the packed update through K1 + K2's plain
versions against apply_packed_update's XLA path, K3's against the fused
Pallas kernel in interpret mode, each dense optimizer against its optax
transform (clipping included), and the config mapping of both builders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.ops import kernels
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.optim import builder as t_builder
from easyrec_torch.optim import sparse as t_sparse
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.optim import builder as j_builder
from easyrec_tpu.optim import sparse as j_sparse

BF16_ULP = 2.0 ** -7      # one bf16 unit in the last place, relative

# (id, JAX optimizer, port optimizer, compact layout)
OPTIMIZERS = {
    'sgd': (j_sparse.sparse_sgd(), t_sparse.SparseSGD(), False),
    'momentum': (j_sparse.sparse_momentum(0.8), t_sparse.SparseMomentum(0.8),
                 False),
    'adagrad': (j_sparse.sparse_adagrad(0.1), t_sparse.SparseAdagrad(0.1),
                False),
    'adam': (j_sparse.sparse_adam(), t_sparse.SparseAdam(), False),
    'adamw': (j_sparse.sparse_adam(weight_decay=0.01),
              t_sparse.SparseAdam(weight_decay=0.01), False),
    'compact_adam': (j_sparse.sparse_adam(), t_sparse.SparseAdam(), True),
    'compact_adamw': (j_sparse.sparse_adam(weight_decay=0.01),
                      t_sparse.SparseAdam(weight_decay=0.01), True),
    'ftrl': (j_sparse.sparse_ftrl(), t_sparse.SparseFtrl(), False),
    'ftrl_l1_l2_shrinkage': (
        j_sparse.sparse_ftrl(learning_rate_power=-0.5,
                             initial_accumulator=0.2, l1=0.01, l2=0.02,
                             l2_shrinkage=0.05),
        t_sparse.SparseFtrl(learning_rate_power=-0.5, initial_accumulator=0.2,
                            l1=0.01, l2=0.02, l2_shrinkage=0.05), False),
    'ftrl_power_1': (j_sparse.sparse_ftrl(learning_rate_power=-1.0, l1=0.01),
                     t_sparse.SparseFtrl(learning_rate_power=-1.0, l1=0.01),
                     False),
}


def _slots(rng, opt, rows, dim):
  """Plausible slot values: Adam moments small and v >= 0, accumulators
  at least their initial value, FTRL's z of either sign."""
  out = []
  for name, init in zip(opt.slot_names, opt.slot_init):
    if name == 'v':
      out.append(rng.random((rows, dim)) * 1e-4)
    elif name == 'accum':
      out.append(init + rng.random((rows, dim)) * 0.5)
    elif name == 'z':
      out.append(rng.standard_normal((rows, dim)) * 0.05)
    else:
      out.append(rng.standard_normal((rows, dim)) * 1e-3)
  return [x.astype(np.float32) for x in out]


# FTRL's z takes sigma * w, sigma the difference of two close roots of the
# accumulator over lr: where XLA's pow(acc, 0.5) is one ulp off the
# correctly rounded root the port takes, z moves by up to ~1.2e-6 (measured
# at dims 1-32), while w and the accumulator stay within 1.2e-7
Z_ATOL = 3e-6


def _atols(opt, atol):
  """atol for each part of `opt`'s row: Z_ATOL for FTRL's z."""
  return [max(atol, Z_ATOL) if name == 'z' else atol
          for name in ('w',) + opt.slot_names]


def _hypers(opt, lr, step):
  return opt.hypers(torch.tensor(lr), torch.tensor(step, dtype=torch.int32))


@pytest.mark.parametrize('dim', [1, 3, 16, 32])
@pytest.mark.parametrize('which', sorted(OPTIMIZERS))
def test_block_matches_jax_block_math(which, dim):
  """block (compact_block for the compact layout) against the JAX
  block_math (compact_math) on the same parts. XLA on the CPU contracts
  a*b + c into an FMA and lowers rsqrt and pow its own way, where the port
  rounds each op: the parts agree within 1e-6 absolute on weights of
  magnitude 0.05-1 (a few f32 ulps of the operands; FTRL's z within
  Z_ATOL), a compact moment within one bf16 ulp (an f32 moment a hair
  from a rounding boundary)."""
  j_opt, t_opt, compact = OPTIMIZERS[which]
  rng = np.random.default_rng(dim)
  rows = 64
  w = rng.standard_normal((rows, dim)).astype(np.float32) * 0.5
  slots = _slots(rng, t_opt, rows, dim)
  g = (rng.standard_normal((rows, dim)) * 1e-2).astype(np.float32)
  g[::5] = 0.0
  hyp = _hypers(t_opt, 0.05, 3)
  j_hyp = np.asarray(hyp)
  if compact:
    mv = t_sparse.pack_pair(torch.from_numpy(slots[0]),
                            torch.from_numpy(slots[1]))
    got = t_opt.compact_block(torch.from_numpy(w), mv, torch.from_numpy(g),
                              hyp)
    want = j_opt.compact_math([jnp.asarray(w), jnp.asarray(mv.numpy())],
                              jnp.asarray(g), lambda k: j_hyp[k])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-6)
    for a, b in zip(t_sparse.unpack_pair(got[1]),
                    t_sparse.unpack_pair(torch.tensor(
                        np.asarray(want[1])))):
      np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=BF16_ULP,
                                 atol=1e-12)
    return
  parts = [w] + slots
  got = t_opt.block([torch.from_numpy(p) for p in parts],
                    torch.from_numpy(g), hyp)
  want = j_opt.block_math([jnp.asarray(p) for p in parts], jnp.asarray(g),
                          lambda k: j_hyp[k])
  assert len(got) == len(want) == t_opt.n_parts
  for a, b, atol in zip(got, want, _atols(t_opt, 1e-6)):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize('which', ['sgd', 'momentum', 'adagrad', 'adam',
                                   'adamw', 'ftrl', 'ftrl_l1_l2_shrinkage'])
def test_update_rows_matches_jax(which):
  """Two steps of the plain-layout update_rows on separate arrays, from
  dedup_sum'd ids with zero-gradient scratch slots, within 1e-6 (FMA
  contraction and rsqrt on the JAX side, as above; FTRL's z within
  Z_ATOL)."""
  j_opt, t_opt, _ = OPTIMIZERS[which]
  rng = np.random.default_rng(7)
  rows, dim = 50, 8
  w = rng.standard_normal((rows, dim)).astype(np.float32)
  slots = _slots(rng, t_opt, rows, dim)
  jt = jnp.asarray(w)
  jst = {k: jnp.asarray(v) for k, v in zip(t_opt.slot_names, slots)}
  tt = torch.from_numpy(w.copy())
  tst = {k: torch.from_numpy(v.copy()) for k, v in zip(t_opt.slot_names,
                                                        slots)}
  for step in range(2):
    ids = rng.integers(0, rows - 1, 40).astype(np.int32)
    g = (rng.standard_normal((40, dim)) * 1e-1).astype(np.float32)
    uids, ug = j_sparse.dedup_sum(jnp.asarray(ids), jnp.asarray(g),
                                  rows - 1)
    jt, jst = j_opt.update_rows(jt, jst, uids, ug, jnp.float32(5e-2),
                                jnp.int32(step))
    tt, tst = t_opt.update_rows(tt, tst, torch.tensor(np.asarray(uids)),
                                torch.tensor(np.asarray(ug)),
                                torch.tensor(5e-2),
                                torch.tensor(step, dtype=torch.int32))
  np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
  for k, atol in zip(t_opt.slot_names, _atols(t_opt, 1e-6)[1:]):
    np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), rtol=0,
                               atol=atol)


def _step_ids(rng, rows, n):
  """Duplicated ids with a cancelling pair (its row sums to exactly 0) and
  a row whose only gradient is 0."""
  ids = rng.integers(0, rows - 10, n)
  ids[:2] = rows - 5
  ids[2] = rows - 4
  return ids


def _run_packed(which, dim, rows, n, steps, jax_update, port_update):
  """`steps` packed updates of one table on both sides from the same
  state; returns (JAX table through convert.py, port table, untouched
  rows, the port's meta)."""
  j_opt, t_opt, compact = OPTIMIZERS[which]
  meta = jpt.PackMeta(rows, dim, t_opt.n_parts, compact=compact)
  tmeta = tpt.TableMeta(rows, dim, t_opt.n_parts, compact=compact)
  rng = np.random.default_rng(dim + rows)
  w0 = (rng.standard_normal((rows, dim)) * 0.05).astype(np.float32)
  slots = _slots(rng, t_opt, rows, dim)
  packed = jnp.asarray(jpt.pack_host(w0, slots, meta))
  table = torch.from_numpy(tpt.pack_host(w0, slots, tmeta))
  orig = table.clone()
  seen = set()
  for step in range(steps):
    ids = _step_ids(rng, rows, n)
    grads = (rng.standard_normal((n, dim)) * 1e-2).astype(np.float32)
    grads[1] = -grads[0]
    grads[2] = 0.0
    seen.update(ids[3:].tolist())
    hyp = t_opt.hypers(torch.tensor(5e-2), torch.tensor(step,
                                                        dtype=torch.int32))
    math = j_opt.compact_math if compact else j_opt.block_math
    packed = jax_update(packed, ids, grads, jnp.asarray(hyp.numpy()), math,
                        meta)
    port_update(table, torch.from_numpy(ids), torch.from_numpy(grads), hyp,
                t_opt, tmeta)
  got = convert.jax_packed_to_table(np.asarray(packed), dim, rows,
                                    meta.n_parts)
  untouched = np.ones(rows, bool)
  untouched[list(seen)] = False
  assert untouched[rows - 5] and untouched[rows - 4]
  # untouched rows, the cancelling pair's and the zero row's included,
  # keep their bytes on both sides
  np.testing.assert_array_equal(table.numpy()[untouched].view(np.uint32),
                                orig.numpy()[untouched].view(np.uint32))
  np.testing.assert_array_equal(got[untouched].view(np.uint32),
                                orig.numpy()[untouched].view(np.uint32))
  return got, table.numpy(), ~untouched, tmeta


def _assert_parts_close(jax_table, port_table, touched, tmeta, atols):
  """Every part of the touched rows within its atol; compact moments
  within one bf16 ulp (or 1e-9 where they round near zero)."""
  tw, ts = tpt.unpack_host(port_table, tmeta)
  jw, js = tpt.unpack_host(jax_table, tmeta)
  np.testing.assert_allclose(tw[touched], jw[touched], rtol=0,
                             atol=atols[0])
  for a, b, atol in zip(ts, js, atols[1:]):
    if tmeta.compact:
      np.testing.assert_allclose(a[touched], b[touched], rtol=BF16_ULP,
                                 atol=1e-9)
    else:
      np.testing.assert_allclose(a[touched], b[touched], rtol=0, atol=atol)


def _jax_xla(packed, ids, grads, hyp, math, meta):
  return jpt.apply_packed_update(packed, jnp.asarray(ids, jnp.int32),
                                 jnp.asarray(grads), hyp, math, meta,
                                 use_pallas=False)


@pytest.mark.parametrize('dim', [3, 16])
@pytest.mark.parametrize('which', ['sgd', 'momentum', 'adagrad', 'adam',
                                   'adamw', 'ftrl_l1_l2_shrinkage'])
def test_plain_k2_matches_jax_packed_update(which, dim, monkeypatch):
  """Two steps of apply_packed_update through K1 and K2's plain versions
  (f32 sums: EASYREC_GG_BF16=0 on both sides) against the JAX package's
  apply_packed_update on its XLA path, read through convert.py. Sums
  differ only by f32 order among equal ids; the math by FMA contraction
  and rsqrt/pow lowering: every part within 1e-6, FTRL's z within
  Z_ATOL."""
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.delenv('EASYREC_PACKED_FUSED', raising=False)
  kernels.reset_launches()
  got, table, touched, tmeta = _run_packed(
      which, dim, 500, 300, 2, _jax_xla, tpt.apply_packed_update)
  assert set(kernels.launch_counts().values()) == {0}     # CPU: plain
  _assert_parts_close(got, table, touched, tmeta,
                      _atols(OPTIMIZERS[which][1], 1e-6))


def _jax_fused(packed, ids, grads, hyp, math, meta):
  return jpt.apply_packed_update(packed, jnp.asarray(ids, jnp.int32),
                                 jnp.asarray(grads), hyp, math, meta,
                                 use_pallas=False, interpret=True)


@pytest.mark.parametrize('which,atol', [('adagrad', 2e-6),
                                        ('ftrl_l1_l2_shrinkage', 3e-4)])
def test_plain_k3_matches_fused_pallas_interpret(which, atol, monkeypatch):
  """Two steps of the port's fused update (K3's plain version) against
  _rmw_fused_pallas in interpret mode, at one small shape. The TPU kernel
  sums each f32 gradient as bf16 hi + lo (about 2^-16 relative a term):
  Adagrad's w moves by lr g / sqrt(acc), so within 2e-6; FTRL's w is a
  ratio of z and the root of the accumulator and moves further, 3e-4 (the
  JAX package's own tolerance for its fused FTRL, tests/test_packed_table.py
  :149-152)."""
  monkeypatch.setenv('EASYREC_PACKED_FUSED', '1')
  got, table, touched, tmeta = _run_packed(
      which, 16, 300, 700, 2, _jax_fused, tpt.apply_packed_update)
  _assert_parts_close(got, table, touched, tmeta,
                      _atols(OPTIMIZERS[which][1], atol))


@pytest.mark.parametrize('dim', [160, 256])
@pytest.mark.parametrize('which', ['sgd', 'adagrad', 'compact_adam', 'ftrl'])
def test_fused_wrapper_takes_wide_rows(which, dim):
  """K3's wrapper takes dims above 128 (the JAX package's fused kernel goes
  to dim 256, sgd to 512): on the CPU its plain version equals K1 (mode 0)
  followed by K2's, bit for bit; a table of the wrong width is refused."""
  _, t_opt, compact = OPTIMIZERS[which]
  rows, n = 300, 900
  meta = tpt.TableMeta(rows, dim, t_opt.n_parts, compact=compact)
  rng = np.random.default_rng(dim)
  w0 = (rng.standard_normal((rows, dim)) * 0.05).astype(np.float32)
  base = tpt.pack_host(w0, _slots(rng, t_opt, rows, dim), meta)
  ids = torch.from_numpy(rng.integers(0, rows, n))
  ids[:300] = 7                             # a long segment
  grads = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
  hyp = _hypers(t_opt, 1e-2, 0)
  sids, order, starts = tpt.sort_segments(ids)
  a, b = torch.from_numpy(base.copy()), torch.from_numpy(base.copy())
  tpt.rmw_fused(a, sids, order, starts, grads, hyp, t_opt)
  uids, gsum = tpt.seg_sum(sids, order, starts, grads, rows, '0')
  tpt.rmw_rows(b, uids, gsum, hyp, t_opt)
  np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                b.numpy().view(np.uint32))
  assert not np.array_equal(a.numpy()[7], base[7])
  with pytest.raises(ValueError):
    tpt.rmw_fused(torch.zeros((rows, meta.width + 1)), sids, order,
                  starts, grads, hyp, t_opt)


@pytest.mark.parametrize('env,opt,compact', [
    ('1', t_sparse.SparseAdam(), True), ('0', t_sparse.SparseAdam(), False),
    ('1', t_sparse.SparseAdagrad(), False), ('1', t_sparse.SparseFtrl(),
                                             False)])
def test_table_meta_follows_the_jax_trainer(env, opt, compact, monkeypatch):
  """EASYREC_PACKED_COMPACT keeps the JAX trainer's meaning: compact only
  for Adam, and not for dim-1 tables; the slot parts start at slot_init."""
  monkeypatch.setenv('EASYREC_PACKED_COMPACT', env)
  meta = tpt.table_meta(100, 16, opt)
  assert meta.compact == compact
  assert meta.width == (2 if compact else opt.n_parts) * 16
  assert not tpt.table_meta(100, 1, opt).compact
  fill = tpt.slot_fill(meta, opt.slot_init)
  assert len(fill) == meta.n_parts - 1
  if isinstance(opt, t_sparse.SparseAdagrad):
    np.testing.assert_array_equal(np.float32(fill), np.float32([0.1]))


# ------------------------------------------------------------ dense, builder

LR = '''learning_rate { exponential_decay_learning_rate {
          initial_learning_rate: 0.05 decay_steps: 2 decay_factor: 0.5 } }'''

KINDS = {
    'adam_optimizer': 'beta1: 0.8',
    'adam_async_optimizer': '',
    'lazy_adam_optimizer': '',
    'adamw_optimizer': 'weight_decay: 0.01',
    'adam_asyncw_optimizer': 'weight_decay: 0.02 beta2: 0.99',
    'adagrad_optimizer': 'initial_accumulator_value: 0.2',
    'momentum_optimizer': 'momentum_optimizer_value: 0.7',
    'momentumw_optimizer': 'weight_decay: 0.01',
    'rms_prop_optimizer': 'decay: 0.8 epsilon: 0.1',
    'ftrl_optimizer': 'l1_reg: 0.01 l2_reg: 0.02 learning_rate_power: -0.5',
}


def _train_config(kind, clip):
  return ('train_config { optimizer_config { %s { %s %s } } '
          'gradient_clipping_by_norm: %s }' % (kind, LR, KINDS[kind], clip))


def _both_configs(text):
  return (j_config.get_configs_from_pipeline_str(text).train_config,
          t_config.get_configs_from_pipeline_str(text).train_config)


@pytest.mark.parametrize('clip', [0.0, 1.0])
@pytest.mark.parametrize('kind', sorted(KINDS))
def test_dense_optimizer_matches_optax(kind, clip):
  """Three steps of the port's dense optimizer against the optax transform
  the JAX builder makes from the same config, with a decaying schedule;
  clip 1.0 cuts every step's gradients (global norm about 8). The port
  rounds each op, XLA contracts FMAs, lowers rsqrt its own way and sums
  the global norm in another order: within 1e-6 on parameters of
  magnitude ~1 moved by steps of ~0.05."""
  j_tc, t_tc = _both_configs(_train_config(kind, clip))
  (j_pair, _), (t_pair, _) = (j_builder.build_optimizers(j_tc),
                              t_builder.build_optimizers(t_tc))
  rng = np.random.default_rng(3)
  shapes = {'a': (4, 3), 'b': (5,), 'c': (2, 2, 2)}
  params = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
  j_params = {k: jnp.asarray(v) for k, v in params.items()}
  j_state = j_pair.dense.init(j_params)
  t_params = [torch.from_numpy(params[k].copy()) for k in sorted(shapes)]
  dense = t_pair.dense(t_params)
  for _ in range(3):
    grads = {k: rng.standard_normal(s).astype(np.float32) * 2
             for k, s in shapes.items()}
    upd, j_state = j_pair.dense.update(
        {k: jnp.asarray(v) for k, v in grads.items()}, j_state, j_params)
    j_params = {k: j_params[k] + upd[k] for k in shapes}
    for p, k in zip(t_params, sorted(shapes)):
      p.grad = torch.from_numpy(grads[k])
    dense.step()
  for p, k in zip(t_params, sorted(shapes)):
    np.testing.assert_allclose(p.numpy(), np.asarray(j_params[k]), rtol=0,
                               atol=1e-6, err_msg=k)


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_sparse_from_config_matches_jax(kind):
  """Each message kind gives the JAX package's sparse optimizer, odd
  choices included (momentumw -> plain momentum, rms_prop -> Adagrad with
  its defaults): the same name, slots, slot_init, and block math on the
  same inputs (within 1e-6, as test_block_matches_jax_block_math)."""
  j_tc, t_tc = _both_configs(_train_config(kind, 0.0))
  j_opt = j_builder.build_optimizers(j_tc)[0].sparse
  t_opt = t_builder.build_optimizers(t_tc)[0].sparse
  assert t_opt.name == j_opt.name
  assert t_opt.slot_names == j_opt.slot_names
  np.testing.assert_array_equal(np.float32(t_opt.slot_init),
                                np.float32(j_opt.slot_init))
  rng = np.random.default_rng(11)
  parts = [rng.standard_normal((8, 4)).astype(np.float32) * 0.5] + \
      _slots(rng, t_opt, 8, 4)
  g = (rng.standard_normal((8, 4)) * 1e-2).astype(np.float32)
  hyp = _hypers(t_opt, 0.05, 2)
  np.testing.assert_array_equal(
      hyp.numpy(), np.asarray(j_opt.hypers(jnp.float32(0.05),
                                           jnp.int32(2))))
  got = t_opt.block([torch.from_numpy(p) for p in parts],
                    torch.from_numpy(g), hyp)
  j_hyp = hyp.numpy()
  want = j_opt.block_math([jnp.asarray(p) for p in parts], jnp.asarray(g),
                          lambda k: j_hyp[k])
  for a, b, atol in zip(got, want, _atols(t_opt, 1e-6)):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


def test_pairing_and_moving_average():
  """With two optimizers the first drives the tables (with its embedding
  learning-rate multiplier) and the second the dense weights;
  use_moving_average adds the EMA of the parameters, at
  moving_average_decay, started from the initial parameters."""
  text = ('train_config { optimizer_config { adagrad_optimizer { %s } '
          'embedding_learning_rate_multiplier: 0.5 } '
          'optimizer_config { adam_optimizer { %s } } }' % (LR, LR))
  tc = t_config.get_configs_from_pipeline_str(text).train_config
  dense, embed = t_builder.build_optimizers(tc)
  assert isinstance(embed.sparse, t_sparse.SparseAdagrad)
  assert embed.embedding_lr_multiplier == 0.5
  assert isinstance(dense.dense([torch.zeros(2)]), t_builder.DenseAdam)
  tc = t_config.get_configs_from_pipeline_str(
      'train_config { optimizer_config { adam_optimizer {} '
      'use_moving_average: true moving_average_decay: 0.9 } }').train_config
  dense, _ = t_builder.build_optimizers(tc)
  p = torch.ones(2, requires_grad=True)
  opt = dense.dense({'p': p})
  assert isinstance(opt, t_builder.DenseAdam)
  assert opt.ema_decay == np.float32(0.9)
  assert opt.state_slots == ('mu', 'nu', 'ema')
  assert torch.equal(opt.named_ema()['p'], torch.ones(2))
  p.grad = torch.ones(2)
  opt.step()
  assert torch.equal(opt.named_ema()['p'],
                     opt.ema_decay * torch.ones(2) +
                     (1.0 - opt.ema_decay) * p.detach())
