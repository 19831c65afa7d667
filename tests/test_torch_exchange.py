"""The owner-routed exchange of the port (easyrec_torch/parallel/exchange.py)
against the JAX package's (easyrec_tpu/parallel/exchange.py) on the CPU.

The same seeded ids go through capacity_rows, build_route, send_to_owners
and return_to_requesters in 4 and in 3 gloo processes (one world each,
spawned once for the file, every case inside it) and, on the JAX side,
under shard_map over as many virtual CPU devices in the JAX package's
a2a_emulated mode. Each rank's capacity, size matrix, received rows,
returned rows and overflow count must be equal exactly, at capacity factor
0 (the unbounded buffer), 2 (the default) and 0.3 over ids skewed to the
first owner, which forces drops; at factor 0 those skewed ids drop
nothing. ep_pull_sharded and packed_update_sharded over the exchange pull
the table's own rows and update every rank's block as one process updates
the whole table.

The module imports nothing of JAX at its top: the spawned processes import
it for the worker."""

import os

import numpy as np
import pytest
import torch

from easyrec_torch.parallel import exchange as xch
from easyrec_torch.parallel import launch

LOCAL_ROWS = 16
N_LOC = 32
FACTORS = ('0', '2', '0.3')


def case_ids(world: int, factor: str) -> np.ndarray:
  """[world, N_LOC] sorted unique ids per rank, the tail padded with
  world * LOCAL_ROWS (sent nowhere); skewed to owner 0 for the dropping
  factor."""
  rng = np.random.default_rng(world * 10 + len(factor))
  hi = LOCAL_ROWS * (1 if factor == '0.3' else world)
  out = np.full((world, N_LOC), world * LOCAL_ROWS, np.int64)
  for r in range(world):
    u = np.unique(rng.integers(0, hi, N_LOC + 8))[:N_LOC]
    out[r, :u.shape[0]] = u
  return out


def values_of(ids: np.ndarray) -> np.ndarray:
  return np.stack([ids * 10.0 + 1.0, -ids * 0.5], axis=-1).astype(
      np.float32)


def exchange_worker(world, factors):
  """Each factor's route on this rank: (cap, sizes, received, returned,
  overflow)."""
  out = {}
  for factor in factors:
    os.environ['EASYREC_EXCHANGE_CAP_FACTOR'] = factor
    ids = torch.from_numpy(case_ids(world.size, factor)[world.rank])
    cap = xch.capacity_rows(N_LOC, world.size, world.size)
    route = xch.build_route(world, ids, LOCAL_ROWS, cap=cap)
    vals = torch.from_numpy(values_of(ids.numpy()))
    recv = xch.send_to_owners(world, route, vals, -1.0)
    back = xch.return_to_requesters(world, route, recv * 2.0)
    out[factor] = (cap, route.sizes.astype(np.int64), recv.numpy(),
                   back.numpy(), route.overflow)
  os.environ['EASYREC_EXCHANGE_CAP_FACTOR'] = '0'
  ids = torch.from_numpy(case_ids(world.size, '0.3')[world.rank])
  route = xch.build_route(world, ids, LOCAL_ROWS, cap=xch.capacity_rows(
      N_LOC, world.size, world.size))
  out['skewed_at_0'] = (route.cap, route.overflow,
                        int(route.raw[:, world.rank].sum()))
  out['sharded'] = sharded_worker_case(world)
  return out


def sharded_worker_case(world):
  """ep_pull_sharded and packed_update_sharded (Adagrad) on one seeded
  table and batch at capacity factor 0, the gradients summed in f32:
  (pulled rows, updated block, the
  table's rows of the ids, this rank's row range)."""
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.ops import packed_table as pt
  from easyrec_torch.optim import sparse
  from easyrec_torch.parallel import mesh
  rows, dim = 700, 4
  opt = sparse.SparseAdagrad()
  split = mesh.row_split(rows, dim, 2, world.size)
  rng = np.random.default_rng(7)
  whole = torch.from_numpy(rng.standard_normal((rows, 2 * dim)).astype(
      np.float32)).abs()
  ids = torch.from_numpy(rng.integers(0, rows, (world.size, 24, 3)))
  grads = torch.from_numpy(rng.standard_normal(
      (world.size, 72, dim)).astype(np.float32))
  lo, n = split.start(world.rank), split.count(world.rank)
  os.environ['EASYREC_EXCHANGE_CAP_FACTOR'] = '0'    # nothing dropped
  os.environ['EASYREC_GG_BF16'] = '0'                # f32 gradient sums
  sh = emb_ops.Sharding(world, {'t': split})
  block = whole[lo:lo + n].clone()
  pulled = emb_ops.ep_pull_sharded(sh, block, ids[world.rank], split, dim)
  sparse.packed_update_sharded(
      world, block, ids[world.rank].reshape(-1), grads[world.rank],
      opt.hypers(torch.tensor(0.1), torch.tensor(0)), opt,
      pt.TableMeta(n, dim, 2), split)
  return (pulled.numpy(), block.numpy(),
          whole[ids[world.rank]][..., :dim].numpy(), (lo, n))


def one_process_update(world: int):
  """The table of sharded_worker_case after one process's
  apply_packed_update of every rank's ids and gradients."""
  from easyrec_torch.ops import packed_table as pt
  from easyrec_torch.optim import sparse
  rows, dim = 700, 4
  opt = sparse.SparseAdagrad()
  rng = np.random.default_rng(7)
  whole = torch.from_numpy(rng.standard_normal((rows, 2 * dim)).astype(
      np.float32)).abs()
  ids = torch.from_numpy(rng.integers(0, rows, (world, 24, 3)))
  grads = torch.from_numpy(rng.standard_normal(
      (world, 72, dim)).astype(np.float32))
  pt.apply_packed_update(whole, ids.reshape(-1), grads.reshape(-1, dim),
                         opt.hypers(torch.tensor(0.1), torch.tensor(0)), opt,
                         pt.TableMeta(rows, dim, 2))
  return whole.numpy()


def jax_exchange(world: int, factor: str, monkeypatch):
  import jax
  import jax.numpy as jnp
  from jax.sharding import Mesh, PartitionSpec as P
  from easyrec_tpu.parallel import exchange as jx
  monkeypatch.setenv('EASYREC_EXCHANGE_CAP_FACTOR', factor)
  cap = jx.capacity_rows(N_LOC, world, world)
  mesh = Mesh(np.array(jax.devices()[:world]), ('x',))

  def local(ids_l):
    u = ids_l[0].astype(jnp.int32)
    route = jx.build_route(u, LOCAL_ROWS, world, 'x', cap=cap)
    vals = jnp.stack([u * 10.0 + 1.0, -u * 0.5], axis=-1).astype(
        jnp.float32)
    recv = jx.send_to_owners(route, vals, -1.0, 'x', True, world)
    back = jx.return_to_requesters(route, recv * 2.0, 'x', True, world)
    return (route.sizes_mat[None], recv[None], back[None],
            route.overflow[None])

  fn = jax.shard_map(local, mesh=mesh, in_specs=(P('x'),),
                     out_specs=(P('x'), P('x'), P('x'), P('x')),
                     check_vma=False)
  sizes, recv, back, overflow = jax.jit(fn)(jnp.asarray(
      case_ids(world, factor), jnp.int32))
  return cap, [(np.asarray(sizes[r]), np.asarray(recv[r]),
                np.asarray(back[r]), int(overflow[r]))
               for r in range(world)]


_WORLDS = {}


def port_world(world: int):
  if world not in _WORLDS:
    _WORLDS[world] = launch.spawn(
        'tests.test_torch_exchange:exchange_worker', [FACTORS], world,
        timeout_s=120)
  return _WORLDS[world]


@pytest.mark.parametrize('world', [4, 3])
@pytest.mark.parametrize('factor', FACTORS)
def test_exchange_matches_jax(world, factor, monkeypatch):
  ranks = port_world(world)
  cap, want = jax_exchange(world, factor, monkeypatch)
  dropped = 0
  for r, (got, (j_sizes, j_recv, j_back, j_over)) in enumerate(
      zip(ranks, want)):
    t_cap, t_sizes, t_recv, t_back, t_over = got[factor]
    assert t_cap == cap
    np.testing.assert_array_equal(t_sizes, j_sizes, err_msg='rank %d' % r)
    np.testing.assert_array_equal(t_recv, j_recv, err_msg='rank %d' % r)
    np.testing.assert_array_equal(t_back, j_back, err_msg='rank %d' % r)
    assert t_over == j_over, r
    dropped += t_over
  if factor == '0.3':
    assert dropped > 0          # the case does drop rows
  else:
    assert dropped == 0


@pytest.mark.parametrize('world', [4, 3])
def test_sharded_pull_and_update_match_one_process(world, monkeypatch):
  """Over the exchange each rank pulls the table's own rows, and the
  ranks' updated blocks, joined, equal one process's update of the whole
  table with every rank's ids and gradients (the owner sums an id's
  per-rank sums, one process the raw gradients: 1e-6)."""
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  want = one_process_update(world)
  got = np.zeros_like(want)
  for rank in port_world(world):
    pulled, block, rows, (lo, n) = rank['sharded']
    np.testing.assert_array_equal(pulled, rows)
    got[lo:lo + n] = block
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('world', [4, 3])
def test_factor_zero_drops_nothing(world):
  """EASYREC_EXCHANGE_CAP_FACTOR=0 keeps the worst-case buffer: the
  skewed ids that factor 0.3 cuts all arrive."""
  ranks = port_world(world)
  assert sum(r['skewed_at_0'][2] for r in ranks) > 0
  for rank in ranks:
    cap, overflow, _ = rank['skewed_at_0']
    assert cap == N_LOC * world and overflow == 0


@pytest.mark.parametrize('factor,n_dev,live,want', [
    ('0', 4, 4, 128), ('2', 4, 4, 64), ('2', 4, 1, 128), ('0.3', 3, 3, 16),
    ('2', 8, 2, 256)])
def test_capacity_rows_matches_jax(factor, n_dev, live, want, monkeypatch):
  from easyrec_tpu.parallel import exchange as jx
  monkeypatch.setenv('EASYREC_EXCHANGE_CAP_FACTOR', factor)
  got = xch.capacity_rows(N_LOC, n_dev, live)
  assert got == jx.capacity_rows(N_LOC, n_dev, live) == want
