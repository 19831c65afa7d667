"""The port's group kernels K4 (group push) and K5 (group RMW),
easyrec_torch/ops/group_dma.py, through their plain versions on the CPU,
against the JAX package's Pallas prototypes in benchmarks/ run in
interpret mode; the wrappers' CPU dispatch and input checks; and the
ported group-DMA benchmarks driven end to end at a small size.

Tolerances: every push is byte-equal (it copies bytes). Every RMW is
within 1e-6 absolute on O(1) data, the scratch group excluded: XLA on the
CPU contracts x*a + b into one fused multiply-add where the port rounds
the product and the sum separately (as the kernel K5 does, with
__fmul_rn / __fadd_rn), 4.8e-7 at most on N(0, 1) data; the scratch
group's bytes after an RMW are unspecified, as its pad slots race.
"""

import ast
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks import bench_dma_issue as j_dma_issue
from benchmarks import bench_packed_stages as j_stages
from benchmarks import bench_packed_v2 as j_v2
from easyrec_torch.benchmarks import bench_dma_issue as t_dma_issue
from easyrec_torch.benchmarks import bench_group_dma as t_group_dma
from easyrec_torch.benchmarks import bench_packed_stages as t_stages
from easyrec_torch.benchmarks import bench_packed_v2 as t_v2
from easyrec_torch.ops import group_dma, kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RMW_ATOL = 1e-6


@pytest.fixture
def interpret(monkeypatch):
  """Every pl.pallas_call in interpret mode (the prototypes import `pl`
  inside their functions, so they see the patched attribute)."""
  monkeypatch.setattr(pl, 'pallas_call',
                      functools.partial(pl.pallas_call, interpret=True))


def _table_and_slots(rng, groups, width, n_real, n_pad):
  """A random [groups, 8, width] table; n_real unique sorted groups below
  the scratch group (the last), then n_pad slots naming it."""
  table = rng.standard_normal((groups, 8, width)).astype(np.float32)
  real = np.sort(rng.choice(groups - 1, n_real, replace=False))
  gids = np.concatenate([real, np.full(n_pad, groups - 1)]).astype(np.int32)
  return table, gids


def _assert_rmw_close(got: torch.Tensor, want, scratch_gid):
  keep = np.ones(got.shape[0], bool)
  if scratch_gid is not None:
    keep[scratch_gid] = False
  np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                             rtol=0, atol=RMW_ATOL)


# ------------------------------------------------------ K4: group push

@pytest.mark.parametrize('chunk', [64, 128])
def test_push_plain_matches_push_variant(interpret, chunk):
  """bench_packed_stages.push_variant (interpret) vs group_push_plain,
  byte-equal over the whole table: pad slots carry the scratch group's
  current bytes."""
  rng = np.random.default_rng(chunk)
  meta = j_v2.PackMeta(4096, 16)
  table, gids = _table_and_slots(rng, meta.groups, meta.width, 40,
                                 2 * chunk - 40)
  rows = rng.standard_normal((gids.shape[0], 8, meta.width)).astype(
      np.float32)
  rows[40:] = table[-1]
  want = j_stages.push_variant(jnp.asarray(table), jnp.asarray(gids),
                               jnp.asarray(rows), meta, chunk)
  got = torch.from_numpy(table.copy())
  t_stages.push_variant(got, torch.from_numpy(gids), torch.from_numpy(rows))
  assert np.array_equal(got.numpy().view(np.int32),
                        np.asarray(want).view(np.int32))


@pytest.mark.parametrize('dim,n', [(16, 300), (1, 70), (8, 512)])
def test_push_groups_matches_push_groups_pallas(interpret, dim, n):
  """bench_packed_v2.push_groups_pallas (interpret, chunk padding
  included) vs the port's push_groups, whose K4 call is group_push_plain
  on the CPU; byte-equal."""
  rng = np.random.default_rng(dim)
  meta = j_v2.PackMeta(4096 * 8, dim)
  tmeta = t_v2.PackMeta(4096 * 8, dim)
  n_real = min(n, meta.groups - 1)
  packed = rng.standard_normal((meta.groups * 8, meta.width)).astype(
      np.float32)
  gids = np.concatenate([
      np.sort(rng.choice(meta.groups - 1, n_real, replace=False)),
      np.full(n - n_real, meta.scratch_gid)]).astype(np.int32)
  rows = rng.standard_normal((n, 8, meta.width)).astype(np.float32)
  rows[n_real:] = packed.reshape(meta.groups, 8, meta.width)[-1]
  want = j_v2.push_groups_pallas(jnp.asarray(packed), jnp.asarray(gids),
                                 jnp.asarray(rows), meta)
  got = t_v2.push_groups(torch.from_numpy(packed.copy()),
                         torch.from_numpy(gids), torch.from_numpy(rows),
                         tmeta)
  assert np.array_equal(got.numpy().view(np.int32),
                        np.asarray(want).view(np.int32))


# --------------------------------------------------------- K5: group RMW

def _load_group_dma_kernel():
  """`kernel` of benchmarks/bench_pallas_group_dma.py with its imports
  and its SUB, LANE and CHUNK, parsed with ast and executed alone: the
  script allocates a 5 GB table and runs when imported."""
  path = os.path.join(REPO, 'benchmarks', 'bench_pallas_group_dma.py')
  with open(path) as f:
    tree = ast.parse(f.read())

  def names(node):
    out = set()
    for t in node.targets:
      elts = t.elts if isinstance(t, ast.Tuple) else [t]
      out.update(e.id for e in elts if isinstance(e, ast.Name))
    return out

  body = [node for node in tree.body
          if isinstance(node, (ast.Import, ast.ImportFrom)) or
          (isinstance(node, ast.Assign) and
           names(node) <= {'SUB', 'LANE', 'CHUNK'}) or
          (isinstance(node, ast.FunctionDef) and node.name == 'kernel')]
  mod = types.ModuleType('bench_pallas_group_dma_kernel')
  exec(compile(ast.Module(body=body, type_ignores=[]), path, 'exec'),
       mod.__dict__)
  return mod


def test_rmw_plain_matches_group_dma_kernel():
  """bench_pallas_group_dma.kernel (x*0.999 + 0.001) in interpret mode on
  a small table (1,100 groups of W 384, 1,024 listed: two grid steps of
  its CHUNK) vs group_rmw_plain, within RMW_ATOL (FMA contraction)."""
  mod = _load_group_dma_kernel()
  assert (mod.SUB, mod.LANE, mod.CHUNK) == (8, 64, 512)
  groups, width, ns = 1100, 384, 1024
  rng = np.random.default_rng(0)
  table = rng.standard_normal((groups, 8, width)).astype(np.float32)
  sgids = np.sort(rng.choice(groups, ns, replace=False)).astype(np.int32)
  fn = pl.pallas_call(
      mod.kernel,
      grid=(ns // mod.CHUNK,),
      in_specs=[pl.BlockSpec((mod.SUB, mod.LANE), lambda i: (i, 0),
                             memory_space=pltpu.SMEM),
                pl.BlockSpec(memory_space=pl.ANY)],
      out_specs=pl.BlockSpec(memory_space=pl.ANY),
      out_shape=jax.ShapeDtypeStruct((groups, 8, width), jnp.float32),
      scratch_shapes=[pltpu.VMEM((mod.CHUNK, 8, width), jnp.float32),
                      pltpu.SemaphoreType.DMA, pltpu.SemaphoreType.DMA],
      input_output_aliases={1: 0},
      compiler_params=pltpu.CompilerParams(has_side_effects=True),
      interpret=True)
  want = fn(jnp.asarray(sgids).reshape(ns // mod.CHUNK * mod.SUB, mod.LANE),
            jnp.asarray(table))
  got = group_dma.group_rmw(torch.from_numpy(table.copy()),
                            torch.from_numpy(sgids), 0.999, 0.001)
  _assert_rmw_close(got, want, None)
  untouched = np.setdiff1d(np.arange(groups), sgids)
  assert np.array_equal(got.numpy()[untouched], table[untouched])


def test_rmw_plain_matches_make_kernel(interpret, monkeypatch):
  """bench_dma_issue.make_kernel(512) (per-copy waits) in interpret mode,
  its ids paged by its own page_ids with the scratch group of a small
  table, vs the port's make_kernel at its default shape (group_rmw_plain
  on the CPU); within RMW_ATOL, the scratch group excluded."""
  groups, ns = 1100, 700
  monkeypatch.setattr(j_dma_issue, 'SCRATCH_GID', groups - 1)
  rng = np.random.default_rng(1)
  table = rng.standard_normal((groups, 8, j_dma_issue.W)).astype(np.float32)
  ugids = np.sort(rng.choice(groups - 1, ns, replace=False)).astype(
      np.int32)
  gid3 = j_dma_issue.page_ids(ugids, 512)
  paged = t_dma_issue.page_ids(ugids, 512, groups - 1)
  assert np.array_equal(gid3.reshape(-1), paged)
  want = j_dma_issue.make_kernel(512)(jnp.asarray(gid3), jnp.asarray(table))
  got = t_dma_issue.make_kernel(64, 4)(torch.from_numpy(paged),
                                       torch.from_numpy(table.copy()))
  _assert_rmw_close(got, want, groups - 1)


@pytest.mark.parametrize('width', [128, 384])
def test_rmw_plain_matches_rmw_variant(interpret, width):
  """bench_packed_stages.rmw_variant (x*0.999 - 0.001*gg) in interpret
  mode vs the port's rmw_variant (group_rmw_plain on the CPU), with
  scratch pad slots; within RMW_ATOL, the scratch group excluded."""
  rng = np.random.default_rng(width)
  meta = types.SimpleNamespace(width=width)
  table, gids = _table_and_slots(rng, 400, width, 100, 28)
  gg = rng.standard_normal((gids.shape[0], 8, width)).astype(np.float32)
  want = j_stages.rmw_variant(jnp.asarray(table), jnp.asarray(gids),
                              jnp.asarray(gg), meta, 64)
  got = t_stages.rmw_variant(torch.from_numpy(table.copy()),
                             torch.from_numpy(gids), torch.from_numpy(gg))
  _assert_rmw_close(got, want, 399)


def test_rmw_plain_rounds_like_the_kernel():
  """The plain version rounds a*x and its sum separately (what K5 does
  with __fmul_rn / __fadd_rn), so it equals numpy's f32 ops bit for bit,
  for int32 and int64 ids alike."""
  rng = np.random.default_rng(5)
  table, gids = _table_and_slots(rng, 50, 128, 20, 0)
  gg = rng.standard_normal((20, 8, 128)).astype(np.float32)
  a, b, c = np.float32(0.999), np.float32(0.001), np.float32(-0.001)
  for idx in (torch.int32, torch.int64):
    got = group_dma.group_rmw(torch.from_numpy(table.copy()),
                              torch.from_numpy(gids).to(idx), 0.999, 0.001)
    want = table.copy()
    want[gids] = want[gids] * a + b
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    got = group_dma.group_rmw(torch.from_numpy(table.copy()),
                              torch.from_numpy(gids).to(idx), 0.999, 0.0,
                              gg=torch.from_numpy(gg), c=-0.001)
    want = table.copy()
    want[gids] = want[gids] * a + gg * c
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


# ------------------------------------------------------------- wrappers

def test_wrappers_take_plain_path_on_cpu_and_check_inputs():
  kernels.reset_launches()
  table = torch.zeros((10, 8, 128))
  gids = torch.tensor([1, 4], dtype=torch.int32)
  rows = torch.ones((2, 8, 128))
  group_dma.group_push(table, gids, rows)
  group_dma.group_rmw(table, gids, 2.0, 1.0, threads=1024, per_block=1)
  assert float(table[4].sum()) == 3.0 * 8 * 128
  assert kernels.launch_counts()['group_push'] == 0
  assert kernels.launch_counts()['group_rmw'] == 0
  with pytest.raises(TypeError):
    group_dma.group_push(table.double(), gids, rows)
  with pytest.raises(TypeError):
    group_dma.group_push(table, gids.float(), rows)
  with pytest.raises(ValueError):
    group_dma.group_push(table, gids, rows[:, :, :64])
  with pytest.raises(ValueError):
    group_dma.group_push(table.transpose(1, 2), gids, rows)
  with pytest.raises(ValueError):
    group_dma.group_rmw(table, gids, 0.5, 0.1, gg=rows)
  for threads, per_block in ((48, 1), (16, 1), (2048, 1), (256, 8),
                             (64, 0)):
    with pytest.raises(ValueError):
      group_dma.group_rmw(table, gids, 0.5, 0.0, threads=threads,
                          per_block=per_block)


@pytest.mark.parametrize('bad_id', [-1, 10])
@pytest.mark.parametrize('kernel', ['push', 'rmw'])
def test_ids_outside_the_table_raise_on_cpu(kernel, bad_id):
  """The plain versions raise IndexError at the call on an id outside
  [0, G), as check_ids does after K4 or K5 on the card; on the CPU
  check_ids has nothing to read."""
  table = torch.zeros((10, 8, 128))
  gids = torch.tensor([1, bad_id], dtype=torch.int32)
  rows = torch.ones((2, 8, 128))
  with pytest.raises(IndexError):
    if kernel == 'push':
      group_dma.group_push(table, gids, rows)
    else:
      group_dma.group_rmw(table, gids, 0.5, 0.1)
  group_dma.check_ids('cpu')


def test_kernel_registry_has_the_group_kernels():
  names = [k.name for k in kernels.ALL]
  assert names[-2:] == ['group_push', 'group_rmw']
  for k in kernels.ALL[-2:]:
    assert os.path.exists(k.source)
    assert k.source.endswith('.cu')


# ------------------------------------------- the benchmarks, end to end

def test_group_dma_and_dma_issue_mains_on_cpu(capsys):
  """Both K5 benchmarks at a small size on the CPU: every correctness
  line true; the CUDA default raises where CUDA is missing."""
  out = t_group_dma.main(['--device', 'cpu', '--groups', '1100', '--slots',
                          '300', '--reps', '2'])
  assert out['correct']
  out = t_dma_issue.main(['--device', 'cpu', '--groups', '1100', '--slots',
                          '300', '--iters', '1'])
  assert out['correct']
  assert [v[0][0] for v in out['variants']] == list('ABCDEFGHI')
  text = capsys.readouterr().out
  assert 'correct: True' in text and 'correct=False' not in text
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='cuda'):
      t_group_dma.main([])
