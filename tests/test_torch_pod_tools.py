"""The port's multi-GPU pre-flight check and scaling model on the CPU.

aot_pod_check runs the row-sharded flagship step in gloo worlds of 4 and
3 processes with --device cpu and must pass its checks; the collective
byte counter (parallel/mesh.py's World) is held to an independent numpy count of
each rank's routed ids, and to the payloads of World's collectives; the
scaling model's projection equals the JAX scaling_model.project on the
same wire bytes and rates, and its CLI prints one JSON line a world and
asks for --step_ms where no card times the step."""

import io
import contextlib
import json

import numpy as np
import pytest
import torch

from easyrec_torch.tools import aot_pod_check
from easyrec_torch.tools import scaling_model as t_scaling
from easyrec_tpu.tools import scaling_model as j_scaling


@pytest.mark.parametrize('world', [4, 3])
def test_aot_pod_check_on_the_cpu(world):
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    rc = aot_pod_check.main(['--world', str(world), '--device', 'cpu'])
  lines = out.getvalue().strip().splitlines()
  assert rc == 0, lines
  summary = json.loads(lines[-1])
  assert summary['ok'] and not summary['failures']
  assert summary['ranks'] == world
  # one table: the pull's two legs and the update's two sends
  assert summary['all_to_all_calls'] == 4
  assert all(k['k1_exact'] and k['k2_exact'] for k in summary['kernels'])
  run, full = summary['bytes_run'], summary['bytes_full']
  assert run['params'] == full['params'] and run['opt'] == full['opt']
  assert full['table'] > 100 * run['table']
  shape = summary['owner_shapes']['emb16']
  assert 0 < shape['fill'] <= shape['slots']
  assert any(l.startswith('memory of rank 0 (the largest block) at full '
                          'width') for l in lines)
  assert any(l.startswith('bytes each rank holds') for l in lines)
  assert len(run['tables']) == world and run['table'] == run['tables'][0]


def test_pod_check_holds_bytes_to_the_tensors_and_counts_the_exchange():
  """Two settings' steps in one world (run_worlds, as chip_smoke.py runs
  both tools): for each, the reckoned bytes equal what every rank holds,
  every rank ran the exchange and the owner's K1 and K2 once in its step
  (each step's counts its own), and the loss is equal on every rank."""
  n = 3
  configs = [(16, 1000, 16), (32, 500, 16)]
  for (batch, buckets, dim), results in zip(
      configs, aot_pod_check.run_worlds(n, configs)):
    assert [r['rank'] for r in results] == list(range(n))
    for r in results:
      mine = aot_pod_check.reckon(n, batch, buckets, dim, r)
      assert mine['tables'][r['rank']] == r['table_bytes']
      assert mine['params'] == r['param_bytes']
      assert mine['opt'] == r['opt_bytes']
      assert r['traffic']['kinds']['all_to_all']['calls'] == 4
      assert len(r['calls']['seg_sum']) == 2
      assert len(r['calls']['rmw_rows']) == 1
      assert r['calls']['seg_sum'][0][0] == batch * 39
    assert len({r['loss']['total_loss'] for r in results}) == 1


def test_traffic_counter_against_numpy_routes():
  """Each rank's all_to_all bytes to and from each peer equal a numpy
  count of the step's routed ids: the distinct ids of the rank's batch,
  by owner (id // local_rows); the pull sends ids (int64) and gets rows
  (f32 x dim) back, the update sends ids and gradient sums."""
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.parallel import mesh
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils.synthetic import synthetic_batch
  n, batch, buckets = 4, 32, 1000
  results = aot_pod_check.run_world(n, batch, buckets)
  cfg = aot_pod_check.flagship(batch, buckets)
  tr = Trainer(cfg, device='cpu', world=None)
  (key, meta), = tr.metas.items()
  lr = mesh.row_split(meta.rows, meta.dim, meta.n_parts, n).local_rows
  routed = np.zeros((n, n), np.int64)          # [sender, owner] ids
  for r in range(n):
    packs = emb_ops.pack_all_views(tr.layout, to_device(synthetic_batch(
        tr.specs, list(cfg.data_config.label_fields), batch, seed=r),
        torch.device('cpu')))
    ids = np.unique(packs[key].numpy().reshape(-1))
    routed[r] = np.bincount(ids // lr, minlength=n)
  fwd, back = 8 + 8 + 4 * meta.dim, 4 * meta.dim
  for res in results:
    r = res['rank']
    peers = res['traffic']['peers']
    for p in range(n):
      assert peers[p]['sent'] == routed[r, p] * fwd + routed[p, r] * back
      assert peers[p]['recv'] == routed[p, r] * fwd + routed[r, p] * back
    kinds = res['traffic']['kinds']['all_to_all']
    assert kinds['sent'] == sum(peers[p]['sent'] for p in range(n))
    assert kinds['recv'] == sum(peers[p]['recv'] for p in range(n))
    assert res['traffic']['host_syncs'] == 2      # the two routes


def collectives(world):
  """World's collectives on known payloads; returns the traffic."""
  world.reset_traffic()
  world.all_reduce(torch.ones(10))
  world.all_gather(torch.ones(3, dtype=torch.int64))
  world.all_gather_rows(torch.ones((world.rank + 1, 2)))
  world.gather_objects({'rank': world.rank})
  return world.traffic()


def test_world_collectives_count_their_payloads():
  import pickle
  from easyrec_torch.parallel import launch
  n = 3
  out = launch.spawn('tests.test_torch_pod_tools:collectives', [], n,
                     device='cpu')
  top = n * 2 * 4                                 # 3 rows of 2 f32, max
  objs = sum(len(pickle.dumps({'rank': r})) for r in range(n))
  for r, t in enumerate(out):
    k = t['kinds']
    assert k['all_reduce'] == {'calls': 1, 'sent': 40, 'recv': 40}
    # the int64 [3] tensor, then all_gather_rows' sizes and padded rows
    assert k['all_gather'] == {'calls': 3, 'sent': 24 + 8 + top,
                               'recv': n * (24 + 8 + top)}
    assert k['all_gather_object'] == {
        'calls': 1, 'sent': len(pickle.dumps({'rank': r})), 'recv': objs}
    assert t['host_syncs'] == 1


@pytest.mark.parametrize('nodes', [1, 2, 4])
def test_projection_equals_the_jax_project(nodes, monkeypatch):
  wire = {'all_reduce': 2150048, 'all_gather': 4096,
          'all_to_all': 910928, 'broadcast_object': 0}
  monkeypatch.setattr(j_scaling, 'ICI_EFF_BPS', t_scaling.NVLINK_EFF_BPS)
  monkeypatch.setattr(j_scaling, 'DCN_EFF_BPS_PER_CHIP',
                      t_scaling.IB_EFF_BPS)
  monkeypatch.setattr(j_scaling, 'MEASURED_STEP_MS', {'step': 31.25})
  want = j_scaling.project(wire, nodes)
  got = t_scaling.project(wire, nodes, 31.25)
  assert got == pytest.approx(want, rel=1e-12)
  # the all_to_all split by node: its cross-node bytes over InfiniBand,
  # the rest of it over NVLink, the ring share as the JAX model's
  cross = 123456
  ring = sum(wire.values()) - wire['all_to_all']
  ring_cross = ring / nodes if nodes > 1 else 0.0
  comm = (ring - ring_cross + wire['all_to_all'] - cross) / \
      t_scaling.NVLINK_EFF_BPS + (ring_cross + cross) / t_scaling.IB_EFF_BPS
  step, ms = t_scaling.project(wire, nodes, 31.25, a2a_cross=cross)
  assert ms == pytest.approx(comm * 1e3, rel=1e-12)
  assert step == pytest.approx(31.25 + comm * 1e3, rel=1e-12)


def test_scaling_cli_prints_a_line_a_world(capsys):
  rc = t_scaling.main(['--worlds', '2,4', '--step_ms', '30', '--device',
                       'cpu', '--hash_buckets', '1000', '--batch_per_chip',
                       '64'])
  assert rc == 0
  lines = capsys.readouterr().out.strip().splitlines()
  recs = [json.loads(l) for l in lines]
  assert [r['gpus'] for r in recs] == [2, 4]
  for r in recs:
    for k in ('nodes', 'collective_counts', 'wire_bytes_per_chip',
              'projected_comm_ms', 'projected_step_ms',
              'projected_ex_s_per_chip', 'assumptions',
              'host_syncs_per_step'):
      assert k in r
    assert r['projected_step_ms'] > 30.0
    assert r['projected_ex_s_per_chip'] == pytest.approx(
        64 / r['projected_step_ms'] * 1e3)
    assert r['overflow'] == [0.0, 0.0]
    assert r['host_syncs_per_step'] == 2


def test_step_ms_is_required_without_a_card(capsys):
  with pytest.raises(SystemExit) as e:
    t_scaling.main(['--worlds', '2', '--device', 'cpu'])
  assert e.value.code == 2
  assert '--step_ms is required' in capsys.readouterr().err
  with pytest.raises(SystemExit):
    t_scaling.main(['--worlds', '2', '--device', 'cpu', '--measure'])


def test_no_tpu_constant_in_the_port():
  import inspect
  src = inspect.getsource(t_scaling) + inspect.getsource(aot_pod_check)
  for name in ('ICI_EFF_BPS', 'DCN_EFF_BPS', 'MEASURED_STEP_MS', 'v5e',
               'SCALING_ICI_BPS', 'SCALING_DCN_BPS'):
    assert name not in src
