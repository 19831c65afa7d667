"""Checkpoints of the port across world sizes (train/checkpoints.py, the
counterpart of easyrec_tpu/tools/splice_packed_ckpt.py and
tests/test_cross_topology_ckpt.py) on the CPU, in gloo worlds.

A DeepFM with EV admission and compact Adam trains 2 steps in a world of 4
(row-sharded tables) and saves: each rank writes its block. A world of 3
restores it (re-splitting weights, Adam's bf16 moments and EV counters) and
saves again; a world of 4 restores that. Every table and counter must come
back bit for bit, both through those restores and through
tools/splice_packed_ckpt 4 -> 3 -> 4, whose output the worlds restore too;
a world of one device (no world) restores the sharded checkpoint whole.
The stamp's mismatches fail with a message naming the cause, as the JAX
package's tests require."""

import json
import os
import shutil

import pytest
import torch

from easyrec_torch.config import config_util as t_config
from easyrec_torch.parallel import launch
from easyrec_torch.tools import splice_packed_ckpt
from easyrec_torch.train import checkpoints as ckpt_lib
from easyrec_torch.train.trainer import Trainer
from easyrec_torch.utils import dryrun
from easyrec_torch.utils.synthetic import synthetic_batch


def config_text(directory: str) -> str:
  text = dryrun.case_config('packed_ev', directory, 8)
  return text.replace('model_dir: ""', 'model_dir: "%s"' % os.path.join(
      directory, 'md'))


def _whole(trainer):
  """The trainer's tables and EV counters, whole, on the CPU."""
  with trainer.unsharded():
    return ({k: v.clone() for k, v in trainer.tables.items()},
            {k: {n: t.clone() for n, t in aux.items()}
             for k, aux in trainer.ev_state.items()},
            {k: v.clone() for k, v in trainer.model.state_dict().items()},
            int(trainer.step))


def ckpt_worker(world, text, phase, model_dirs):
  """'train': 2 steps on this rank's rows, save at step 2 into
  model_dirs[0]; 'restore': restore each of model_dirs, return what was
  restored, and save the first into model_dirs[-1] + '_resaved'."""
  cfg = t_config.get_configs_from_pipeline_str(text)
  trainer = Trainer(cfg, world=world)
  trainer.init_state()
  if phase == 'train':
    for s in range(2):
      b = synthetic_batch(trainer.specs, ['label'], 8 * world.size, seed=s)
      n = 8
      trainer.step_batch({k: v[world.rank * n:(world.rank + 1) * n]
                          for k, v in b.items()})
    mgr = trainer.checkpoint_manager(model_dirs[0])
    trainer.save(mgr, 2)
    return [_whole(trainer)]
  out = []
  for d in model_dirs:
    trainer.init_state()
    trainer.load_state_dict(trainer.checkpoint_manager(d).restore_latest())
    out.append(_whole(trainer))
  trainer.init_state()
  trainer.load_state_dict(
      trainer.checkpoint_manager(model_dirs[0]).restore_latest())
  trainer.save(trainer.checkpoint_manager(model_dirs[0] + '_resaved'), 2)
  return out


def _equal(a, b):
  (ta, ea, ma, sa), (tb, eb, mb, sb) = a, b
  assert sa == sb == 2
  assert sorted(ta) == sorted(tb) and sorted(ea) == sorted(eb)
  for k in ta:
    assert torch.equal(ta[k], tb[k]), k
  for k in ea:
    for n in ea[k]:
      assert torch.equal(ea[k][n], eb[k][n]), (k, n)
  for k in ma:
    assert torch.equal(ma[k], mb[k]), k


@pytest.fixture(scope='module')
def round_trip(tmp_path_factory):
  root = str(tmp_path_factory.mktemp('parallel_ckpt'))
  text = config_text(root)
  cfg_path = os.path.join(root, 'pipeline.config')
  with open(cfg_path, 'w') as f:
    f.write(text)
  d4 = os.path.join(root, 'w4')
  (trained,) = launch.spawn('tests.test_torch_parallel_ckpt:ckpt_worker',
                            [text, 'train', [d4]], 4, timeout_s=120)[0]
  s3 = os.path.join(root, 's3')
  s34 = os.path.join(root, 's34')
  splice_packed_ckpt.splice(cfg_path, d4, s3, 3)
  splice_packed_ckpt.splice(cfg_path, s3, s34, 4)
  in3 = launch.spawn('tests.test_torch_parallel_ckpt:ckpt_worker',
                     [text, 'restore', [d4, s3]], 3, timeout_s=120)
  in4 = launch.spawn('tests.test_torch_parallel_ckpt:ckpt_worker',
                     [text, 'restore', [d4 + '_resaved', s34]], 4,
                     timeout_s=120)
  single = Trainer(t_config.get_configs_from_pipeline_str(text),
                   device='cpu')
  single.init_state()
  single.load_state_dict(single.checkpoint_manager(s3).restore_latest())
  return {'trained': trained, 'in3': in3, 'in4': in4,
          'single': _whole(single), 'root': root, 'cfg': cfg_path,
          'dirs': {'w4': d4, 's3': s3, 's34': s34}}


@pytest.mark.parametrize('where', ['restored_at_3', 'spliced_to_3',
                                   'resaved_at_3_restored_at_4',
                                   'spliced_back_to_4', 'one_device'])
def test_round_trip_4_3_4_is_bit_exact(round_trip, where):
  want = round_trip['trained']
  assert want[1]['emb8']['ev_count'].sum() > 0    # counters were written
  got = {'restored_at_3': lambda: round_trip['in3'][0][0],
         'spliced_to_3': lambda: round_trip['in3'][0][1],
         'resaved_at_3_restored_at_4': lambda: round_trip['in4'][0][0],
         'spliced_back_to_4': lambda: round_trip['in4'][0][1],
         'one_device': lambda: round_trip['single']}[where]()
  _equal(got, want)


def test_each_rank_writes_its_rows(round_trip):
  """The world of 4 wrote state.pt (rank 0: dense state and its block) and
  shard-1..3.pt, and the stamp records the split; the splice to 3 wrote 3
  files with its own split."""
  for name, size in (('w4', 4), ('s3', 3), ('s34', 4)):
    step = os.path.join(round_trip['dirs'][name], 'checkpoints', '2')
    files = sorted(os.listdir(step))
    assert files == sorted(['layout.json', 'state.pt'] + [
        'shard-%d.pt' % r for r in range(1, size)]), files
    with open(os.path.join(step, 'layout.json')) as f:
      world = json.load(f)['world']
    assert world['size'] == size
    for key, starts in world['rows'].items():
      assert starts[0] == 0 and starts == sorted(starts)
      assert starts[-1] == round_trip['trained'][0][key].shape[0]


def test_missing_shard_fails_pointed(round_trip, tmp_path):
  bad = str(tmp_path / 'bad')
  shutil.copytree(round_trip['dirs']['w4'], bad)
  os.remove(os.path.join(bad, 'checkpoints', '2', 'shard-2.pt'))
  t = Trainer(t_config.get_configs_from_pipeline_str(
      open(round_trip['cfg']).read()), device='cpu')
  t.init_state()
  with pytest.raises(ckpt_lib.LayoutMismatchError,
                     match=r'world of 4 processes.*shard-2\.pt'):
    t.checkpoint_manager(bad).restore_latest()


@pytest.mark.parametrize('via', ['restore', 'splice'])
def test_stale_layout_fails_pointed(round_trip, tmp_path, monkeypatch, via):
  """A compact-Adam checkpoint into a trainer (or a splice) whose layout
  is 3-part names EASYREC_PACKED_COMPACT and the fine-tune way out
  (tests/test_cross_topology_ckpt.py:89-114)."""
  monkeypatch.setenv('EASYREC_PACKED_COMPACT', '0')
  if via == 'splice':
    with pytest.raises(ckpt_lib.LayoutMismatchError,
                       match='EASYREC_PACKED_COMPACT.*fine_tune'):
      splice_packed_ckpt.splice(round_trip['cfg'], round_trip['dirs']['w4'],
                                str(tmp_path / 'out'), 2)
    return
  t = Trainer(t_config.get_configs_from_pipeline_str(
      open(round_trip['cfg']).read()), device='cpu')
  t.init_state()
  with pytest.raises(ckpt_lib.LayoutMismatchError,
                     match='EASYREC_PACKED_COMPACT.*fine_tune'):
    t.checkpoint_manager(round_trip['dirs']['w4']).restore_latest()


def test_splice_of_no_checkpoint_fails_pointed(round_trip, tmp_path):
  with pytest.raises(FileNotFoundError, match='no checkpoints/'):
    splice_packed_ckpt.splice(round_trip['cfg'], str(tmp_path),
                              str(tmp_path / 'o'), 3)


def test_splice_cli(round_trip, tmp_path, capsys):
  out = str(tmp_path / 'cli')
  assert splice_packed_ckpt.main([
      '--pipeline_config_path', round_trip['cfg'],
      '--ckpt_dir', round_trip['dirs']['w4'], '--output_dir', out,
      '--target_devices', '2', '--step', '2']) == 0
  assert 'spliced checkpoint at' in capsys.readouterr().out
  t = Trainer(t_config.get_configs_from_pipeline_str(
      open(round_trip['cfg']).read()), device='cpu')
  t.init_state()
  t.load_state_dict(t.checkpoint_manager(out).restore_latest())
  _equal(_whole(t), round_trip['trained'])
