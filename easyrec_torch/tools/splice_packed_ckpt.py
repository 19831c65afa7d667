"""Rewrite a checkpoint of the port for another number of processes.

Counterpart of easyrec_tpu/tools/splice_packed_ckpt.py (docstring :1-27).
The port's checkpoints hold logical [rows, width] tables
(train/checkpoints.py): a world of W processes writes each rank's block of
the row-sharded tables (parallel/mesh.py row_split, the JAX package's
packed row split), and a restore at any world size re-splits them. This
tool does the same ahead of time, as the JAX tool re-encodes packed
groups: it reads every block of a step (weights, optimizer slots and EV
counters), checks the stamp's table geometry against the pipeline
config's, and writes the step again as `--target_devices` processes would,
the tables row-sharded or whole as the config's train_distribute says,
with the dense state as it was. Bit for bit: rows are only cut and joined.

    python -m easyrec_torch.tools.splice_packed_ckpt \
        --pipeline_config_path cfg.config \
        --ckpt_dir <model_dir with checkpoints/> \
        --output_dir <new model_dir> --target_devices 3 [--step N]

It needs no card and no world: it runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch


def splice(pipeline_config_path: str, ckpt_dir: str, output_dir: str,
           target_devices: int, step: int = None) -> str:
  """Write step `step` (default the latest) of ckpt_dir's checkpoints into
  output_dir/checkpoints/<step> for a world of target_devices; returns
  that directory."""
  from easyrec_torch.config import config_util
  from easyrec_torch.parallel import mesh
  from easyrec_torch.train import checkpoints as ckpt_lib
  from easyrec_torch.train.trainer import Trainer
  cdir = os.path.join(ckpt_dir, 'checkpoints')
  if not os.path.isdir(cdir):
    raise FileNotFoundError('%s has no checkpoints/ directory: not a '
                            'model_dir of the port' % ckpt_dir)
  steps = sorted(int(d) for d in os.listdir(cdir) if d.isdigit())
  if not steps:
    raise FileNotFoundError('no checkpoints under %s' % cdir)
  step = steps[-1] if step is None else int(step)
  step_dir = os.path.join(cdir, str(step))
  with open(os.path.join(step_dir, 'layout.json')) as f:
    stamp = json.load(f)
  cfg = config_util.get_configs_from_pipeline_file(pipeline_config_path)
  trainer = Trainer(cfg, device='cpu')
  # the tables' geometry must be the config's; the EV counters ride along
  ckpt_lib.check_stamp(stamp, dict(ckpt_lib.layout_stamp(trainer.metas),
                                   ev=stamp.get('ev', {})), step_dir)
  state = torch.load(os.path.join(step_dir, 'state.pt'), map_location='cpu',
                     weights_only=True, mmap=True)
  state = ckpt_lib.load_rows(state, stamp, step_dir, None)
  shard = cfg.train_config.train_distribute in mesh.SHARDING_STRATEGIES
  splits = {key: mesh.row_split(m.rows, m.dim, m.n_parts, target_devices)
            for key, m in trainer.metas.items()} if shard else {}
  out = os.path.join(output_dir, 'checkpoints', str(step))
  ckpt_lib.write_split(out, state, stamp,
                       ckpt_lib.ShardLayout(0, target_devices, splits))
  logging.info('spliced %s -> %s for %d processes (%s)', step_dir, out,
               target_devices, 'row-sharded' if splits else 'whole tables')
  return out


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__)
  ap.add_argument('--pipeline_config_path', required=True)
  ap.add_argument('--ckpt_dir', required=True)
  ap.add_argument('--output_dir', required=True)
  ap.add_argument('--target_devices', type=int, required=True)
  ap.add_argument('--step', type=int, default=None)
  args = ap.parse_args(argv)
  out = splice(args.pipeline_config_path, args.ckpt_dir, args.output_dir,
               args.target_devices, args.step)
  print('spliced checkpoint at %s' % out)
  return 0


if __name__ == '__main__':
  logging.basicConfig(level=logging.INFO)
  raise SystemExit(main())
