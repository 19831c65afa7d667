"""Feature importance from a variational-dropout model's checkpoint.

Counterpart of easyrec_tpu/tools/feature_selection.py: the latest port
checkpoint under model_dir is restored into a Trainer on --device (CUDA by
default), and each VariationalDropout's logit_p gives its features'
importance 1 - sigmoid(logit_p), named by the features of the group the
layer drops (its backbone block's feature group, else the group of its
name), or `<layer>/dim_<i>` where they do not line up.

  python -m easyrec_torch.tools.feature_selection \
      --pipeline_config_path cfg --output_path report.json [--topk 50] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging


def feature_importance(pipeline_config, device=None) -> dict:
  """{feature name: importance in [0, 1]} of the latest checkpoint."""
  import numpy as np

  from easyrec_torch.convert import flax_names
  from easyrec_torch.train import checkpoints as ckpt_lib
  from easyrec_torch.train.trainer import Trainer

  trainer = Trainer(pipeline_config, device=device)
  trainer.init_state()
  mgr = ckpt_lib.CheckpointManager(pipeline_config.model_dir,
                                   layout_stamp=trainer.layout_stamp())
  restored = mgr.restore_latest()
  if restored is None:
    raise FileNotFoundError('no checkpoint under %s' %
                            pipeline_config.model_dir)
  trainer.load_state_dict(restored)
  state = trainer.model.state_dict()
  result = {}
  for name, (_, path) in flax_names(
      state, root=trainer.model.flax_root).items():
    keys = path.split('/')
    if keys[-1] != 'logit_p':
      continue
    logit = state[name].detach().cpu().numpy().astype(np.float64)
    importance = 1.0 - 1.0 / (1.0 + np.exp(-logit))
    block = next((k for k in keys if 'variational_dropout' in k), '')
    names = _group_feature_names(pipeline_config,
                                 block.replace('_variational_dropout', ''))
    if importance.ndim == 0 or len(names) != importance.shape[0]:
      for i, v in enumerate(np.atleast_1d(importance)):
        result['%s/dim_%d' % (block, i)] = float(v)
    else:
      for fname, v in zip(names, importance):
        result[fname] = float(v)
  if not result:
    raise ValueError('checkpoint has no variational_dropout parameters — '
                     'set model_config.variational_dropout and retrain')
  return result


def _group_feature_names(config, block_name: str):
  """The features behind an input_layer block: block -> its feature group
  -> the group's feature_names."""
  group_name = block_name
  mc = config.model_config
  if mc.HasField('backbone'):
    for b in mc.backbone.blocks:
      if b.name == block_name:
        if b.inputs and b.inputs[0].feature_group_name:
          group_name = b.inputs[0].feature_group_name
        break
  for g in mc.feature_groups:
    if g.group_name == group_name:
      return list(g.feature_names)
  return []


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--pipeline_config_path', required=True)
  parser.add_argument('--output_path', default=None)
  parser.add_argument('--topk', type=int, default=0)
  parser.add_argument('--device', default=None, help='cuda (default) or cpu')
  args = parser.parse_args(argv)
  from easyrec_torch.config import config_util
  config = config_util.get_configs_from_pipeline_file(
      args.pipeline_config_path)
  imp = feature_importance(config, args.device)
  ranked = sorted(imp.items(), key=lambda kv: -kv[1])
  if args.topk:
    ranked = ranked[:args.topk]
  for name, v in ranked:
    print('%s,%.6f' % (name, v))
  if args.output_path:
    with open(args.output_path, 'w') as f:
      json.dump(dict(ranked), f, indent=2)
    logging.info('wrote %s', args.output_path)


if __name__ == '__main__':
  main()
