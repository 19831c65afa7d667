"""Apply a feature-info table to a template pipeline config.

Counterpart of easyrec_tpu/tools/add_feature_info_to_config.py, with its
rules: a feature's info sets its embedding_dim, its boundaries (`boundary`
or `boundaries`) or else its hash_bucket_size; a feature whose message
holds 'DROP IT' leaves the feature configs, the feature groups and the
sequence attention maps; the rows `__NUM_STEPS__` and `__DECAY_STEPS__`
set train_config.num_steps and every learning rate's decay_steps. The
table is a JSON map or a CSV of feature,feature_info,message.

  {"fea1": {"embedding_dim": 16, "hash_bucket_size": 100000},
   "fea2": {"embedding_dim": 8, "boundary": [0, 1, 2]},
   "fea3": {"message": "DROP IT"},
   "__NUM_STEPS__": {"num_steps": 1000},
   "__DECAY_STEPS__": {"decay_steps": 100}}

  python -m easyrec_torch.tools.add_feature_info_to_config \
      --template_config_path in.config --output_config_path out.config \
      --feature_info_path info.json
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import os

from easyrec_torch.config import schema


def load_feature_info(path: str):
  """(info by feature name, names to drop)."""
  info_map, drops = {}, []
  if path.endswith('.csv'):
    with open(path, newline='') as f:
      for row in csv.DictReader(f):
        name = row['feature']
        info_map[name] = json.loads(row.get('feature_info') or '{}')
        if 'DROP IT' in (row.get('message') or ''):
          drops.append(name)
  else:
    with open(path) as f:
      raw = json.load(f)
    for name, info in raw.items():
      info_map[name] = info
      if 'DROP IT' in str(info.get('message', '')):
        drops.append(name)
  return info_map, drops


def apply_feature_info(pipeline_config, info_map, drop_names):
  """Edit the config in place by the table; returns it."""
  nested = bool(pipeline_config.feature_config.features)
  holder = pipeline_config.feature_config if nested else pipeline_config
  field = 'features' if nested else 'feature_configs'
  features = [fc for fc in getattr(holder, field)
              if fc.input_names[0] not in drop_names]
  setattr(holder, field, features)
  for fc in features:
    name = fc.input_names[0]
    info = info_map.get(name)
    if not info:
      continue
    if 'embedding_dim' in info:
      fc.embedding_dim = int(info['embedding_dim'])
    if 'boundary' in info or 'boundaries' in info:
      fc.boundaries = [float(v) for v in
                       info.get('boundary', info.get('boundaries'))]
    elif 'hash_bucket_size' in info:
      fc.hash_bucket_size = int(info['hash_bucket_size'])
    logging.info('edited feature %s: %s', name, info)
  tc = pipeline_config.train_config
  if '__NUM_STEPS__' in info_map:
    tc.num_steps = int(info_map['__NUM_STEPS__']['num_steps'])
  if '__DECAY_STEPS__' in info_map:
    steps = int(info_map['__DECAY_STEPS__']['decay_steps'])
    for oc in tc.optimizer_config:
      opt = getattr(oc, oc.WhichOneof('optimizer'))
      lr = getattr(opt.learning_rate,
                   opt.learning_rate.WhichOneof('learning_rate'))
      if schema.has_field(lr.type_name, 'decay_steps'):
        lr.decay_steps = steps
  mc = pipeline_config.model_config
  for group in mc.feature_groups:
    group.feature_names = [n for n in group.feature_names
                           if n not in drop_names]
  for seq_group in mc.seq_att_groups:
    for att in seq_group.seq_att_map:
      for name in ('key', 'hist_seq', 'aux_hist_seq'):
        setattr(att, name, [n for n in getattr(att, name)
                            if n not in drop_names])
  return pipeline_config


def main(argv=None):
  logging.basicConfig(level=logging.INFO)
  parser = argparse.ArgumentParser()
  parser.add_argument('--template_config_path', required=True)
  parser.add_argument('--output_config_path', required=True)
  parser.add_argument('--feature_info_path', required=True,
                      help='json map or csv(feature,feature_info,message)')
  args = parser.parse_args(argv)
  from easyrec_torch.config import config_util
  config = config_util.get_configs_from_pipeline_file(
      args.template_config_path)
  info_map, drops = load_feature_info(args.feature_info_path)
  apply_feature_info(config, info_map, drops)
  out_dir, out_name = os.path.split(args.output_config_path)
  config_util.save_pipeline_config(config, out_dir or '.', out_name)


if __name__ == '__main__':
  main()
