"""Bucketize raw features: quantile boundaries from the training data.

Counterpart of easyrec_tpu/tools/add_boundaries_to_config.py: every
RawFeature without boundaries gets num_buckets - 1 quantiles of its
column over the first max_rows rows of the train input (read by the
config's own reader), each rounded to 6 decimals, duplicates dropped; the
config is written back (to --output_config_path, else in place).

  python -m easyrec_torch.tools.add_boundaries_to_config \
      --pipeline_config_path cfg --num_buckets 20 \
      [--output_config_path out.config]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def add_boundaries(pipeline_config, num_buckets: int = 20,
                   max_rows: int = 1_000_000) -> int:
  """Edit the config in place; returns the count of features bucketized."""
  from easyrec_torch.config import config_util
  from easyrec_torch.data.input_pipeline import create_reader
  from easyrec_torch.features import transforms as tr

  raw_feats = [fc for fc in config_util.get_feature_configs(pipeline_config)
               if fc.feature_type == 'RawFeature' and not fc.boundaries]
  if not raw_feats:
    return 0
  names = {fc.input_names[0] for fc in raw_feats}
  reader = create_reader(pipeline_config.data_config,
                         config_util.get_train_input_path(pipeline_config))
  samples = {n: [] for n in names}
  rows = 0
  for chunk in reader.chunks(65536):
    for n in names:
      if n in chunk:
        samples[n].append(tr.to_float(chunk[n]))
    rows += len(next(iter(chunk.values())))
    if rows >= max_rows:
      break
  changed = 0
  for fc in raw_feats:
    n = fc.input_names[0]
    if not samples[n]:
      continue
    vals = np.concatenate(samples[n])
    qs = np.quantile(vals, np.linspace(0, 1, num_buckets + 1)[1:-1])
    fc.boundaries = sorted(set(float(np.round(q, 6)) for q in qs))
    changed += 1
    logging.info('feature %s: %d boundaries %s...', n, len(fc.boundaries),
                 fc.boundaries[:4])
  return changed


def main(argv=None):
  logging.basicConfig(level=logging.INFO)
  parser = argparse.ArgumentParser()
  parser.add_argument('--pipeline_config_path', required=True)
  parser.add_argument('--output_config_path', default=None)
  parser.add_argument('--num_buckets', type=int, default=20)
  args = parser.parse_args(argv)
  from easyrec_torch.config import config_util
  config = config_util.get_configs_from_pipeline_file(
      args.pipeline_config_path)
  n = add_boundaries(config, args.num_buckets)
  out = args.output_config_path or args.pipeline_config_path
  config_util.save_pipeline_config(config, os.path.dirname(out) or '.',
                                   os.path.basename(out))
  logging.info('bucketized %d features -> %s', n, out)


if __name__ == '__main__':
  main()
