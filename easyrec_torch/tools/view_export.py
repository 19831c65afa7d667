"""Describe a port export: its meta, variables, KV tables and assets.

Counterpart of easyrec_tpu/tools/view_export.py for the bundle of
easyrec_torch/export/saved_model.py: the export_meta.json, every tensor of
variables/variables.pt by its state path ('model/...', 'tables/...') with
its shape and dtype, the parameter count, a big-model export's KV files
(under the JAX summary's `kv_store` key) and the assets. --smoke runs one
synthetic row (the JAX tool's: numbers uniform in [0, 1), ids `id_<n>`,
drawn from numpy's generator seeded 0) through the Predictor on --device
(CUDA by default).

  python -m easyrec_torch.tools.view_export --export_dir <dir> [--smoke]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from easyrec_torch.export.big_model import KV_DIR
from easyrec_torch.export.saved_model import (EXPORT_META, VARIABLES_DIR,
                                              VARIABLES_FILE)


def describe_export(export_dir: str) -> dict:
  """A JSON-able summary of the export."""
  import torch
  with open(os.path.join(export_dir, EXPORT_META)) as f:
    meta = json.load(f)
  summary = {'export_dir': export_dir, 'meta': meta}
  path = os.path.join(export_dir, VARIABLES_DIR, VARIABLES_FILE)
  if os.path.exists(path):
    state = torch.load(path, map_location='cpu', weights_only=True,
                       mmap=True)
    variables = {}

    def walk(prefix, node):
      if isinstance(node, torch.Tensor):
        variables[prefix] = {'shape': list(node.shape),
                             'dtype': str(node.dtype).replace('torch.', '')}
      elif isinstance(node, dict):
        for k, v in node.items():
          walk('%s/%s' % (prefix, k) if prefix else str(k), v)

    walk('', state)
    summary['variables'] = variables
    summary['num_parameters'] = int(sum(
        int(np.prod(v['shape'])) for v in variables.values()
        if v['shape']))
  kv_dir = os.path.join(export_dir, KV_DIR)
  if os.path.isdir(kv_dir):
    summary['kv_store'] = sorted(os.listdir(kv_dir))
  asset_dir = os.path.join(export_dir, 'assets')
  if os.path.isdir(asset_dir):
    summary['assets'] = sorted(os.listdir(asset_dir))
  return summary


def smoke_row(predictor) -> dict:
  """The JAX tool's synthetic row for the predictor's input columns."""
  rng = np.random.default_rng(0)
  dc = predictor.config.data_config
  labels = set(dc.label_fields)
  needed = set(predictor.input_names)
  row = {}
  for f in dc.input_fields:
    if f.input_name in labels or f.input_name not in needed:
      continue
    if f.input_type != 'STRING':
      row[f.input_name] = '%.3f' % rng.uniform()
    else:
      row[f.input_name] = 'id_%d' % rng.integers(0, 100)
  return row


def smoke_predict(export_dir: str, device=None) -> dict:
  """One synthetic row through the Predictor; its outputs."""
  from easyrec_torch.export.predictor import Predictor
  p = Predictor(export_dir, device=device)
  out = p.predict([smoke_row(p)])[0]
  return {k: (float(v) if np.isscalar(v) or getattr(v, 'ndim', 1) == 0
              else np.asarray(v).tolist()) for k, v in out.items()}


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--export_dir', required=True)
  parser.add_argument('--smoke', action='store_true',
                      help='run one synthetic row through the Predictor')
  parser.add_argument('--device', default=None,
                      help='cuda (default) or cpu, for --smoke')
  args = parser.parse_args(argv)
  summary = describe_export(args.export_dir)
  if args.smoke:
    summary['smoke_outputs'] = smoke_predict(args.export_dir, args.device)
  print(json.dumps(summary, indent=2, default=str))


if __name__ == '__main__':
  main()
