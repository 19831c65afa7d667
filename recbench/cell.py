"""A cell of the benchmark, found by name.

BENCHMARK.json names the cell's configuration, traffic mix and chips;
recbench/workloads/<cell>.json holds its limits of `correct` and the
length of its traced stretch; recbench/configs/<config>.json and
recbench/traffic/<traffic>.json hold the rest. Metric readers and
reference models are Python files found the same way, by name, and loaded
from their path, so a later cell, configuration, traffic mix or metric is
added as files alone.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PACKAGE_DIR)


# feature kinds with no table: their values reach the model in the batch
TABLELESS = ('dense',)


def table_features(features: List[dict]) -> List[dict]:
  """The features that have a table (every kind but `dense`)."""
  return [f for f in features if f['kind'] not in TABLELESS]


def read_json(path: str) -> dict:
  with open(path) as f:
    return json.load(f)


def load_module(path: str):
  """The Python file at `path` as a module of its own (metric readers and
  reference models are found by file name, never listed in code)."""
  name = 'recbench_file_%s' % os.path.relpath(path, REPO_DIR).replace(
      os.sep, '_').replace('.', '_')
  if name in sys.modules:
    return sys.modules[name]
  spec = importlib.util.spec_from_file_location(name, path)
  if spec is None:
    raise FileNotFoundError(path)
  module = importlib.util.module_from_spec(spec)
  sys.modules[name] = module
  spec.loader.exec_module(module)
  return module


def _applies(metric: dict, cell: str) -> bool:
  return 'workloads' not in metric or cell in metric['workloads']


@dataclasses.dataclass
class Cell:
  """One entry of BENCHMARK.json's workloads with its files. `shrink`
  (tests on the CPU only) caps the batch and every table's rows; widths
  stay as the configuration states them."""
  name: str
  chips: int
  workload: dict
  config: dict
  traffic: dict
  end_to_end: List[dict]
  per_layer: List[dict]
  root: str
  shrink: Optional[dict] = None

  def path(self, *parts: str) -> str:
    return os.path.join(self.root, 'recbench', *parts)

  @property
  def batch_size(self) -> int:
    return int(self.traffic['batch_size'])

  def features(self) -> List[dict]:
    """The configuration's features (name, kind, rows, dims), rows capped
    under `shrink`."""
    cap = (self.shrink or {}).get('rows')
    out = []
    for f in self.config['model']['features']:
      f = dict(f)
      if cap and f.get('rows', 1) > cap:
        f['rows'] = cap
      out.append(f)
    return out

  def pipeline_config(self):
    """The pipeline config the port runs: configs/<config>.config, with
    the traffic's batch size (and, under `shrink`, its tables' rows
    capped)."""
    from easyrec_torch.config.config_util import (
        get_configs_from_pipeline_file)
    cfg = get_configs_from_pipeline_file(
        self.path('configs', self.config['pipeline_config']))
    cfg.data_config.batch_size = self.batch_size
    cap = (self.shrink or {}).get('rows')
    if cap:
      for fc in cfg.feature_config.features:
        if fc.hash_bucket_size > cap:
          fc.hash_bucket_size = cap
        if fc.num_buckets > cap:
          fc.num_buckets = cap
    return cfg

  def reference(self):
    """The configuration's plain reference, recbench/reference/<config>.py."""
    return load_module(self.path('reference', self.config['name'] + '.py'))

  def metric_reader(self, name: str):
    return load_module(self.path('metrics', name + '.py'))


def load_cell(name: str, root: str = REPO_DIR,
              shrink: Optional[Dict[str, int]] = None) -> Cell:
  """The cell `name` of <root>/BENCHMARK.json and its files under
  <root>/recbench."""
  bench = read_json(os.path.join(root, 'BENCHMARK.json'))
  entries = [w for w in bench['workloads'] if w['name'] == name]
  if not entries:
    raise KeyError('BENCHMARK.json has no workload %r (has %s)'
                   % (name, [w['name'] for w in bench['workloads']]))
  entry = entries[0]
  base = os.path.join(root, 'recbench')
  config = read_json(os.path.join(base, 'configs', entry['config'] + '.json'))
  traffic = read_json(os.path.join(base, 'traffic',
                                   entry['traffic'] + '.json'))
  workload = read_json(os.path.join(base, 'workloads', name + '.json'))
  if shrink and shrink.get('batch_size'):
    traffic = dict(traffic, batch_size=int(shrink['batch_size']))
  return Cell(name=name, chips=int(entry['chips']), workload=workload,
              config=config, traffic=traffic,
              end_to_end=[m for m in bench['end_to_end']
                          if _applies(m, name)],
              per_layer=[m for m in bench['per_layer'] if _applies(m, name)],
              root=root, shrink=shrink)
