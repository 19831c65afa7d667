"""A cell, a traffic mix and a metric added as files alone: a copy of the
benchmark gains them with no line of code edited, and the harness finds
and runs them by name."""

import json
import os
import shutil

from recbench.cell import REPO_DIR
from recbench.tests.small import run_line


def test_cell_from_files_alone(tmp_path):
  shutil.copy(os.path.join(REPO_DIR, 'BENCHMARK.json'), tmp_path)
  shutil.copytree(os.path.join(REPO_DIR, 'recbench'), tmp_path / 'recbench',
                  ignore=shutil.ignore_patterns('__pycache__', 'tests'))
  base = tmp_path / 'recbench'
  traffic = json.loads((base / 'traffic' /
                        'criteo_zipf_b131072.json').read_text())
  for p in traffic['features'].values():
    if p['draw'] == 'power_law':
      p['exponent'] = 0.0             # uniform over each column's ids
  traffic['name'] = 'criteo_uniform_b131072'
  (base / 'traffic' / 'criteo_uniform_b131072.json').write_text(
      json.dumps(traffic))
  workload = json.loads((base / 'workloads' /
                         'deepfm_criteo.zipf_b131072.json').read_text())
  workload['name'] = 'deepfm_criteo.uniform_b131072'
  (base / 'workloads' / 'deepfm_criteo.uniform_b131072.json').write_text(
      json.dumps(workload))
  (base / 'metrics' / 'window_steps.py').write_text(
      'def read(run):\n  return run.window["steps"]\n')
  bench = json.loads((tmp_path / 'BENCHMARK.json').read_text())
  bench['workloads'].append({
      'name': 'deepfm_criteo.uniform_b131072', 'config': 'deepfm_criteo',
      'traffic': 'criteo_uniform_b131072', 'chips': 1,
      'why': 'uniform ids: the sparse update touches the most rows'})
  bench['end_to_end'].append({
      'name': 'window_steps', 'unit': 'steps', 'better': 'higher',
      'bound': 0.05, 'source': 'host_clock',
      'workloads': ['deepfm_criteo.uniform_b131072']})
  (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
  rc, line = run_line('deepfm_criteo.uniform_b131072', root=str(tmp_path))
  assert rc == 0 and line['correct'] is True
  assert line['metrics']['window_steps']['value'] == line['attempted']
  # the old cells do not report the new metric
  rc, line = run_line('deepfm_criteo.zipf_b131072', root=str(tmp_path))
  assert rc == 0 and 'window_steps' not in line['metrics']
