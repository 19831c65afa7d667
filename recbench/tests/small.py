"""Runs of the benchmark at a size the CPU holds: batch 64, tables of at
most 1,000 rows; every width as configured.

The DIN cell is held out of BENCHMARK.json (PERF.md, Open questions) and
its files stay under recbench/: the tests run it, beside the benchmark's
own cells, from a root whose BENCHMARK.json is the repository's with the
held cell added (bench_root)."""

import contextlib
import io
import json
import os

from recbench import run
from recbench.cell import REPO_DIR

SMALL = {'batch_size': 64, 'rows': 1000}
CELLS = ('deepfm_criteo.zipf_b131072',)
HELD = {
    'configs': [{
        'name': 'din_taobao',
        'source': 'https://github.com/alibaba/EasyRec/blob/master/examples/'
                  'configs/din_on_taobao.config',
        'file': 'recbench/configs/din_taobao.json', 'reduced': [],
        'why': 'target attention over two 50-long behaviour histories; '
               'a 620,311-row table updated by the fused kernel K3'}],
    'workloads': [{
        'name': 'din_taobao.hist50_b65536', 'config': 'din_taobao',
        'traffic': 'taobao_hist50_b65536', 'chips': 1,
        'why': 'two histories of 1-50 positions padded to 50: target '
               'attention, and K3'}],
}
HELD_CELLS = tuple(w['name'] for w in HELD['workloads'])


def bench_root(path: str) -> str:
  """`path` made a root: BENCHMARK.json with the held cells (every
  per-layer metric read in them too), recbench/ the repository's."""
  with open(os.path.join(REPO_DIR, 'BENCHMARK.json')) as f:
    bench = json.load(f)
  for key, entries in HELD.items():
    bench[key] = bench[key] + entries
  for m in bench['per_layer']:
    if 'workloads' in m:
      m['workloads'] = m['workloads'] + list(HELD_CELLS)
  with open(os.path.join(path, 'BENCHMARK.json'), 'w') as f:
    json.dump(bench, f)
  os.symlink(os.path.join(REPO_DIR, 'recbench'),
             os.path.join(path, 'recbench'))
  return str(path)


def run_line(workload, seed=7, trace=0, seconds=0.3, **kw):
  """(exit code, the last stdout line as JSON or None) of one CPU run."""
  out = io.StringIO()
  with contextlib.redirect_stdout(out), \
      contextlib.redirect_stderr(io.StringIO()):
    rc = run.main(['--workload', workload, '--seed', str(seed), '--seconds',
                   str(seconds), '--trace', str(trace)], device='cpu',
                  shrink=kw.pop('shrink', SMALL), **kw)
  lines = out.getvalue().strip().splitlines()
  return rc, (json.loads(lines[-1]) if lines else None)
