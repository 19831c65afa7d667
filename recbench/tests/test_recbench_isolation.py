"""What the benchmark runs imports neither jax, jaxlib, flax nor the JAX
package (top-level names compared whole: easyrec_torch is not
easyrec_tpu), reads no file under benchmarks/, and prints no result
without a card, with a forbidden module loaded, or without the port."""

import json
import os
import shutil
import subprocess
import sys

from recbench import run
from recbench.cell import REPO_DIR

RUN_SMALL = '''
import json, os, sys
opened = []
bench = os.path.join(%(repo)r, 'benchmarks') + os.sep

def hook(event, args):
  if event == 'open' and isinstance(args[0], str) and \\
      os.path.abspath(args[0]).startswith(bench):
    opened.append(args[0])

sys.addaudithook(hook)
%(before)s
from recbench import run
rc = run.main(['--workload', 'deepfm_criteo.zipf_b131072', '--seed', '5',
               '--seconds', '0.2', '--trace', '0'], device='cpu',
              shrink={'batch_size': 32, 'rows': 500}, root=%(root)r)
print(json.dumps({'rc': rc, 'opened': opened,
                  'modules': run.forbidden_modules(sys.modules)}))
'''


def _python(code, cwd=REPO_DIR):
  env = dict(os.environ, OMP_NUM_THREADS='2')
  return subprocess.run([sys.executable, '-c', code], cwd=cwd, env=env,
                        capture_output=True, text=True, timeout=600)


def test_top_level_names_compared_whole():
  assert run.forbidden_modules(['easyrec_torch.ops', 'jaxtyping',
                                'flaxen', 'easyrec_tpu_tools']) == []
  assert run.forbidden_modules(['easyrec_tpu.ops.embedding', 'jax',
                                'jaxlib.xla_client', 'flax.linen']) == \
      ['easyrec_tpu.ops.embedding', 'flax.linen', 'jax',
       'jaxlib.xla_client']


def test_a_run_loads_no_jax_and_reads_no_benchmarks_file():
  r = _python(RUN_SMALL % {'repo': REPO_DIR, 'root': REPO_DIR,
                           'before': ''})
  assert r.returncode == 0, r.stderr[-2000:]
  last = json.loads(r.stdout.strip().splitlines()[-1])
  assert last == {'rc': 0, 'opened': [], 'modules': []}
  assert '"correct": true' in r.stdout


def test_a_run_with_the_jax_package_loaded_prints_no_result():
  before = ('import types; sys.modules["easyrec_tpu"] = '
            'types.ModuleType("easyrec_tpu")')
  r = _python(RUN_SMALL % {'repo': REPO_DIR, 'root': REPO_DIR,
                           'before': before})
  last = json.loads(r.stdout.strip().splitlines()[-1])
  assert last['rc'] == 3 and '"correct"' not in r.stdout
  assert 'easyrec_tpu' in r.stderr


def test_no_card_no_result():
  r = subprocess.run([sys.executable, '-m', 'recbench.run', '--workload',
                      'deepfm_criteo.zipf_b131072', '--seed', '3',
                      '--seconds', '1', '--trace', '0'], cwd=REPO_DIR,
                     capture_output=True, text=True, timeout=300)
  import torch
  if torch.cuda.is_available():
    return          # this check is for a machine without a card
  assert r.returncode != 0 and r.stdout == ''
  assert 'is_available() is False' in r.stderr


def test_no_port_no_result(tmp_path):
  shutil.copy(os.path.join(REPO_DIR, 'BENCHMARK.json'), tmp_path)
  shutil.copytree(os.path.join(REPO_DIR, 'recbench'), tmp_path / 'recbench',
                  ignore=shutil.ignore_patterns('__pycache__'))
  r = _python(RUN_SMALL % {'repo': REPO_DIR, 'root': str(tmp_path),
                           'before': ''}, cwd=str(tmp_path))
  assert r.returncode != 0 and '"correct"' not in r.stdout
  assert 'easyrec_torch' in r.stderr
