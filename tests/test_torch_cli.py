"""The port's user surface on the CPU: the train CLI learns the fixture
data, CUDA is the default device and its absence raises, and importing and
running the port (every module, the ported benchmarks included, then the
DeepFM with its evaluate, export, predict, Predictor and server, the
DeepFM with Adagrad tables, the fused Taobao DIN, the MMoE and the
retrieval indexes and vector_retrieve CLI) loads nothing of JAX,
protobuf, pandas, pyarrow, the JAX package or its benchmarks/ scripts."""

import os
import re
import subprocess
import sys

import pytest
import torch

from easyrec_torch import device as t_device
from easyrec_torch.config import config_util as t_config
from easyrec_torch.train.trainer import Trainer
from tests import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, **kw):
  env = dict(os.environ)
  env['PYTHONPATH'] = REPO
  return subprocess.run([sys.executable] + args, cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=300, **kw)


def test_train_eval_cli_learns_on_cpu(tmp_path):
  path = fixtures.write_pipeline(tmp_path, num_steps=200)
  r = _run(['-m', 'easyrec_torch.train_eval', '--pipeline_config_path', path,
            '--device', 'cpu'])
  assert r.returncode == 0, r.stderr[-3000:]
  m = re.search(r"done: step=200 metrics=\{'auc': ([0-9.]+)", r.stderr)
  assert m is not None, r.stderr[-3000:]
  assert float(m.group(1)) > 0.75


def test_cuda_is_the_default_and_never_replaced_by_the_cpu(tmp_path):
  """Entry points run on CUDA unless asked for the CPU; where CUDA is
  missing they raise instead of carrying on on the CPU."""
  if torch.cuda.is_available():
    assert t_device.resolve_device(None).type == 'cuda'
    return
  with pytest.raises(RuntimeError, match='cuda'):
    t_device.resolve_device(None)
  cfg = t_config.get_configs_from_pipeline_file(
      fixtures.write_pipeline(tmp_path))
  with pytest.raises(RuntimeError, match='cuda'):
    Trainer(cfg)
  r = _run(['-m', 'easyrec_torch.train_eval', '--pipeline_config_path',
            os.path.join(tmp_path, 'pipeline.config')])
  assert r.returncode != 0 and 'torch.cuda.is_available() is False' in \
      r.stderr
  assert t_device.resolve_device('cpu') == torch.device('cpu')


ISOLATION = r'''
import importlib, pkgutil, sys
import easyrec_torch
for mod in pkgutil.walk_packages(easyrec_torch.__path__, 'easyrec_torch.'):
  importlib.import_module(mod.name)
import os
from easyrec_torch import main
from easyrec_torch.utils import flagship
result = main.train_and_evaluate(sys.argv[1], device='cpu',
                                 edit_config_json={'train_config.num_steps': 3})
assert result['global_step'] == 3
from easyrec_torch.export.predictor import Predictor
from easyrec_torch.serving.client import PredictClient
from easyrec_torch.serving.server import PredictorService
main.evaluate(sys.argv[1], device='cpu')
main.export(sys.argv[1], device='cpu',
            export_dir=os.path.join(os.path.dirname(sys.argv[1]), 'again'))
main.predict(sys.argv[1], device='cpu')
assert Predictor(result['export_dir'], device='cpu').predict([{}])
service = PredictorService(result['export_dir'], device='cpu')
service.start()
client = PredictClient('127.0.0.1:%d' % service.port)
assert client.predict([{'c1': 'u1'}])
client.close()
service.stop()
result = main.train_and_evaluate(
    flagship.criteo_deepfm_adagrad_config(batch_size=64,
                                          hash_bucket_size=1000),
    device='cpu', edit_config_json={'train_config.num_steps': 2})
assert result['global_step'] == 2
os.environ['EASYREC_PACKED_FUSED'] = '1'
result = main.train_and_evaluate(flagship.taobao_din_config(batch_size=64),
                                 device='cpu',
                                 edit_config_json={'train_config.num_steps': 2})
assert result['global_step'] == 2
os.environ['EASYREC_PACKED_FUSED'] = '0'
result = main.train_and_evaluate(flagship.taobao_mmoe_config(batch_size=64),
                                 device='cpu',
                                 edit_config_json={'train_config.num_steps': 2})
assert result['global_step'] == 2 and 'auc_cvr' in result['eval_metrics']
import numpy as np
from easyrec_torch.retrieval import knn, vector_retrieve
items = np.random.default_rng(0).standard_normal((50, 4)).astype(np.float32)
assert knn.KnnIndex(items, device='cpu').search(items[:3], 2)[1].shape == (3, 2)
assert knn.IvfIndex(items, n_clusters=4, device='cpu').search(items[:3], 2,
                                                              nprobe=4)
folder = os.path.dirname(sys.argv[1])
for name, rows in (('d.csv', items), ('q.csv', items[:3])):
  with open(os.path.join(folder, name), 'w') as f:
    f.write(''.join('r%d,%s\n' % (i, '|'.join(map(str, v)))
                    for i, v in enumerate(rows)))
assert vector_retrieve.main(
    ['--query_table', os.path.join(folder, 'q.csv'), '--doc_table',
     os.path.join(folder, 'd.csv'), '--output_table',
     os.path.join(folder, 'o.csv'), '--device', 'cpu']) == 0
banned = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pandas', 'pyarrow',
          'easyrec_tpu', 'benchmarks')
bad = sorted(m for m in sys.modules if m.split('.')[0] in banned or
             m == 'google.protobuf' or m.startswith('google.protobuf.'))
print('LOADED', bad)
sys.exit(1 if bad else 0)
'''


def test_port_loads_nothing_of_jax_or_the_jax_package(tmp_path):
  path = fixtures.write_pipeline(tmp_path, num_steps=3)
  r = _run(['-c', ISOLATION, path])
  assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
  assert 'LOADED []' in r.stdout
