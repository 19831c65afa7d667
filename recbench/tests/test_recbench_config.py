"""The configuration files against what they describe: each pipeline
config is the one easyrec_torch.utils.flagship builds at its cell's batch, the
reference's description agrees with it, the port's parameters are the
reference's, and BENCHMARK.json keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from easyrec_torch.config.config_util import get_configs_from_pipeline_file
from easyrec_torch.config.text_format import canonical
from easyrec_torch.train.trainer import Trainer
from easyrec_torch.utils import flagship
from recbench import harness
from recbench.cell import REPO_DIR, load_cell, read_json
from recbench.tests.small import CELLS, HELD_CELLS, SMALL

BUILDERS = {'deepfm_criteo': flagship.criteo_deepfm_config,
            'din_taobao': flagship.taobao_din_config}
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


@pytest.mark.parametrize('name', sorted(BUILDERS))
def test_pipeline_config_is_the_flagship(name, root):
  cfg = read_json(os.path.join(REPO_DIR, 'recbench', 'configs',
                               name + '.json'))
  text = get_configs_from_pipeline_file(os.path.join(
      REPO_DIR, 'recbench', 'configs', cfg['pipeline_config']))
  batch = int(text.data_config.batch_size)
  assert canonical(text) == canonical(BUILDERS[name](batch_size=batch))
  # the batch the cells' traffic sends
  assert batch in {load_cell(w, root).batch_size for w in CELLS + HELD_CELLS
                   if w.startswith(name + '.')}


@pytest.mark.parametrize('workload', CELLS + HELD_CELLS)
def test_description_agrees_with_the_pipeline_config(workload, root):
  cell = load_cell(workload, root)
  pc = cell.pipeline_config()
  feats = {f.input_names[0]: f for f in pc.feature_config.features}
  for f in cell.config['model']['features']:
    fc = feats[f['name']]
    assert int(fc.embedding_dim) == f['dim']
    rows = {'raw': 1, 'id': int(fc.hash_bucket_size or fc.num_buckets),
            'seq': int(fc.hash_bucket_size)}[f['kind']]
    assert rows == f['rows']
    if f['kind'] == 'seq':
      assert int(fc.max_seq_len) == f['max_len']
  mc = pc.model_config
  assert float(mc.embedding_regularization) == pytest.approx(
      cell.config['model']['embedding_regularization'])
  adam = pc.train_config.optimizer_config[0].adam_optimizer
  lr = adam.learning_rate.exponential_decay_learning_rate
  opt = cell.config['model']['optimizer']
  assert (adam.beta1, adam.beta2) == pytest.approx((opt['b1'], opt['b2']))
  assert (lr.initial_learning_rate, lr.decay_steps, lr.decay_factor,
          lr.min_learning_rate) == pytest.approx(
              (opt['initial_learning_rate'], opt['decay_steps'],
               opt['decay_factor'], opt['min_learning_rate']))
  # every feature the traffic draws is the configuration's
  assert set(cell.traffic['features']) == \
      {f['name'] for f in cell.config['model']['features']}


@pytest.mark.parametrize('workload', CELLS + HELD_CELLS)
def test_port_parameters_are_the_reference_s(workload, root):
  cell = load_cell(workload, root, SMALL)
  harness.set_environment(cell)
  trainer = Trainer(cell.pipeline_config(), device='cpu')
  trainer.init_state()
  model = harness.model_description(cell)
  assert {n: tuple(p.shape) for n, p in trainer.model.named_parameters()} \
      == {n: tuple(s) for n, s in
          cell.reference().param_shapes(model).items()}
  layout = cell.config['layout']
  for meta in trainer.metas.values():
    assert (meta.dim, meta.width) == (layout['weight_dim'],
                                      layout['row_floats'])


def test_benchmark_json_keeps_the_contract():
  with open(os.path.join(REPO_DIR, 'BENCHMARK.json')) as f:
    bench = json.load(f)
  assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                        'workloads', 'end_to_end', 'per_layer'}
  assert bench['paths'] == ['recbench']
  assert 1 <= bench['run_seconds'] <= 51
  names = [x['name'] for k in ('configs', 'workloads', 'end_to_end',
                               'per_layer') for x in bench[k]]
  assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
  base = os.path.join(REPO_DIR, 'recbench')
  for c in bench['configs']:
    assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    assert os.path.exists(os.path.join(REPO_DIR, c['file']))
    assert os.path.exists(os.path.join(base, 'reference', c['name'] + '.py'))
  four = 0
  for w in bench['workloads']:
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert len(w['why']) <= 200 and w['chips'] in (1, 4)
    four += w['chips'] == 4
    for path in (('workloads', w['name'] + '.json'),
                 ('traffic', w['traffic'] + '.json')):
      assert os.path.exists(os.path.join(base, *path))
  assert four <= max(1, len(bench['workloads']) // 4)
  e2e = {m['name'] for m in bench['end_to_end']}
  assert 'setup_s' in e2e
  for m in bench['end_to_end'] + bench['per_layer']:
    assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    assert os.path.exists(os.path.join(base, 'metrics', m['name'] + '.py'))
  for m in bench['end_to_end']:
    assert m['source'] in ('host_clock', 'device_trace')
    assert 0.01 <= m['bound'] <= 0.25
  for m in bench['per_layer']:
    assert m['moves'] in e2e and m['layer']
    if m['name'].endswith('_roofline') or 'mfu' in m['name']:
      assert m['unit'] == '%'
  assert len(json.dumps(bench)) < 64 * 1024
