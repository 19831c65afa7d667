"""The port's user surface on the CPU: the train CLI learns the fixture
data, CUDA is the default device and its absence raises, and importing and
running the port (every module, the ported benchmarks included, then the
DeepFM with its evaluate, export, predict, Predictor and server, the
DeepFM with Adagrad tables, the fused Taobao DIN, the MMoE, the
retrieval indexes and vector_retrieve CLI, and the fg.json Taobao DIN
with its ComboFeature under check_mode, an ExprFeature of the text
functions, incremental updates and a big-model export they write into, then the
RTP, warehouse, Criteo-binary, Kafka and DataHub readers, the Kafka
trainer's data_offset.json, the tools and the HPO tuner, and a Parquet file
read with pyarrow and pandas blocked) loads nothing of JAX, protobuf,
pandas, pyarrow, the JAX package or its benchmarks/ scripts."""

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


class _Blocked:
  """pyarrow and pandas cannot be imported here: the port must not need
  them (the card's machine has neither)."""

  def find_spec(self, name, path=None, target=None):
    if name.split('.')[0] in ('pyarrow', 'pandas'):
      raise ImportError('%s is blocked in this test' % name)
    return None


sys.meta_path.insert(0, _Blocked())
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
# the multi-process slice: its modules, and the splice of this model_dir
from easyrec_torch.parallel import exchange, launch, mesh
from easyrec_torch.tools import splice_packed_ckpt
from easyrec_torch.utils import dryrun
here = os.path.dirname(sys.argv[1])
splice_packed_ckpt.splice(sys.argv[1], os.path.join(here, 'ckpt'),
                          os.path.join(here, 'spliced'), 2)
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
from easyrec_torch.config.config_util import get_configs_from_pipeline_str
from easyrec_torch.export import saved_model
from easyrec_torch.features import transforms as tr
from easyrec_torch.features.feature_spec import build_feature_spec
from easyrec_torch.train import incremental
cfg = main.load_config(os.path.join(os.getcwd(), 'samples',
                                    'taobao_fg.config'))
with open(os.path.join(folder, 'fg.csv'), 'w') as f:
  for i in range(64):
    f.write('%d,u%d,s1,g1,a1,o1,ad%d,c%d,b1,%.1f,t1|t2,c1|c2,b1\n'
            % (i % 2, i % 7, i % 5, i % 3, i * 3.5))
result = main.train_and_evaluate(cfg, device='cpu', check_mode=True,
                                 edit_config_json={
    'train_input_path': os.path.join(folder, 'fg.csv'),
    'eval_input_path': os.path.join(folder, 'fg.csv'),
    'model_dir': os.path.join(folder, 'fg_md'), 'train_config.num_steps': 2,
    'data_config.batch_size': 32, 'data_config.eval_batch_size': 32})
trainer = result['trainer']
big = saved_model.export_saved_model(trainer, os.path.join(folder, 'big'),
                                     big_model=True)
pub = incremental.IncrementalPublisher(
    get_configs_from_pipeline_str(
        'train_config { incr_save_config { fs {} } }')
    .train_config.incr_save_config, os.path.join(folder, 'fg_md'))
pub.publish(trainer, 2)
with __import__('torch').no_grad():
  for t in trainer.tables.values():
    t.mul_(2.0)
pub.publish(trainer, 3)
predictor = Predictor(big, device='cpu')
assert predictor.consume_incremental(pub.directory) == 1
assert predictor.predict([{'user_id': 'u1', 'cate_id': 'c1'}])
fc = get_configs_from_pipeline_str('feature_config { features { feature_name: "r" '
                      'input_names: "q" input_names: "t" feature_type: '
                      'ExprFeature expression: "query_common_ratio(q, t)" '
                      '} }').feature_config.features[0]
out = tr.build_transform(build_feature_spec(fc))(
    {'q': np.array(['a b'], object), 't': np.array(['b c'], object)})
assert out['feat.r.dense'][0, 0] == 0.5
# the readers and tools of the streaming slice
import json
from chip_smoke import MockBroker, small_criteo_rows
from tests.datahub_mock import MockDataHub
from easyrec_torch.data.input_pipeline import InputPipeline
from easyrec_torch.hpo.tuner import LocalTuner
from easyrec_torch.tools import (add_boundaries_to_config, convert_config_format,
                                 create_config_from_excel, criteo_convert,
                                 kafka_topic, pre_check, predict_and_chk,
                                 view_export)
from easyrec_torch.train.trainer import Trainer
rows = small_criteo_rows(300, 1)
names = ['label', 'F1', 'F2', 'F3'] + ['C%d' % i for i in range(1, 7)]
def small(edits):
  return main.load_config(flagship.criteo_deepfm_config(
      batch_size=64, hash_bucket_size=1000, num_dense=3, num_cat=6),
      dict({'data_config.shuffle': False, 'data_config.eval_batch_size': 64,
            'data_config.num_epochs': 1}, **edits))
config_util_mod = __import__('easyrec_torch.config.config_util',
                             fromlist=['x'])
def batches(cfg, path):
  return list(InputPipeline(cfg.data_config,
                            config_util_mod.get_feature_configs(cfg), path,
                            mode='eval'))
rtp = os.path.join(folder, 'd.rtp')
with open(rtp, 'w') as f:
  f.writelines('%s;%s\n' % (r[0], '\002'.join(r[1:])) for r in rows)
cfg = small({'data_config.input_type': 'RTPInput',
             'data_config.separator': '\002'})
assert sum(b['sample_weight'].sum() for b in batches(cfg, rtp)) == 300
os.makedirs(os.path.join(folder, 'wh', 'tbl'))
with open(os.path.join(folder, 'wh', 'tbl', 'p.csv'), 'w') as f:
  f.writelines(','.join(r) + '\n' for r in rows)
os.environ['EASYREC_WAREHOUSE_EXPORT_DIR'] = os.path.join(folder, 'wh')
cfg = small({'data_config.input_type': 'OdpsInputV2',
             'data_config.separator': ','})
assert sum(b['sample_weight'].sum() for b in batches(cfg, 'odps://p/tables/tbl')) == 300
with open(os.path.join(folder, 'day_0.tsv'), 'w') as f:
  f.writelines('\t'.join([r[0]] + r[1:4] + ['7'] * 10 + r[4:] + ['ffffffff'] * 20)
               + '\n' for r in rows)
criteo_convert.main(['--input_path', os.path.join(folder, 'day_0.tsv'),
                     '--output_dir', os.path.join(folder, 'bin')])
criteo = main.load_config(flagship.criteo_deepfm_config(
    batch_size=64, hash_bucket_size=1000), {
    'data_config.input_type': 'CriteoInput', 'data_config.num_epochs': 1,
    'train_input_path': os.path.join(folder, 'bin', 'day_0.bin'),
    'eval_input_path': os.path.join(folder, 'bin', 'day_0.bin'),
    'model_dir': os.path.join(folder, 'criteo_md'),
    'train_config.num_steps': 2})
assert pre_check.check_config(criteo) == [] == pre_check.check_data(criteo)
result = main.train_and_evaluate(criteo, device='cpu')
out = predict_and_chk.predict_and_check(
    result['export_dir'], os.path.join(folder, 'bin', 'day_0.bin'),
    os.path.join(folder, 'pred.csv'), device='cpu')
assert out['num_predictions'] == 300
assert view_export.describe_export(result['export_dir'])['num_parameters']
assert 0 < view_export.smoke_predict(result['export_dir'], device='cpu')['probs'] < 1
broker = MockBroker()
server = broker.start()
broker.create_topic('t', 2)
for p in (0, 1):
  kafka_topic.write_topic(server, 't', [','.join(r) for r in rows[p::2]],
                          partition=p)
os.environ['EASYREC_KAFKA_STOP_AT_END'] = '1'
kafka = small({'kafka_train_input': 'server: "%s" topic: "t"' % server,
               'data_config.separator': ',',
               'data_config.input_type': 'KafkaInput',
               'model_dir': os.path.join(folder, 'kafka_md'),
               'train_config.num_steps': 2})
assert Trainer(kafka, device='cpu').fit(eval_at_end=False)['global_step'] == 2
with open(os.path.join(folder, 'kafka_md', 'data_offset.json')) as f:
  assert sum(json.load(f)['offsets'].values()) == 128
broker.stop()
dh = MockDataHub()
endpoint = dh.start()
dh.create_topic('p', 't', [(n, 'STRING') for n in names], 2)
for i, r in enumerate(rows):
  dh.put('p', 't', i % 2, r)
os.environ['EASYREC_DATAHUB_STOP_AT_END'] = '1'
datahub = small({'datahub_train_input': 'akId: "a" akSecret: "s" region: "%s" '
                                        'project: "p" topic: "t"' % endpoint,
                 'data_config.input_type': 'DataHubInput'})
assert sum(b['sample_weight'].sum() for b in batches(
    datahub, datahub.datahub_train_input)) == 300
dh.stop()
cfg_path = os.path.join(folder, 'c.config')
config_util_mod.save_pipeline_config(criteo, folder, 'c.config')
convert_config_format.main(['--input_config', cfg_path, '--output_config',
                            os.path.join(folder, 'c.json')])
assert config_util_mod.get_configs_from_pipeline_file(
    os.path.join(folder, 'c.json')).data_config.input_type == 'CriteoInput'
assert add_boundaries_to_config.add_boundaries(
    small({'data_config.input_type': 'RTPInput',
           'data_config.separator': '\002', 'train_input_path': rtp})) == 3
with open(os.path.join(folder, 'f.csv'), 'w') as f:
  f.write('name,data_type,feature_type,hash_bucket_size,embedding_dim\n'
          'label,float,label,,\nuid,string,id,100,8\n')
create_config_from_excel.main(['--template', os.path.join(folder, 'f.csv'),
                               '--output_path', os.path.join(folder, 'x.config')])
tuned = small({'data_config.input_type': 'RTPInput',
               'data_config.separator': '\002', 'train_input_path': rtp,
               'eval_input_path': rtp, 'model_dir': os.path.join(folder, 'hpo'),
               'train_config.num_steps': 2})
assert LocalTuner(tuned, [{'name': 'model_config.deepfm.dnn.hidden_units',
                           'type': 'categorical', 'candidates': [[8]]}],
                  num_trials=1, device='cpu').run()['best'] is not None
# Parquet through the port's own decoder, pyarrow blocked: chip_smoke.py's
# writer makes the file, ParquetInput reads it back
from chip_smoke import write_parquet
pq_path = os.path.join(folder, 'd.parquet')
labels = np.arange(40) % 2
tags = np.array(['t%d' % (i % 7) for i in range(40)], dtype=object)
write_parquet(pq_path, [('label', 'int32', labels.astype(np.int32), None),
                        ('uid', 'string', tags, tags == 't3')],
              [(0, 25), (25, 40)], ['none', 'snappy'], ['uid'])
pq_cfg = get_configs_from_pipeline_str("""
data_config {
  batch_size: 16
  num_epochs: 1
  shuffle: false
  label_fields: "label"
  input_fields { input_name: "label" input_type: FLOAT }
  input_fields { input_name: "uid" input_type: STRING default_val: "none" }
  input_type: ParquetInput
}
feature_config {
  features { input_names: "uid" feature_type: IdFeature
             embedding_dim: 4 hash_bucket_size: 50 }
}""")
from easyrec_torch.config.config_util import get_feature_configs
pq_rows = [b for b in InputPipeline(pq_cfg.data_config,
                                    get_feature_configs(pq_cfg), pq_path,
                                    mode='eval')]
assert sum(int(b['sample_weight'].sum()) for b in pq_rows) == 40
assert [float(x) for x in pq_rows[0]['label.label'][:4]] == [0., 1., 0., 1.]
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
