"""Incremental updates, the big-model export and the events files of the
port on the CPU: a publisher's update equals the re-export of the state it
came from (file, Kafka and DataHub channels, the last two through the
repo's in-process mocks), the step gating and half-written updates, the
server's --incr_dir polling; updates cross between the packages (a JAX
update consumed by the port's Predictor and the reverse: same ids, equal
values); a big-model Predictor bit-equal to the in-memory one, within
1e-5 of the JAX big-model Predictor on the same weights, and the Redis
transport through a dict-backed client; the trainer's events files read
by the JAX package's iter_events with the JAX trainer's tags and steps."""

import glob
import itertools
import json
import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch

from easyrec_torch import main as t_main
from easyrec_torch.config import config_util as t_config
from easyrec_torch.export import big_model as t_bm
from easyrec_torch.export import predictor as t_predictor
from easyrec_torch.export import saved_model as t_sm
from easyrec_torch.serving.server import PredictorService
from easyrec_torch.train import incremental as t_incr
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.export import big_model as j_bm
from easyrec_tpu.export import predictor as j_predictor
from easyrec_tpu.export import saved_model as j_sm
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.train import incremental as j_incr
from easyrec_tpu.train.trainer import Trainer as JTrainer
from easyrec_tpu.utils import summary_writer as j_summary
from tests import fixtures
from tests.test_torch_match_train import _carry_state

BN_BODY = fixtures.DEEPFM_BODY.replace('use_bn: false', 'use_bn: true')


def _columns(tmp, n=64):
  """The fixture's eval rows as request columns."""
  cols = {k: [] for k in ('d1', 'd2', 'c1', 'c2', 'c3')}
  with open(os.path.join(str(tmp), 'eval.csv')) as f:
    for line in itertools.islice(f, n):
      _, d1, d2, c1, c2, c3 = line.rstrip('\n').split(',')
      for k, v in zip(cols, (float(d1), float(d2), c1, c2, c3)):
        cols[k].append(v)
  return {k: np.asarray(v) if k[0] == 'd' else np.asarray(v, dtype=object)
          for k, v in cols.items()}


def _port(tmp, body=fixtures.DEEPFM_BODY, **incr):
  """A port Trainer on the fixture data with incr_save_config's channel
  `incr` (fs by default), its state initialised, and its first batch."""
  cfg = t_config.get_configs_from_pipeline_file(
      fixtures.write_pipeline(tmp, model_body=body, num_steps=40))
  ic = cfg.train_config.incr_save_config
  if not incr:
    ic.fs = ic.fs
  for name, value in incr.items():
    ch, field = name.split('__')
    msg = getattr(ic, ch)
    setattr(msg, field, value)
    setattr(ic, ch, msg)
  cfg.train_config.incr_save_config = ic
  tt = TTrainer(cfg, device='cpu')
  tt.init_state()
  batch = to_device(next(iter(tt.train_input())), torch.device('cpu'))
  return tt, batch


def _steps(tt, batch, n):
  for _ in range(n):
    tt.train_step(batch)


def _equal_outputs(a, b):
  assert sorted(a) == sorted(b)
  for k in a:
    assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


@pytest.mark.parametrize('bn', [False, True])
def test_file_channel_equals_a_re_export(tmp_path, bn):
  """Export, publish the base, train, publish twice; the Predictor of the
  early export that consumed both answers bit-equal to a re-export of the
  trained state (BatchNorm's statistics travel as batch_stats/), and
  consumes nothing twice."""
  tt, batch = _port(tmp_path, BN_BODY if bn else fixtures.DEEPFM_BODY)
  early = t_sm.export_saved_model(tt, str(tmp_path / 'early'))
  pub = t_incr.IncrementalPublisher(tt.train_config.incr_save_config,
                                    tt.model_dir)
  assert pub.directory == os.path.join(tt.model_dir, 'incr_save')
  assert pub.publish(tt, 0) is None
  _steps(tt, batch, 3)
  first = pub.publish(tt, 3)
  _steps(tt, batch, 2)
  second = pub.publish(tt, 5)
  assert [os.path.basename(p) for p in t_incr.list_updates(pub.directory)] \
      == ['update-000001-step-3.npz', 'update-000002-step-5.npz']
  assert os.path.basename(first) == 'update-000001-step-3.npz'
  meta = _read_json(second + '.meta')
  assert meta['step'] == 5 and meta['version'] == 1
  blob = t_incr.read_update(second)
  assert any(k.startswith('batch_stats/') for k in blob) == bn
  assert sorted(meta['dense']) == sorted(k[len('dense/'):] for k in blob
                                         if k.startswith('dense/'))
  ids = blob['sparse_ids/' + next(iter(tt.metas))]
  batch_rows = np.unique(_batch_rows(tt, batch))
  np.testing.assert_array_equal(ids, batch_rows)
  cols = _columns(tmp_path)
  p = t_predictor.Predictor(early, device='cpu')
  stale = p.predict_columns(cols)
  assert p.consume_incremental(pub.directory) == 2
  fresh = p.predict_columns(cols)
  assert not np.array_equal(stale['probs'], fresh['probs'])
  full = t_predictor.Predictor(
      t_sm.export_saved_model(tt, str(tmp_path / 'full')), device='cpu')
  _equal_outputs(fresh, full.predict_columns(cols))
  assert p.consume_incremental(pub.directory) == 0


def _read_json(path):
  with open(path) as f:
    return json.load(f)


def _batch_rows(tt, batch):
  """The fused table's rows the batch's ids reach."""
  from easyrec_torch.ops import embedding as emb_ops
  (key, pack), = emb_ops.pack_ids(tt.layout, batch).items()
  return pack.reshape(-1).numpy()


def test_step_gating_and_half_written_update(tmp_path):
  """An update stamped at or before the export's step is consumed
  unapplied; a half-written one stops the sweep unconsumed and applies
  at the next poll once whole."""
  tt, batch = _port(tmp_path)
  _steps(tt, batch, 4)
  export = t_sm.export_saved_model(tt, str(tmp_path / 'exp'))
  pub = t_incr.IncrementalPublisher(tt.train_config.incr_save_config,
                                    tt.model_dir)
  pub.publish(tt, 0)
  with torch.no_grad():
    for t in tt.tables.values():
      t.add_(1.0)
  old = pub.publish(tt, 2)
  _steps(tt, batch, 2)
  new = pub.publish(tt, 6)
  shutil.copy(new, new + '.bak')
  with open(new, 'r+b') as f:
    f.truncate(100)
  p = t_predictor.Predictor(export, device='cpu')
  assert p.consume_incremental(pub.directory) == 0
  assert old in p._consumed and new not in p._consumed
  shutil.copy(new + '.bak', new)
  assert p.consume_incremental(pub.directory) == 1
  key, meta = next(iter(tt.metas.items()))
  rows = t_incr.read_update(new)['sparse_ids/' + key]
  np.testing.assert_array_equal(p.tables[key][rows],
                                tt.tables[key][rows, :meta.dim])


def test_server_polls_the_update_directory(tmp_path):
  tt, batch = _port(tmp_path)
  export = t_sm.export_saved_model(tt, str(tmp_path / 'exp'))
  pub = t_incr.IncrementalPublisher(tt.train_config.incr_save_config,
                                    tt.model_dir)
  pub.publish(tt, 0)
  service = PredictorService(export, device='cpu', incr_dir=pub.directory,
                             incr_poll_secs=0.05)
  service.start()
  try:
    _steps(tt, batch, 2)
    pub.publish(tt, 2)
    deadline = time.time() + 30
    while service.status()['updates_applied'] < 1 and \
        time.time() < deadline:
      time.sleep(0.05)
    assert service.status()['updates_applied'] == 1
  finally:
    service.stop()
  assert not any(t.is_alive() for t in service._threads)


def test_kafka_channel(tmp_path):
  from tests.kafka_mock import MockBroker
  broker = MockBroker()
  broker.start()
  try:
    server = '127.0.0.1:%d' % broker.port
    tt, batch = _port(tmp_path, kafka__server=server,
                      kafka__topic='incr_updates')
    early = t_sm.export_saved_model(tt, str(tmp_path / 'early'))
    pub = t_incr.IncrementalPublisher(tt.train_config.incr_save_config,
                                      tt.model_dir)
    assert pub.publish(tt, 0) is None
    _steps(tt, batch, 2)
    assert pub.publish(tt, 2) == 'incr_updates@0'
    _steps(tt, batch, 2)
    assert pub.publish(tt, 4) == 'incr_updates@1'
    pub.close()
    p = t_predictor.Predictor(early, device='cpu')
    assert p.consume_incremental_kafka(server, 'incr_updates') == 2
    full = t_predictor.Predictor(
        t_sm.export_saved_model(tt, str(tmp_path / 'full')), device='cpu')
    cols = _columns(tmp_path)
    _equal_outputs(p.predict_columns(cols), full.predict_columns(cols))
    assert p.consume_incremental_kafka(server, 'incr_updates') == 0
  finally:
    broker.stop()


def test_datahub_channel(tmp_path, monkeypatch):
  from tests.datahub_mock import MockDataHub
  # records of 4 KiB: an update spans several, reassembled in order
  monkeypatch.setattr(t_incr, 'DATAHUB_CHUNK', 4096)
  dh = MockDataHub()
  dh.create_topic('p', 'incr', [('key', 'STRING'), ('part', 'STRING'),
                                ('total', 'STRING'), ('payload', 'STRING')],
                  shards=1)
  endpoint = dh.start()
  try:
    tt, batch = _port(tmp_path, datahub__region=endpoint,
                      datahub__akId='ak', datahub__akSecret='sk',
                      datahub__project='p', datahub__topic='incr')
    early = t_sm.export_saved_model(tt, str(tmp_path / 'early'))
    pub = t_incr.IncrementalPublisher(tt.train_config.incr_save_config,
                                      tt.model_dir)
    pub.publish(tt, 0)
    _steps(tt, batch, 2)
    assert pub.publish(tt, 2) == 'p/incr:update-000001-step-2'
    _steps(tt, batch, 2)
    pub.publish(tt, 4)
    records = dh.topics[('p', 'incr')]['shards']['0']
    assert len(records) > 2 and int(records[0][2]) > 1
    p = t_predictor.Predictor(early, device='cpu')
    assert p.consume_incremental_datahub(endpoint, 'ak', 'sk', 'p',
                                         'incr') == 2
    full = t_predictor.Predictor(
        t_sm.export_saved_model(tt, str(tmp_path / 'full')), device='cpu')
    cols = _columns(tmp_path)
    _equal_outputs(p.predict_columns(cols), full.predict_columns(cols))
    assert p.consume_incremental_datahub(endpoint, 'ak', 'sk', 'p',
                                         'incr') == 0
  finally:
    dh.stop()


# -------------------------------------------------- across the two packages


@pytest.fixture()
def both(tmp_path, monkeypatch):
  """A JAX Trainer (packed compact tables) and a port Trainer holding its
  initial state, with the JAX export of that state, on the fixture data;
  plus the batch both train on."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', '0')
  path = fixtures.write_pipeline(tmp_path, num_steps=10, n_train=512,
                                 n_eval=128)
  j_cfg = j_config.get_configs_from_pipeline_file(path)
  j_cfg.train_config.incr_save_config.fs.incr_save_dir = 'incr_save'
  jt = JTrainer(j_cfg, devices=jax.devices('cpu')[:1])
  t_cfg = t_config.get_configs_from_pipeline_file(path)
  tt = TTrainer(t_cfg, device='cpu')
  batch = next(iter(jt.train_input()))
  state = jt.init_state(batch)
  _carry_state(jt, state, tt)
  return {'jt': jt, 'tt': tt, 'state': state, 'batch': batch,
          'tmp': tmp_path, 'j_cfg': j_cfg}


def _jax_params(state):
  return {'/'.join(str(p.key) for p in path): np.asarray(leaf)
          for path, leaf in jax.tree_util.tree_leaves_with_path(
              state.params)}


def test_a_jax_update_serves_in_the_port(both):
  jt, tt, state = both['jt'], both['tt'], both['state']
  early = t_sm.export_saved_model(tt, str(both['tmp'] / 'early'))
  pub = j_incr.IncrementalPublisher(both['j_cfg'].train_config
                                    .incr_save_config, str(both['tmp']),
                                    pack_metas=jt.pack_metas)
  pub.publish(state, 0)
  for _ in range(3):
    state, _ = jt.train_step(state, jt.rules.shard_batch(both['batch']))
  path = pub.publish(state, 3)
  p = t_predictor.Predictor(early, device='cpu')
  assert p.consume_incremental(pub.directory) == 1
  blob = np.load(path)
  for key, meta in jt.pack_metas.items():
    rows = tt.metas[key].rows
    want = jpt.unpack_host(np.asarray(state.tables[key]), meta, rows)[0]
    ids = blob['sparse_ids/' + key]
    assert ids.size and (ids < rows).all()
    np.testing.assert_array_equal(p.tables[key].numpy(), want[:rows])
  got = t_incr.dense_arrays(p.model)['params']
  want = _jax_params(state)
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_port_update_serves_in_jax(both):
  jt, tt, state = both['jt'], both['tt'], both['state']
  early = j_sm.export_saved_model(jt, state, str(both['tmp'] / 'jax'))
  ic = t_config.get_configs_from_pipeline_str(
      'train_config { incr_save_config { fs { incr_save_dir: "port_incr" } '
      '} }').train_config.incr_save_config
  pub = t_incr.IncrementalPublisher(ic, str(both['tmp']))
  pub.publish(tt, 0)
  batch = to_device(both['batch'], torch.device('cpu'))
  _steps(tt, batch, 3)
  pub.publish(tt, 3)
  jp = j_predictor.Predictor(early)
  assert jp.consume_incremental(pub.directory) == 1
  for key, meta in tt.metas.items():
    got = np.asarray(jp.state['tables'][key])[:meta.rows]
    np.testing.assert_array_equal(got, tt.tables[key][:, :meta.dim].numpy())
  got = {'/'.join(str(p.key) for p in path): np.asarray(leaf)
         for path, leaf in jax.tree_util.tree_leaves_with_path(
             jp.state['params'])}
  want = t_incr.dense_arrays(tt.model)['params']
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -------------------------------------------------------------- big model


def test_big_model_predictor(tmp_path):
  """A big-model export holds no tables in its variables; its Predictor
  answers bit-equal to the in-memory export's, and its store takes the
  updates (write-through) as the in-memory tables do."""
  tt, batch = _port(tmp_path, BN_BODY)
  _steps(tt, batch, 2)
  small = t_sm.export_saved_model(tt, str(tmp_path / 'mem'))
  big = t_sm.export_saved_model(tt, str(tmp_path / 'big'), big_model=True)
  _, state = t_sm.load_serving_state(big)
  assert state['tables'] == {}
  assert _read_json(os.path.join(big, 'export_meta.json'))['big_model']
  manifest = _read_json(os.path.join(big, 'kv', 'kv_manifest.json'))
  (key, meta), = tt.metas.items()
  assert manifest == {key: {'rows': meta.rows, 'dim': meta.dim,
                            'dtype': 'float32'}}
  cols = _columns(tmp_path, 200)
  pm = t_predictor.Predictor(small, batch_size=64, device='cpu')
  pb = t_predictor.Predictor(big, batch_size=64, device='cpu')
  _equal_outputs(pm.predict_columns(cols), pb.predict_columns(cols))
  pub = t_incr.IncrementalPublisher(tt.train_config.incr_save_config,
                                    tt.model_dir)
  pub.publish(tt, 2)
  _steps(tt, batch, 3)
  pub.publish(tt, 5)
  assert pm.consume_incremental(pub.directory) == 1
  assert pb.consume_incremental(pub.directory) == 1
  _equal_outputs(pm.predict_columns(cols), pb.predict_columns(cols))
  # a second Predictor of the export reads the rows written into the store
  # on disk; the dense parameters it takes from the update again
  again = t_predictor.Predictor(big, device='cpu')
  key = next(iter(tt.metas))
  ids = t_incr.read_update(t_incr.list_updates(pub.directory)[0])[
      'sparse_ids/' + key]
  np.testing.assert_array_equal(again._kv_stores[key].gather(ids),
                                pm.tables[key][ids].numpy())
  assert again.consume_incremental(pub.directory) == 1
  _equal_outputs(pm.predict_columns(cols), again.predict_columns(cols))


def test_big_model_cli_export(tmp_path):
  path = fixtures.write_pipeline(tmp_path, num_steps=4)
  t_main.train_and_evaluate(path, device='cpu')
  from easyrec_torch import export_cli
  assert export_cli.main(['--pipeline_config_path', path, '--export_dir',
                          str(tmp_path / 'big'), '--big_model', '--device',
                          'cpu']) == 0
  (export,) = glob.glob(str(tmp_path / 'big' / '*'))
  assert os.path.exists(os.path.join(export, 'kv', 'kv_manifest.json'))
  assert t_predictor.Predictor(export, device='cpu').predict([{}])


def test_big_model_predictor_matches_jax(both):
  jt, tt, state = both['jt'], both['tt'], both['state']
  jexp = j_sm.export_saved_model(jt, state, str(both['tmp'] / 'jax'),
                                 big_model=True)
  texp = t_sm.export_saved_model(tt, str(both['tmp'] / 'port'),
                                 big_model=True)
  cols = _columns(both['tmp'], 100)
  want = j_predictor.Predictor(jexp, batch_size=64).predict_columns(cols)
  got = t_predictor.Predictor(texp, batch_size=64,
                              device='cpu').predict_columns(cols)
  for k in ('probs', 'logits'):
    np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5,
                               atol=1e-5, err_msg=k)


class DictRedis:
  """A redis client's mget/mset/get/set over a dict."""

  def __init__(self):
    self.data = {}

  def mget(self, names):
    return [self.data.get(n) for n in names]

  def mset(self, mapping):
    self.data.update(mapping)

  def get(self, name):
    return self.data.get(name)

  def set(self, name, value):
    self.data[name] = value


def test_redis_transport_round_trip(tmp_path):
  rng = np.random.default_rng(0)
  tables = {'t0': rng.standard_normal((50, 4)).astype(np.float32),
            't1': rng.standard_normal((9, 3)).astype(np.float32)}
  client = DictRedis()
  assert t_bm.write_kv_store(str(tmp_path), tables, uri='redis://h:1/0',
                             client=client) == 'redis://h:1/0'
  stores = t_bm.open_kv_store(str(tmp_path), uri='redis://h:1/0',
                              client=client)
  ids = np.array([[3, 49], [0, 60]])
  np.testing.assert_array_equal(stores['t0'].gather(ids),
                                tables['t0'][np.clip(ids, 0, 49)])
  stores['t0'].update_rows(np.array([3]), np.ones((1, 4), np.float32))
  assert (stores['t0'].gather(np.array([3])) == 1).all()
  # the JAX package reads the same keys
  j_stores = j_bm.open_kv_store(str(tmp_path), uri='redis://h:1/0',
                                client=client)
  np.testing.assert_array_equal(j_stores['t1'].gather(np.arange(9)),
                                tables['t1'])
  np.testing.assert_array_equal(j_stores['t0'].gather(ids),
                                stores['t0'].gather(ids))
  packs = t_bm.pack_ids_np(both_layout(), {'feat.a.ids': np.array([[1]]),
                                          'feat.b.ids': np.array([[2, 3]])})
  assert {k: v.tolist() for k, v in packs.items()} == {'t': [[1, 12, 13]]}
  with pytest.raises(ValueError, match='unknown KV transport'):
    t_bm.make_transport(str(tmp_path), 'memcache://x')


def both_layout():
  """A two-feature layout stand-in: feature b's rows after a's ten."""
  from types import SimpleNamespace as NS
  return NS(tables={'t': NS(uses=[NS(feature='a', offset=0),
                                  NS(feature='b', offset=10)])})


# ------------------------------------------------------------ events files


def _events(model_dir):
  out = {}
  for sub in ('', 'eval_val'):
    (path,) = glob.glob(os.path.join(model_dir, sub,
                                     'events.out.tfevents.*'))
    for step, scalars in j_summary.iter_events(path):
      for tag in scalars:
        # the JAX package's exchange overflow accounting, which one device
        # does not have (ROADMAP A9)
        if 'exchange_' not in tag:
          out.setdefault(sub + ':' + tag, []).append(step)
  return out


def test_events_files_read_by_jax(tmp_path):
  """Both trainers fit the fixture 6 steps (log every 2, summaries every
  3, a save with an online eval every 3) into a model_dir; the JAX
  package's iter_events reads the port's events files with the JAX
  trainer's tags at the JAX trainer's steps."""
  extra = {'train_config.log_step_count_steps': 2,
           'train_config.save_summary_steps': 3,
           'train_config.save_checkpoints_steps': 3,
           'eval_config.eval_online': True,
           'train_config.num_steps': 6}
  dirs = {}
  for side in ('jax', 'port'):
    tmp = tmp_path / side
    tmp.mkdir()
    path = fixtures.write_pipeline(tmp, num_steps=6, n_train=2048,
                                   n_eval=256)
    if side == 'jax':
      cfg = j_config.get_configs_from_pipeline_file(path)
      j_config.edit_config(cfg, extra)
      JTrainer(cfg, devices=jax.devices('cpu')[:1]).fit()
    else:
      cfg = t_main.load_config(path, extra)
      TTrainer(cfg, device='cpu').fit()
    dirs[side] = cfg.model_dir
  port, jax_tags = _events(dirs['port']), _events(dirs['jax'])
  assert port == jax_tags
  assert port[':loss/total_loss'] == [3, 6]
  assert port[':global_step/examples_per_sec'] == [2, 4, 6]
  assert port[':eval/auc'] == [3, 6] and port['eval_val:auc'] == [6]
