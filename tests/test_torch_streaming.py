"""The port's streaming readers on the CPU, against the JAX package: Kafka
through the repo's in-process broker (tests/kafka_mock.py) and DataHub
through its REST mock (tests/datahub_mock.py). Every batch and the
pipeline's last_batch_offsets after every batch equal the JAX pipeline's
exactly; eval drains to the end and stops; the Kafka message parse equals
the JAX typed CSV parse on its edge cases; after the same steps the
trainer's data_offset.json equals the JAX trainer's byte for byte; a port
run resumed from its offsets equals the uninterrupted run in every state
tensor; a JAX model_dir's offsets resume in the port; the kafka_topic tool
round-trips against the JAX tool."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from easyrec_torch.config import config_util as t_config
from easyrec_torch.data import input_pipeline as t_ip
from easyrec_torch.tools import kafka_topic as t_kafka_topic
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.data import input_pipeline as j_ip
from easyrec_tpu.tools import kafka_topic as j_kafka_topic
from easyrec_tpu.train.trainer import Trainer as JTrainer
from tests import fixtures
from tests.datahub_mock import MockDataHub
from tests.kafka_mock import MockBroker

BATCH = 64
DH_SCHEMA = [('label', 'BIGINT'), ('d1', 'DOUBLE'), ('d2', 'DOUBLE'),
             ('c1', 'STRING'), ('c2', 'STRING'), ('c3', 'STRING')]


@pytest.fixture()
def broker():
  b = MockBroker()
  b.start()
  yield b
  b.stop()


@pytest.fixture()
def dh():
  d = MockDataHub()
  d.start()
  yield d
  d.stop()


def _rows(n, seed):
  """The fixture schema's rows: label, d1, d2, c1, c2, c3."""
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(n):
    d1, d2 = rng.random(), rng.random()
    out.append([int(d1 + d2 > 1.0), '%.6f' % d1, '%.6f' % d2,
                'u%d' % rng.integers(0, 50), 'i%d' % rng.integers(0, 40),
                'q%d' % rng.integers(0, 30)])
  return out


def _produce(broker, sizes, topic='ctr', seed=3):
  """Partition p gets sizes[p] rows (the fixture's CSV lines)."""
  broker.create_topic(topic, len(sizes))
  rows = _rows(sum(sizes), seed)
  i = 0
  for p, n in enumerate(sizes):
    for r in rows[i:i + n]:
      broker.produce(topic, p, ','.join(map(str, r)).encode())
    i += n


def _put(dh, sizes, topic='ctr', seed=3):
  dh.create_topic('p', topic, DH_SCHEMA, len(sizes))
  rows = _rows(sum(sizes), seed)
  i = 0
  for s, n in enumerate(sizes):
    for r in rows[i:i + n]:
      dh.put('p', topic, s, r)
    i += n


def _configs(tmp_path, source, num_steps=3):
  """(JAX config, port config) of the fixture DeepFM reading `source`:
  the text of a kafka_* or datahub_* input block ({which} is train or
  eval), unshuffled, batch BATCH, one epoch, a save at every step."""
  os.makedirs(str(tmp_path), exist_ok=True)
  path = fixtures.write_pipeline(tmp_path, num_steps=num_steps,
                                 batch_size=BATCH, n_train=8, n_eval=8,
                                 num_epochs=1)
  with open(path) as f:
    text = f.read()
  lines = [l for l in text.split('\n')
           if not l.startswith(('train_input_path', 'eval_input_path'))]
  text = '\n'.join(lines)
  text = (source.replace('{which}', 'train') + '\n' +
          source.replace('{which}', 'eval') + '\n' + text)
  kind = 'KafkaInput' if source.startswith('kafka') else 'DataHubInput'
  text = text.replace('input_type: CSVInput',
                      'input_type: %s shuffle: false' % kind)
  text = text.replace('save_checkpoints_steps: 500',
                      'save_checkpoints_steps: 1')
  return (j_config.get_configs_from_pipeline_str(text),
          t_config.get_configs_from_pipeline_str(text))


def _kafka_source(broker, extra=''):
  return ('kafka_{which}_input { server: "127.0.0.1:%d" topic: "ctr" %s }'
          % (broker.port, extra))


def _dh_source(dh, extra=''):
  return ('datahub_{which}_input { akId: "ak" akSecret: "sk" region: '
          '"127.0.0.1:%d" project: "p" topic: "ctr" %s }' % (dh.port, extra))


def _pipelines(jc, tc, mode='train', shard=(0, 1)):
  which = 'train' if mode == 'train' else 'eval'
  jp = j_ip.InputPipeline(
      jc.data_config, j_config.get_feature_configs(jc),
      getattr(jc, jc.WhichOneof(which + '_path')), mode=mode,
      shard_index=shard[0], shard_num=shard[1])
  tp = t_ip.InputPipeline(
      tc.data_config, t_config.get_feature_configs(tc),
      getattr(tc, tc.WhichOneof(which + '_path')), mode=mode,
      shard_index=shard[0], shard_num=shard[1])
  return jp, tp


def _same_stream(jp, tp):
  """Both pipelines' batches, and their offsets after each, equal; returns
  the batch count."""
  n = 0
  jit, tit = iter(jp), iter(tp)
  while True:
    jb, tb = next(jit, None), next(tit, None)
    assert (jb is None) == (tb is None), 'batch %d on one side only' % n
    if jb is None:
      return n
    assert sorted(jb) == sorted(tb)
    for k in jb:
      np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]),
                                    err_msg='batch %d %s' % (n, k))
      assert np.asarray(tb[k]).dtype == np.asarray(jb[k]).dtype, k
    assert tp.last_batch_offsets == jp.last_batch_offsets, n
    n += 1


@pytest.mark.parametrize('sizes,extra,shard', [
    ((150, 150), '', (0, 1)),
    ((100, 37, 90), 'offset_info: \'{"0": 10, "2": 55}\'', (0, 1)),
    ((100, 37, 90), 'partitions: [2, 0] offset: [5, 7]', (0, 1)),
    ((100, 37, 90), '', (1, 2)),
], ids=['all', 'offset_info', 'partitions_offset', 'shard_1_of_2'])
def test_kafka_batches_and_offsets_equal_jax(broker, tmp_path, monkeypatch,
                                             sizes, extra, shard):
  monkeypatch.setenv('EASYREC_KAFKA_STOP_AT_END', '1')
  _produce(broker, sizes)
  jc, tc = _configs(tmp_path, _kafka_source(broker, extra))
  jp, tp = _pipelines(jc, tc, shard=shard)
  assert _same_stream(jp, tp) >= 1
  assert tp.reader.current_offsets == jp.reader.current_offsets
  assert tp.reader.start_offsets == jp.reader.start_offsets


@pytest.mark.parametrize('kind', ['kafka', 'datahub'])
def test_eval_drains_to_the_end_and_stops(broker, dh, tmp_path, kind):
  """Off train, a streaming reader reads to the end and stops without
  EASYREC_*_STOP_AT_END; the short tail is padded."""
  if kind == 'kafka':
    _produce(broker, (70, 90))
    source = _kafka_source(broker)
  else:
    _put(dh, (70, 90))
    source = _dh_source(dh)
  jc, tc = _configs(tmp_path, source)
  jp, tp = _pipelines(jc, tc, mode='eval')
  assert _same_stream(jp, tp) == 1      # 160 rows: eval_batch_size 4096
  rows = int(sum(b['sample_weight'].sum() for b in tp))
  assert rows == 160


def test_kafka_message_parse_equals_the_jax_typed_parse():
  """Every field type, empty values (STRING with and without a default,
  numbers, BOOL), the cells pyarrow reads as null, quoted separators and
  quotes."""
  text = '''
  data_config {
    input_type: KafkaInput
    input_fields { input_name: "i32" input_type: INT32 }
    input_fields { input_name: "i64" input_type: INT64 default_val: "7" }
    input_fields { input_name: "f" input_type: FLOAT }
    input_fields { input_name: "d" input_type: DOUBLE default_val: "2.5" }
    input_fields { input_name: "b" input_type: BOOL }
    input_fields { input_name: "s" input_type: STRING }
    input_fields { input_name: "sd" input_type: STRING default_val: "zz" }
  }'''
  lines = [b'1,2,0.5,1.25,true,a,b',
           b',,,,,,',
           b'-3,NA,null,nan,False,"x,y","say ""hi"""',
           b'4,5,1e3,-inf,1,"",NULL',
           b'0,9,N/A,#N/A,0,s p,"q;r"']
  jc = j_config.get_configs_from_pipeline_str(text)
  tc = t_config.get_configs_from_pipeline_str(text)
  jr = j_ip.create_reader(jc.data_config, None)
  tr_ = t_ip.create_reader(tc.data_config, None)
  want = jr._parse_lines(lines)
  got = tr_._parse_lines(lines)
  assert list(got) == list(want)
  for k, col in want.items():
    w = col.to_numpy(zero_copy_only=False)
    assert got[k].dtype == w.dtype, k
    np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_datahub_batches_offsets_and_schema_equal_jax(dh, tmp_path,
                                                      monkeypatch):
  monkeypatch.setenv('EASYREC_DATAHUB_STOP_AT_END', '1')
  _put(dh, (130, 100, 40))
  for extra, shard in (('', (0, 1)), ('offset_info: \'{"1": 30}\'', (0, 1)),
                       ('', (1, 2))):
    jc, tc = _configs(tmp_path, _dh_source(dh, extra))
    jp, tp = _pipelines(jc, tc, shard=shard)
    assert _same_stream(jp, tp) >= 1
    assert tp.reader.current_offsets == jp.reader.current_offsets
  # a topic without an input field: both raise, naming it
  dh.create_topic('p', 'thin', DH_SCHEMA[:3], 1)
  jc, tc = _configs(tmp_path, _dh_source(dh).replace('"ctr"', '"thin"'))
  msgs = []
  for p in _pipelines(jc, tc):
    with pytest.raises(ValueError) as e:
      next(iter(p))
    msgs.append(str(e.value))
  assert msgs[0] == msgs[1] and 'input_field[c1]' in msgs[1]


def test_datahub_bool_and_null_values_equal_jax():
  text = '''data_config { input_type: DataHubInput
    input_fields { input_name: "b" input_type: BOOL }
    input_fields { input_name: "n" input_type: INT64 }
    input_fields { input_name: "f" input_type: DOUBLE }
    input_fields { input_name: "s" input_type: STRING } }'''
  items = [(0, i, row) for i, row in enumerate(
      [['true', '3', '1.5', 'a'], ['True', None, '', None],
       ['1', '', None, ''], ['false', '-2', '2', 'x'], ['TRUE', '0', '0', 'y'],
       ['0', '5', '-1e2', 'z']])]
  jr = j_ip.create_reader(
      j_config.get_configs_from_pipeline_str(text).data_config, None)
  tr_ = t_ip.create_reader(
      t_config.get_configs_from_pipeline_str(text).data_config, None)
  jr.current_offsets, tr_.current_offsets = {}, {}
  idx = {'b': 0, 'n': 1, 'f': 2, 's': 3}
  want, got = jr._to_columns(items, idx), tr_._columns(items, idx)
  assert list(got) == list(want)
  for k in want:
    assert got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  assert tr_.current_offsets == jr.current_offsets == {0: 6}


def _fit(trainer_cls, cfg, num_steps, **kw):
  if trainer_cls is TTrainer:
    return TTrainer(cfg, device='cpu').fit(num_steps=num_steps,
                                           eval_at_end=False)
  return JTrainer(cfg).fit(num_steps=num_steps, eval_at_end=False)


def _offsets_file(model_dir):
  with open(os.path.join(model_dir, 'data_offset.json')) as f:
    return f.read()


@pytest.mark.parametrize('kind', ['kafka', 'datahub'])
def test_data_offset_json_equals_the_jax_trainers(broker, dh, tmp_path,
                                                  monkeypatch, kind):
  """Three steps over a stream whose partitions the batches consume
  unevenly: the port writes the JAX trainer's data_offset.json, byte for
  byte, after each save; a partition that gave no row keeps its start."""
  monkeypatch.setenv('EASYREC_KAFKA_STOP_AT_END', '1')
  monkeypatch.setenv('EASYREC_DATAHUB_STOP_AT_END', '1')
  if kind == 'kafka':
    _produce(broker, (150, 400, 30))
    source = _kafka_source(broker, 'offset_info: \'{"2": 10}\'')
  else:
    _put(dh, (150, 400, 30))
    source = _dh_source(dh, 'offset_info: \'{"2": 10}\'')
  files = []
  for cls, sub in ((JTrainer, 'jax'), (TTrainer, 'port')):
    jc, tc = _configs(tmp_path / sub, source)
    cfg = jc if cls is JTrainer else tc
    assert _fit(cls, cfg, 3)['global_step'] == 3
    files.append(_offsets_file(cfg.model_dir))
  assert files[1] == files[0]
  assert json.loads(files[1])['step'] == 3


def _state(trainer):
  flat = {}

  def walk(prefix, node):
    if isinstance(node, dict):
      for k, v in node.items():
        walk('%s/%s' % (prefix, k), v)
    elif isinstance(node, torch.Tensor):
      flat[prefix] = node.detach().cpu()
  walk('', trainer.state_dict())
  return flat


@pytest.mark.parametrize('kind', ['kafka', 'datahub'])
def test_resumed_run_equals_the_uninterrupted_one(broker, dh, tmp_path,
                                                  monkeypatch, kind):
  """Three steps, a fresh Trainer resumed from data_offset.json to six,
  against six steps in one run: every state tensor equal bit for bit, and
  the same data_offset.json. Partition 0 holds exactly three batches, so
  the cut at step 3 ends a fetch round (KafkaReader's docstring)."""
  monkeypatch.setenv('EASYREC_KAFKA_STOP_AT_END', '1')
  monkeypatch.setenv('EASYREC_DATAHUB_STOP_AT_END', '1')
  sizes = (3 * BATCH, 300)
  if kind == 'kafka':
    _produce(broker, sizes)
    source = _kafka_source(broker)
  else:
    _put(dh, sizes)
    source = _dh_source(dh)
  _, cut = _configs(tmp_path / 'cut', source)
  _, whole = _configs(tmp_path / 'whole', source)
  assert _fit(TTrainer, cut, 3)['global_step'] == 3
  assert json.loads(_offsets_file(cut.model_dir))['offsets'] == \
      {'0': 3 * BATCH, '1': 0}
  resumed = TTrainer(cut, device='cpu')
  assert resumed.fit(num_steps=6, eval_at_end=False)['global_step'] == 6
  one = TTrainer(whole, device='cpu')
  assert one.fit(num_steps=6, eval_at_end=False)['global_step'] == 6
  a, b = _state(resumed), _state(one)
  assert sorted(a) == sorted(b)
  for k in a:
    assert torch.equal(a[k], b[k]), k
  assert _offsets_file(cut.model_dir) == _offsets_file(whole.model_dir)


def test_jax_model_dirs_offsets_resume_in_the_port(broker, tmp_path,
                                                   monkeypatch):
  """The JAX trainer's data_offset.json of step 3, in a port model_dir
  checkpointed at step 3, resumes the port there: its file at step 6
  equals the JAX trainer's resumed to 6."""
  monkeypatch.setenv('EASYREC_KAFKA_STOP_AT_END', '1')
  _produce(broker, (100, 250, 120))
  source = _kafka_source(broker)
  jc, _ = _configs(tmp_path / 'jax', source)
  _, tc = _configs(tmp_path / 'port', source)
  assert _fit(JTrainer, jc, 3)['global_step'] == 3
  assert _fit(TTrainer, tc, 3)['global_step'] == 3
  shutil.copy(os.path.join(jc.model_dir, 'data_offset.json'),
              os.path.join(tc.model_dir, 'data_offset.json'))
  assert _fit(JTrainer, jc, 6)['global_step'] == 6
  assert _fit(TTrainer, tc, 6)['global_step'] == 6
  assert _offsets_file(tc.model_dir) == _offsets_file(jc.model_dir)


def test_kafka_topic_round_trips_against_the_jax_tool(broker, tmp_path,
                                                      capsys):
  servers = '127.0.0.1:%d' % broker.port
  broker.create_topic('t0', 1)
  broker.create_topic('t1', 1)
  lines = ['h1,h2', 'a,1', '', 'b,"2,3"', 'c,3']
  src = tmp_path / 'in.csv'
  src.write_text('\n'.join(lines) + '\n')
  with open(src) as f:
    assert t_kafka_topic.write_topic(servers, 't0', f, skip_header=True) == 3
  with open(src) as f:
    assert j_kafka_topic.write_topic(servers, 't1', f, skip_header=True) == 3
  for topic in ('t0', 't1'):
    want = list(j_kafka_topic.read_topic(servers, topic))
    assert list(t_kafka_topic.read_topic(servers, topic)) == want
    assert [v.decode() for _, _, v in want] == ['a,1', 'b,"2,3"', 'c,3']
    assert list(t_kafka_topic.read_topic(servers, topic, max_messages=2)) \
        == want[:2]
  capsys.readouterr()
  t_kafka_topic.main(['read', '--servers', servers, '--topic', 't0'])
  port_out = capsys.readouterr().out
  j_kafka_topic.main(['read', '--servers', servers, '--topic', 't0'])
  assert port_out == capsys.readouterr().out
  assert port_out.splitlines()[1] == '0\t1\tb,"2,3"'


@pytest.mark.parametrize('kind', ['kafka', 'datahub'])
def test_evaluate_and_predict_read_the_streaming_inputs(broker, dh, tmp_path,
                                                         monkeypatch, kind):
  """main.evaluate and main.predict on a model_dir trained from a stream
  read the stream's eval input to its end, as the JAX package's do: the
  predictions one a row of the topic, in the JAX package's count."""
  from easyrec_torch import main as t_main
  from easyrec_tpu import main as j_main
  monkeypatch.setenv('EASYREC_KAFKA_STOP_AT_END', '1')
  monkeypatch.setenv('EASYREC_DATAHUB_STOP_AT_END', '1')
  if kind == 'kafka':
    _produce(broker, (150, 220))
    source = _kafka_source(broker)
  else:
    _put(dh, (150, 220))
    source = _dh_source(dh)
  jc, _ = _configs(tmp_path / 'jax', source)
  _, tc = _configs(tmp_path / 'port', source)
  assert _fit(TTrainer, tc, 3)['global_step'] == 3
  assert _fit(JTrainer, jc, 3)['global_step'] == 3
  metrics = t_main.evaluate(tc, device='cpu')
  assert 0.0 <= metrics['auc'] <= 1.0
  assert os.path.exists(os.path.join(tc.model_dir, 'eval_result.txt'))
  rows = t_main.predict(tc, device='cpu')
  assert len(rows) == 370 == len(j_main.predict(jc))
  assert all(0.0 < float(r['probs']) < 1.0 for r in rows)
