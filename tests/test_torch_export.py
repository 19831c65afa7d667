"""The port's export side against the JAX package on the CPU: the text-format
writer (every sample, both directions), the serving bundle and its
Predictor (a JAX export carried over by convert.py, the same raw rows
through both Predictors, export_meta.json, predict_csv with reserved
columns and a shard), and main.py's entry points (train_and_evaluate's
model_dir, evaluate, export from a named checkpoint, predict)."""

import csv
import glob
import itertools
import json
import os
import types

import jax
import numpy as np
import pytest
import torch
from google.protobuf import text_format as pb_text

from easyrec_torch import convert
from easyrec_torch import main as t_main
from easyrec_torch.config import config_util as t_config
from easyrec_torch.config import schema
from easyrec_torch.config import text_format as t_text
from easyrec_torch.export import predictor as t_predictor
from easyrec_torch.export import saved_model as t_sm
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.export import predictor as j_predictor
from easyrec_tpu.export import saved_model as j_sm
from easyrec_tpu.train.trainer import Trainer as JTrainer
from tests import fixtures
from tests.test_torch_din import CONFIG as DIN_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = sorted(glob.glob(os.path.join(REPO, 'samples', '*.config')))

# f32 on both sides, matmul and reduction orders differ (XLA vs ATen): the
# DeepFM within 1e-6, the DIN (attention, softmax, BatchNorm) within 1e-5,
# the tolerance of tests/test_torch_din.py
DEEPFM_TOL = dict(rtol=1e-6, atol=1e-6)
DIN_TOL = dict(rtol=1e-5, atol=1e-5)


def _name(path):
  return os.path.basename(path)[:-len('.config')]


# ------------------------------------------------------------ text format

def _assert_jax_same(a, b, type_name, where):
  """Two JAX messages agree on every field of the port's schema for
  `type_name` (an unported field as a whole message or value)."""
  for spec in schema.MESSAGES[type_name]:
    fd = a.DESCRIPTOR.fields_by_name[spec.name]
    at = '%s.%s' % (where, spec.name)
    if spec.message_type and fd.message_type.GetOptions().map_entry:
      # a protobuf map (Struct.fields), compared by key
      va, vb = getattr(a, spec.name), getattr(b, spec.name)
      assert sorted(va) == sorted(vb), at
      value_type = schema.field(spec.message_type, 'value').message_type
      for k in va:
        _assert_jax_same(va[k], vb[k], value_type, '%s[%s]' % (at, k))
      continue
    if spec.repeated:
      va, vb = list(getattr(a, spec.name)), list(getattr(b, spec.name))
      assert len(va) == len(vb), at
      if spec.message_type:
        for i, (x, y) in enumerate(zip(va, vb)):
          _assert_jax_same(x, y, spec.message_type, '%s[%d]' % (at, i))
      else:
        assert va == vb, (at, va, vb)
      continue
    if fd.has_presence:
      assert a.HasField(spec.name) == b.HasField(spec.name), at
    if spec.message_type:
      _assert_jax_same(getattr(a, spec.name), getattr(b, spec.name),
                       spec.message_type, at)
    else:
      assert getattr(a, spec.name) == getattr(b, spec.name), (
          at, getattr(a, spec.name), getattr(b, spec.name))


@pytest.mark.parametrize('path', SAMPLES, ids=[_name(p) for p in SAMPLES])
def test_to_text_parses_in_jax_as_the_original(path):
  """The port's text of a sample, parsed by the JAX package, equals the
  JAX parse of the sample on every field the port's schema lists."""
  text = t_text.to_text(t_config.get_configs_from_pipeline_file(path))
  _assert_jax_same(j_config.get_configs_from_pipeline_file(path),
                   j_config.get_configs_from_pipeline_str(text),
                   'EasyRecConfig', _name(path))


def _opaque_known(canon, desc):
  """An opaque message's canonical form without the fields the JAX
  message `desc` does not have (its parse drops them)."""
  out = {}
  for name, values in canon.items():
    fd = desc.fields_by_name.get(name)
    if fd is None:
      continue
    out[name] = [_opaque_known(v, fd.message_type) if fd.message_type
                 else v for v in values]
  return out


def _jax_known(canon, type_name, desc):
  """canonical() of a port Message, its unported messages cut to what
  the JAX parse keeps, and an empty singular message left out: the JAX
  parse marks an unset feature_config present when its auto-expansion
  extends the (empty) feature list inside it (taobao_fg)."""
  out = {}
  for name, value in canon.items():
    spec = schema.field(type_name, name)
    fd = desc.fields_by_name[name]
    if spec.message_type and not spec.repeated and value == {}:
      continue
    items = value if spec.repeated else [value]
    if spec.message_type:
      items = [_jax_known(v, spec.message_type, fd.message_type)
               for v in items]
    elif fd.message_type:
      items = [_opaque_known(v, fd.message_type) for v in items]
    out[name] = items if spec.repeated else items[0]
  return out


@pytest.mark.parametrize('path', SAMPLES, ids=[_name(p) for p in SAMPLES])
def test_jax_text_reads_back_through_the_port(path):
  """JAX's MessageToString of a sample reads through the port to the same
  Message as the sample itself, but for fields inside an unported
  message that the JAX message lacks and its parse drops
  (mmoe_uncertainty_weight sets loss_weight_strategy inside mmoe)."""
  j_cfg = j_config.get_configs_from_pipeline_file(path)
  text = pb_text.MessageToString(j_cfg, as_utf8=True)
  desc = j_cfg.DESCRIPTOR
  assert _jax_known(
      t_text.canonical(t_config.get_configs_from_pipeline_str(text)),
      'EasyRecConfig', desc) == _jax_known(
          t_text.canonical(t_config.get_configs_from_pipeline_file(path)),
          'EasyRecConfig', desc)


# f32 values whose shortest text, or the double a Python edit gives, is
# easy to get wrong: edits arrive as doubles and round to float32
FLOATS = [0.1, 1e-7, 2.5e-05, 1.0 / 3.0, 16777217.0, 3.4028234e38,
          1.1754944e-38, 1.4e-45, -0.0, 123456.789, float('inf')]


@pytest.mark.parametrize('value', FLOATS)
def test_edited_floats_write_the_same_float32(value):
  """A float edited through edit_config_json (a Python double) and a
  double field are written so that the JAX parse holds the same float32
  and the same double."""
  cfg = t_config.get_configs_from_pipeline_str(
      'train_config { optimizer_config { adam_optimizer { learning_rate { '
      'constant_learning_rate { learning_rate: 0.5 } } } } }')
  t_config.edit_config(cfg, {'train_config.gradient_clipping_by_norm': value,
                             'model_config.embedding_regularization': value,
                             'data_config.separator': '\x01\t"\'\\é'})
  fc = t_text.Message('FeatureConfig')
  fc.boundaries = [value, value / 3.0]
  fc.min_val = value
  cfg.feature_configs = [fc]
  j = j_config.get_configs_from_pipeline_str(t_text.to_text(cfg))
  f32 = np.float32(value)
  assert np.float32(j.train_config.gradient_clipping_by_norm).tobytes() == \
      f32.tobytes()
  assert np.float32(j.model_config.embedding_regularization).tobytes() == \
      f32.tobytes()
  assert list(j.feature_configs[0].boundaries) == [value, value / 3.0]
  assert j.feature_configs[0].min_val == value
  assert j.data_config.separator == '\x01\t"\'\\é'


def test_opaque_fields_are_written_token_for_token():
  """An unported field keeps its tokens, so its JAX parse is unchanged;
  two spellings of one value compare equal."""
  # (a text_cnn combiner's mlp, a field the port does not run;
  # incr_save_config, Uniter and freeze_gradient served here before they
  # were ported)
  text = ('train_config { incr_save_config { kafka { server: "dnn/.*" '
          'topic: \'a\\tb\' } } }\n'
          'feature_config { features { input_names: "s" feature_type: '
          'SequenceFeature sequence_combiner { text_cnn { filter_sizes: 2 '
          'mlp { hidden_units: [8, 4] activation: "t" # comment\n '
          'use_bn: false } } } } }\nmodel_config { model_class: "DeepFM" }\n')
  t = t_config.get_configs_from_pipeline_str(text)
  written = t_text.to_text(t)
  assert 'hidden_units : [ 8 , 4 ]' in written
  a = j_config.get_configs_from_pipeline_str(text)
  b = j_config.get_configs_from_pipeline_str(written)
  assert a.feature_config == b.feature_config
  assert a.train_config.incr_save_config == b.train_config.incr_save_config
  assert b.train_config.incr_save_config.kafka.topic == 'a\tb'
  again = pb_text.MessageToString(a, as_utf8=True)
  assert _jax_known(
      t_text.canonical(t_config.get_configs_from_pipeline_str(again)),
      'EasyRecConfig', a.DESCRIPTOR) == _jax_known(
          t_text.canonical(t), 'EasyRecConfig', a.DESCRIPTOR)


# ------------------------------------------------------ export and serve

def _din_text(path):
  text = DIN_CONFIG % {'bn': 'true'}
  text = text.replace('"synthetic"', '"%s"' % path)
  return text.replace('input_type: DummyInput', 'input_type: CSVInput')


def _write_din_csv(path, n, seed):
  rng = np.random.default_rng(seed)
  with open(path, 'w') as f:
    for i in range(n):
      brands = '|'.join('b%d' % v for v in rng.integers(0, 60,
                                                        rng.integers(0, 11)))
      cates = '|'.join('c%d' % v for v in rng.integers(0, 30,
                                                       rng.integers(1, 9)))
      f.write('%d,u%d,b%d,c%d,%s,%s,%s\n' % (
          rng.integers(0, 2), rng.integers(0, 90), rng.integers(0, 60),
          rng.integers(0, 30), '' if i % 9 == 0 else rng.integers(0, 70),
          brands, cates))


def _jax_export(tmp, path, steps=3):
  """A JAX Trainer on one CPU device, `steps` steps on its train input,
  exported; returns (export dir, its serving state as numpy)."""
  jt = JTrainer(j_config.get_configs_from_pipeline_file(path),
                devices=jax.devices('cpu')[:1])
  batches = list(itertools.islice(iter(jt.train_input()), steps))
  state = jt.init_state(batches[0])
  for b in batches:
    state, _ = jt.train_step(state, jt.rules.shard_batch(b))
  export_dir = j_sm.export_saved_model(jt, state, os.path.join(tmp, 'jax'))
  _, vs = j_sm.load_serving_state(export_dir)
  vs = jax.tree_util.tree_map(np.asarray, vs)
  return export_dir, vs


def _port_export(tmp, path, steps=3):
  """A port Trainer, `steps` steps on its train input, exported."""
  tt = TTrainer(t_config.get_configs_from_pipeline_file(path), device='cpu')
  tt.init_state()
  for b in itertools.islice(iter(tt.train_input()), steps):
    tt.train_step(to_device(b, torch.device('cpu')))
  return t_sm.export_saved_model(tt, os.path.join(tmp, 'port')), tt


def _setup(tmp, path):
  jexp, vs = _jax_export(tmp, path)
  bundle = convert.jax_export_to_bundle(
      jexp, os.path.join(tmp, 'bundle'), vs['params'],
      vs.get('batch_stats'), vs['tables'], vs['step'])
  return {'tmp': tmp, 'path': path, 'jax_export': jexp, 'vs': vs,
          'bundle': bundle}


@pytest.fixture(scope='module')
def deepfm(tmp_path_factory):
  tmp = str(tmp_path_factory.mktemp('deepfm'))
  path = fixtures.write_pipeline(tmp, num_steps=3, n_train=1024, n_eval=300)
  return _setup(tmp, path)


@pytest.fixture(scope='module')
def din(tmp_path_factory):
  tmp = str(tmp_path_factory.mktemp('din'))
  data = os.path.join(tmp, 'din.csv')
  _write_din_csv(data, 400, seed=3)
  path = os.path.join(tmp, 'din.config')
  with open(path, 'w') as f:
    f.write(_din_text(data))
  return _setup(tmp, path)


def _csv_rows(path, names, n):
  with open(path) as f:
    rows = [dict(zip(names, line)) for line in csv.reader(f)][:n]
  rows[1] = {k: v for k, v in rows[1].items() if k not in names[2:4]}
  rows[2] = {k: '' for k in rows[2]}
  return rows


def _assert_predictions_agree(run, names, data, tol):
  rows = _csv_rows(data, names, 70)
  want = j_predictor.Predictor(run['jax_export'], batch_size=64).predict(rows)
  got = t_predictor.Predictor(run['bundle'], batch_size=64,
                              device='cpu').predict(rows)
  assert len(got) == len(want) == len(rows)
  for key in ('probs', 'logits'):
    np.testing.assert_allclose([float(r[key]) for r in got],
                               [float(r[key]) for r in want], **tol,
                               err_msg=key)


def test_deepfm_predictor_matches_jax(deepfm):
  names = ['label', 'd1', 'd2', 'c1', 'c2', 'c3']
  _assert_predictions_agree(deepfm, names,
                            os.path.join(deepfm['tmp'], 'eval.csv'),
                            DEEPFM_TOL)


def test_din_predictor_matches_jax(din):
  """The DIN has BatchNorm: its running statistics travel as the bundle's
  running_mean / running_var. The rule for num_batches_tracked: the
  port's BatchNorm keeps none (flax's has none and its momentum is
  fixed), so neither a port export nor a converted one holds one, and a
  state_dict with one does not load."""
  names = ['clk', 'user_id', 'brand', 'cate_id', 'price', 'tag_brand_list',
           'tag_category_list']
  _assert_predictions_agree(din, names, os.path.join(din['tmp'], 'din.csv'),
                            DIN_TOL)
  _, state = t_sm.load_serving_state(din['bundle'])
  assert any(k.endswith('running_var') for k in state['model'])
  port_dir, _ = _port_export(din['tmp'], din['path'])
  _, port_state = t_sm.load_serving_state(port_dir)
  assert sorted(port_state['model']) == sorted(state['model'])
  assert not any('num_batches_tracked' in k for k in state['model'])
  p = t_predictor.Predictor(din['bundle'], device='cpu')
  bad = dict(state['model'])
  bad['towers.0.bn_0.num_batches_tracked'] = torch.tensor(3)
  with pytest.raises(RuntimeError, match='num_batches_tracked'):
    p.model.load_state_dict(bad)


@pytest.mark.parametrize('which', ['deepfm', 'din'])
def test_export_meta_matches_jax(which, request):
  """A port export of the same config after as many steps has the JAX
  export's export_meta.json but for framework and export_time; its
  layout is the JAX one."""
  run = request.getfixturevalue(which)
  port_dir, tt = _port_export(run['tmp'], run['path'])
  with open(os.path.join(port_dir, 'export_meta.json')) as f:
    got = json.load(f)
  with open(os.path.join(run['jax_export'], 'export_meta.json')) as f:
    want = json.load(f)
  assert got.pop('framework') == 'easyrec_torch'
  assert want.pop('framework') == 'easyrec_tpu'
  assert got.pop('export_time') == os.path.basename(port_dir)
  want.pop('export_time')
  assert got == want
  assert sorted(os.listdir(port_dir)) == ['export_meta.json',
                                          'pipeline.config', 'variables']
  _, state = t_sm.load_serving_state(port_dir)
  assert int(state['step']) == 3
  for key, meta in tt.metas.items():
    assert torch.equal(state['tables'][key], tt.tables[key][:, :meta.dim])
  assert t_text.canonical(t_config.get_configs_from_pipeline_file(
      os.path.join(port_dir, 'pipeline.config'))) == \
      t_text.canonical(tt.pipeline_config)


def test_predict_csv_matches_jax_with_a_shard(deepfm):
  """predict_csv with reserved string columns and shard 1 of 2: the same
  header, reserved columns and rows as the JAX Predictor's, outputs within
  the tolerance."""
  data = os.path.join(deepfm['tmp'], 'eval.csv')
  outs = {}
  for side, p in (('jax', j_predictor.Predictor(deepfm['jax_export'],
                                                batch_size=64)),
                  ('port', t_predictor.Predictor(deepfm['bundle'],
                                                 batch_size=64,
                                                 device='cpu'))):
    out = os.path.join(deepfm['tmp'], '%s.csv' % side)
    n = p.predict_csv(data, out, reserved_cols=['c1', 'c3'], shard_index=1,
                      shard_num=2)
    with open(out) as f:
      outs[side] = (n, list(csv.reader(f)))
  (jn, jrows), (tn, trows) = outs['jax'], outs['port']
  assert jn == tn == 150
  assert trows[0] == jrows[0] == ['c1', 'c3', 'logits', 'probs']
  assert len(trows) == len(jrows) == 151
  assert [r[:2] for r in trows] == [r[:2] for r in jrows]
  with open(data) as f:
    lines = list(csv.reader(f))
  assert [r[:2] for r in trows[1:]] == [[l[3], l[5]] for l in lines[1::2]]
  np.testing.assert_allclose(np.float64([r[2:] for r in trows[1:]]),
                             np.float64([r[2:] for r in jrows[1:]]),
                             **DEEPFM_TOL)


def test_a_jax_export_does_not_load_without_convert(deepfm):
  with pytest.raises(ValueError, match='convert.py'):
    t_predictor.Predictor(deepfm['jax_export'], device='cpu')
  with pytest.raises(RuntimeError, match='cuda'):
    t_predictor.Predictor(deepfm['bundle'])


# ----------------------------------------------------- main.py entry points

@pytest.fixture(scope='module')
def trained(tmp_path_factory):
  """train_and_evaluate of the CLI fixture (20 steps, a save every 10,
  1,000 eval rows: the last eval batch is padded) on the CPU."""
  tmp = str(tmp_path_factory.mktemp('entry'))
  path = fixtures.write_pipeline(tmp, num_steps=20, n_train=2048,
                                 n_eval=1000)
  edits = {'train_config.save_checkpoints_steps': 10,
           'data_config.eval_batch_size': 256}
  result = t_main.train_and_evaluate(path, edits, device='cpu')
  return tmp, path, edits, result


def test_train_and_evaluate_writes_the_model_dir(trained):
  tmp, path, edits, result = trained
  model_dir = os.path.join(tmp, 'ckpt')
  # the train events file and the final eval's, as the JAX trainer writes
  # them (utils/summary_writer.py)
  listed = sorted(os.listdir(model_dir))
  events = [n for n in listed if n.startswith('events.out.tfevents.')]
  assert len(events) == 1
  assert [n for n in listed if n not in events] == [
      'checkpoints', 'eval_result.txt', 'eval_val', 'export',
      'pipeline.config', 'version']
  assert len(glob.glob(os.path.join(model_dir, 'eval_val',
                                    'events.out.tfevents.*'))) == 1
  with open(os.path.join(model_dir, 'version')) as f:
    assert f.read().strip() == '0.1.0'
  written = t_config.get_configs_from_pipeline_file(
      os.path.join(model_dir, 'pipeline.config'))
  assert t_text.canonical(written) == t_text.canonical(
      t_main.load_config(path, edits))
  assert sorted(os.listdir(os.path.join(model_dir, 'checkpoints'))) == \
      ['10', '20']
  export_dir = result['export_dir']
  assert os.path.dirname(export_dir) == os.path.join(model_dir, 'export',
                                                     'final')
  assert sorted(os.listdir(export_dir)) == ['export_meta.json',
                                            'pipeline.config', 'variables']
  with open(os.path.join(model_dir, 'eval_result.txt')) as f:
    assert json.load(f) == result['eval_metrics']


def test_evaluate_writes_what_the_trainer_evaluates(trained):
  tmp, path, edits, result = trained
  metrics = t_main.evaluate(path, eval_result_filename='again.txt',
                            edit_config_json=edits, device='cpu')
  assert metrics == result['trainer'].evaluate() == result['eval_metrics']
  with open(os.path.join(tmp, 'ckpt', 'again.txt')) as f:
    assert json.load(f) == metrics


def test_export_from_a_checkpoint_equals_the_final_export(trained):
  tmp, path, edits, result = trained
  out = t_main.export(path, export_dir=os.path.join(tmp, 'again'),
                      checkpoint_path=os.path.join(tmp, 'ckpt',
                                                   'checkpoints', '20'),
                      edit_config_json=edits, device='cpu')
  _, a = t_sm.load_serving_state(out)
  _, b = t_sm.load_serving_state(result['export_dir'])
  assert int(a['step']) == int(b['step']) == 20
  for section in ('model', 'tables'):
    assert sorted(a[section]) == sorted(b[section])
    for k in a[section]:
      assert torch.equal(a[section][k], b[section][k]), k
  ten = t_main.export(path, export_dir=os.path.join(tmp, 'ten'),
                      checkpoint_path=os.path.join(tmp, 'ckpt',
                                                   'checkpoints', '10'),
                      edit_config_json=edits, device='cpu')
  assert int(t_sm.load_serving_state(ten)[1]['step']) == 10
  # a big-model export of the checkpoint: the same model, its tables in
  # the KV store (export/big_model.py) and none in its variables
  big = t_main.export(path, export_dir=os.path.join(tmp, 'big'),
                      checkpoint_path=os.path.join(tmp, 'ckpt',
                                                   'checkpoints', '20'),
                      edit_config_json=edits, big_model=True, device='cpu')
  _, c = t_sm.load_serving_state(big)
  assert c['tables'] == {}
  for k in b['model']:
    assert torch.equal(c['model'][k], b['model'][k]), k
  from easyrec_torch.export import big_model as t_bm
  stores = t_bm.open_kv_store(big)
  assert sorted(stores) == sorted(b['tables'])
  for k, table in b['tables'].items():
    np.testing.assert_array_equal(
        stores[k].gather(np.arange(table.shape[0])), table.numpy())


def test_predict_drops_padded_rows(trained):
  """main.predict over the 1,000 eval rows in batches of 256 (the last
  padded with 24 rows of sample_weight 0) answers 1,000 rows, and the
  Predictor on the final export answers the same."""
  tmp, path, edits, result = trained
  out = os.path.join(tmp, 'pred.csv')
  rows = t_main.predict(path, output_path=out, edit_config_json=edits,
                        device='cpu')
  assert len(rows) == 1000
  with open(out) as f:
    lines = list(csv.reader(f))
  assert lines[0] == ['logits', 'probs'] and len(lines) == 1001
  p = t_predictor.Predictor(result['export_dir'], batch_size=256,
                            device='cpu')
  n = p.predict_csv(os.path.join(tmp, 'eval.csv'),
                    os.path.join(tmp, 'served.csv'))
  with open(os.path.join(tmp, 'served.csv')) as f:
    served = list(csv.reader(f))
  assert n == 1000
  np.testing.assert_array_equal(np.float32([r['probs'] for r in rows]),
                                np.float32([l[1] for l in served[1:]]))


@pytest.mark.parametrize('file_shard', [False, True])
def test_input_shards_match_jax(file_shard, tmp_path):
  """Shard 1 of 2 of three CSV files, unshuffled: by rows across the files
  (the row's index modulo 2) or, under file_shard, the files paths[1::2];
  the port's batches equal the JAX pipeline's."""
  from easyrec_torch.data import input_pipeline as t_input
  from easyrec_tpu.data import input_pipeline as j_input
  from tests.test_torch_din import _assert_batches_equal
  paths = []
  for i in range(3):
    paths.append(str(tmp_path / ('part%d.csv' % i)))
    fixtures.make_binary_csv(paths[-1], 150 + 20 * i, seed=i)
  text = open(fixtures.write_pipeline(tmp_path)).read()
  text = text.replace('num_epochs: 0', 'num_epochs: 1 shuffle: false '
                      'file_shard: %s' % str(file_shard).lower())
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  pattern = str(tmp_path / 'part*.csv')
  t_pipe = t_input.InputPipeline(
      t_cfg.data_config, t_config.get_feature_configs(t_cfg), pattern,
      batch_size=64, shard_index=1, shard_num=2)
  j_pipe = j_input.InputPipeline(
      j_cfg.data_config, j_config.get_feature_configs(j_cfg), pattern,
      batch_size=64, shard_index=1, shard_num=2)
  rows = sum(float(b['sample_weight'].sum()) for b in t_pipe)
  assert rows == (170 if file_shard else 255)
  _assert_batches_equal(t_pipe, j_pipe, 3 if file_shard else 4)


def test_fit_on_eval_and_exports_to_keep(tmp_path, monkeypatch):
  """fit_on_eval trains fit_on_eval_steps more batches of the eval input
  before the export; exports_to_keep prunes the older timestamps."""
  path = fixtures.write_pipeline(tmp_path, num_steps=4, n_train=512,
                                 n_eval=512)
  clock = iter([1000.0, 1001.0, 1002.0])
  monkeypatch.setattr(t_sm, 'time',
                      types.SimpleNamespace(time=lambda: next(clock)))
  edits = {'export_config.exports_to_keep': 2}
  result = t_main.train_and_evaluate(path, edits, fit_on_eval=True,
                                     fit_on_eval_steps=2, device='cpu')
  assert result['global_step'] == 6
  assert int(result['trainer'].step) == 6
  assert int(t_sm.load_serving_state(result['export_dir'])[1]['step']) == 6
  base = os.path.dirname(result['export_dir'])
  for _ in range(2):
    t_main.export(path, export_dir=base, edit_config_json=edits,
                  device='cpu')
  assert sorted(os.listdir(base)) == ['1001', '1002']


def test_rtp_outputs_and_echoed_features(tmp_path):
  """export_config.export_rtp_outputs adds rank_predict (probs) and
  export_features echoes the input values, as in the JAX Predictor."""
  path = fixtures.write_pipeline(
      tmp_path, num_steps=3,
      extra='export_config { export_rtp_outputs: true '
            'export_features: true }\n')
  result = t_main.train_and_evaluate(path, device='cpu')
  p = t_predictor.Predictor(result['export_dir'], batch_size=8,
                            device='cpu')
  assert p.meta['outputs'] == ['logits', 'probs', 'rank_predict']
  out = p.predict([{'d1': '0.5', 'd2': '0.1', 'c1': 'u3', 'c2': 'v1',
                    'c3': 'w2'}])[0]
  assert float(out['rank_predict']) == float(out['probs'])
  assert out['feature_c1'] == 'u3' and out['feature_d1'] == '0.5'
  assert sorted(out) == ['feature_c1', 'feature_c2', 'feature_c3',
                         'feature_d1', 'feature_d2', 'logits', 'probs',
                         'rank_predict']
