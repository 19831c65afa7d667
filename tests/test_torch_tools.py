"""The port's one-device tools, HPO tuner, exit_after and model zoo on the
CPU, each held to the JAX package's on the same inputs: the JSON codec's
text equals protobuf's MessageToJson on every sample; convert_config_format,
convert_rtp_fg, add_boundaries_to_config, add_feature_info_to_config and
create_config_from_excel write configs equal field by field; pre_check
gives the JAX tool's messages; predict_and_chk its JSON lines and exit
codes; view_export its synthetic row; the tuner its trial parameters
under a seed (equal in random and grid mode, within 1e-9 in bayes mode).
feature_selection reads a port checkpoint of a variational-dropout
backbone model."""

import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
from google.protobuf import json_format as pb_json
from google.protobuf import text_format as pb_text

from easyrec_torch import main as t_main
from easyrec_torch.config import config_util as t_config
from easyrec_torch.config import json_format as t_json
from easyrec_torch.config import text_format as t_text
from easyrec_torch.hpo import tuner as t_tuner
from easyrec_torch.tools import add_boundaries_to_config as t_bounds
from easyrec_torch.tools import add_feature_info_to_config as t_info
from easyrec_torch.tools import convert_config_format as t_ccf
from easyrec_torch.tools import convert_rtp_fg as t_rtp
from easyrec_torch.tools import create_config_from_excel as t_excel
from easyrec_torch.tools import feature_selection as t_fsel
from easyrec_torch.tools import pre_check as t_pre
from easyrec_torch.tools import predict_and_chk as t_pchk
from easyrec_torch.tools import view_export as t_view
from easyrec_tpu import main as j_main
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.hpo import tuner as j_tuner
from easyrec_tpu.protos import pipeline_pb2
from easyrec_tpu.tools import add_boundaries_to_config as j_bounds
from easyrec_tpu.tools import add_feature_info_to_config as j_info
from easyrec_tpu.tools import convert_config_format as j_ccf
from easyrec_tpu.tools import convert_rtp_fg as j_rtp
from easyrec_tpu.tools import create_config_from_excel as j_excel
from easyrec_tpu.tools import feature_selection as j_fsel
from easyrec_tpu.tools import pre_check as j_pre
from easyrec_tpu.tools import predict_and_chk as j_pchk
from easyrec_tpu.tools import view_export as j_view
from tests import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = sorted(os.path.basename(p)[:-len('.config')]
                 for p in glob.glob(os.path.join(REPO, 'samples', '*.config')))


def _sample(name):
  return os.path.join(REPO, 'samples', name + '.config')


def _canon_port(text):
  """A config's text read by the port, as a comparable dict."""
  return t_text.canonical(t_config.get_configs_from_pipeline_str(text,
                                                                 False))


@pytest.mark.parametrize('name', SAMPLES)
def test_json_codec_writes_message_to_json(name):
  """Both name forms, byte for byte, and the parse back, on the fields
  the port's schema holds of each sample. A Struct (a backbone layer's
  st_params) is a map in protobuf, written in the order of its hash table,
  which varies; the port writes the config's order, so there the JSON
  values are held equal, not the text."""
  cfg = t_config.get_configs_from_pipeline_file(_sample(name), False)
  ref = pipeline_pb2.EasyRecConfig()
  pb_text.Parse(t_text.to_text(cfg), ref)
  for preserve in (False, True):
    want = pb_json.MessageToJson(ref, preserving_proto_field_name=preserve)
    got = t_json.message_to_json(cfg, preserve)
    assert json.loads(got) == json.loads(want)
    if 'stParams' not in want and 'st_params' not in want:
      assert got == want
    back = t_json.parse(want)
    assert json.loads(t_json.message_to_json(back, preserve)) == \
        json.loads(want)


def test_convert_config_format_equals_the_jax_tool(tmp_path):
  """On the samples whose every field the port reads, the JAX tool's
  .json and the port's are the same text; each tool reads the other's
  back to the same config; a .json pipeline config loads."""
  checked = 0
  for name in SAMPLES:
    src = _sample(name)
    held = t_text.to_text(t_ccf.load_config(src))
    jax_cfg = j_ccf.load_config(src)
    again = pipeline_pb2.EasyRecConfig()
    pb_text.Parse(held, again)
    if again != jax_cfg:
      continue                  # a field the port drops
    outs = []
    for sub, tool in (('jax', j_ccf), ('port', t_ccf)):
      out = str(tmp_path / sub / (name + '.json'))
      os.makedirs(os.path.dirname(out), exist_ok=True)
      tool.main(['--input_config', src, '--output_config', out])
      outs.append(open(out).read())
    assert json.loads(outs[1]) == json.loads(outs[0]), name
    if 'st_params' not in outs[0]:
      assert outs[1] == outs[0], name
    back = str(tmp_path / 'port' / (name + '.config'))
    t_ccf.main(['--input_config', str(tmp_path / 'jax' / (name + '.json')),
                '--output_config', back])
    assert j_ccf.load_config(back) == jax_cfg, name
    assert t_text.canonical(t_config.get_configs_from_pipeline_file(
        str(tmp_path / 'port' / (name + '.json')))) == t_text.canonical(
            t_config.get_configs_from_pipeline_file(src)), name
    checked += 1
  assert checked >= 40, checked


def test_convert_rtp_fg_equals_the_jax_tool(tmp_path):
  fg = os.path.join(REPO, 'samples', 'fg', 'taobao_fg.json')
  for args in (['--label', 'clk', '--embedding_dim', '8'],
               ['--base_config', _sample('taobao_fg')]):
    outs = []
    for sub, tool in (('jax', j_rtp), ('port', t_rtp)):
      out = str(tmp_path / (sub + '.config'))
      tool.main(['--rtp_fg', fg, '--output_path', out] + args)
      outs.append(_canon_port(open(out).read()))
    assert outs[1] == outs[0]
    assert outs[1]['data_config']['input_fields']


def test_add_boundaries_equals_the_jax_tool(tmp_path):
  path = fixtures.write_pipeline(tmp_path, num_steps=10)
  outs = []
  for sub, tool in (('jax', j_bounds), ('port', t_bounds)):
    out = str(tmp_path / (sub + '.config'))
    tool.main(['--pipeline_config_path', path, '--output_config_path', out,
               '--num_buckets', '8'])
    outs.append(_canon_port(open(out).read()))
  assert outs[1] == outs[0]
  bounds = [f.get('boundaries') for f in
            outs[1]['feature_config']['features']]
  assert sum(b is not None for b in bounds) == 2


def test_add_feature_info_equals_the_jax_tool(tmp_path):
  info = {'uid': {'embedding_dim': 24, 'hash_bucket_size': 5000},
          'age': {'embedding_dim': 4, 'boundary': [0.0, 18.0, 30.0, 60.0]},
          'tags': {'message': 'DROP IT'},
          'seq_cate': {'message': 'DROP IT'},
          '__NUM_STEPS__': {'num_steps': 1234},
          '__DECAY_STEPS__': {'decay_steps': 77}}
  info_path = str(tmp_path / 'info.json')
  with open(info_path, 'w') as f:
    json.dump(info, f)
  csv_path = str(tmp_path / 'info.csv')
  with open(csv_path, 'w') as f:
    f.write('feature,feature_info,message\n')
    f.write('uid,"{""embedding_dim"": 12}",\n')
    f.write('tags,{},DROP IT\n')
  for template in ('multi_tower_din', 'dlrm_backbone'):
    for table in (info_path, csv_path):
      outs = []
      for sub, tool in (('jax', j_info), ('port', t_info)):
        out = str(tmp_path / (sub + '.config'))
        tool.main(['--template_config_path', _sample(template),
                   '--output_config_path', out,
                   '--feature_info_path', table])
        outs.append(_canon_port(open(out).read()))
      assert outs[1] == outs[0], (template, table)


EXCEL_ROWS = ('name,data_type,feature_type,hash_bucket_size,num_buckets,'
              'embedding_dim,boundaries,group,wide_deep,separator,'
              'max_seq_len\n'
              'label,float,label,,,,,,,,\n'
              'uid,string,id,1000,,16,,user,deep,,\n'
              'age,float,raw,,,,18|25|35|50,user,deep,,\n'
              'tags,string,tag,100,,8,,user,wide_and_deep,|,\n'
              'iid,string,id,5000,,16,,item,deep,,\n'
              'price,double,raw,,,,,item,wide,,\n')


@pytest.mark.parametrize('model_class', ['DeepFM', 'MultiTower',
                                         'WideAndDeep', 'DSSM'])
def test_create_config_from_excel_equals_the_jax_tool(tmp_path, model_class):
  template = str(tmp_path / 'features.csv')
  with open(template, 'w') as f:
    f.write(EXCEL_ROWS)
  texts = []
  for sub, tool in (('jax', j_excel), ('port', t_excel)):
    out = str(tmp_path / (sub + '.config'))
    tool.main(['--template', template, '--model_class', model_class,
               '--output_path', out, '--batch_size', '64'])
    texts.append(open(out).read())
  assert texts[1] == texts[0]
  assert _canon_port(texts[1])['model_config']['model_class'] == model_class
  with pytest.raises(ImportError, match='needs an excel engine'):
    t_excel.main(['--template', str(tmp_path / 'f.xlsx'),
                  '--output_path', str(tmp_path / 'x.config')])


def _pre_check_cases(tmp_path):
  """(name, config text edit) pairs; each breaks one rule."""
  path = fixtures.write_pipeline(tmp_path, num_steps=10)
  text = open(path).read()
  return text, [
      ('ok', text),
      ('missing_input', text.replace('input_names: "d1"', 'input_names: "nope"')),
      ('unknown_feature', text.replace(
          'feature_names: "c1" feature_names: "c2" feature_names: "c3"\n'
          '    wide_deep: WIDE',
          'feature_names: "c1" feature_names: "ghost"\n    wide_deep: WIDE')),
      ('label', text.replace('label_fields: "label"', 'label_fields: "clk"')),
      ('sample_weight', text.replace('label_fields: "label"',
                                     'label_fields: "label" '
                                     'sample_weight: "w"')),
      ('stacked_dims', text.replace(
          'input_names: "c1" feature_type: IdFeature\n'
          '              embedding_dim: 8',
          'input_names: "c1" feature_type: IdFeature\n'
          '              embedding_dim: 16')),
  ]


def test_pre_check_gives_the_jax_tools_messages(tmp_path):
  _, cases = _pre_check_cases(tmp_path)
  for name, text in cases:
    jc = j_config.get_configs_from_pipeline_str(text)
    tc = t_config.get_configs_from_pipeline_str(text)
    want = j_pre.check_config(jc)
    assert t_pre.check_config(tc) == want, name
    assert (want == []) == (name == 'ok'), (name, want)
  jc = j_config.get_configs_from_pipeline_str(cases[0][1])
  tc = t_config.get_configs_from_pipeline_str(cases[0][1])
  assert t_pre.check_data(tc) == j_pre.check_data(jc) == []
  # one epoch of 16 batches: both report where the data ran out
  jc.data_config.num_epochs = tc.data_config.num_epochs = 1
  want = j_pre.check_data(jc, 20)
  assert t_pre.check_data(tc, 20) == want == \
      ['training data exhausted after 16 batches']
  for (name, text), code in ((cases[0], 0), (cases[1], 1)):
    path = str(tmp_path / (name + '.config'))
    with open(path, 'w') as f:
      f.write(text)
    assert t_pre.main(['--pipeline_config_path', path]) == \
        j_pre.main(['--pipeline_config_path', path]) == code


class _FakePredictor:
  """Writes fixed probs, as predict_csv would, for either package's
  predict_and_chk (monkeypatched in)."""
  probs = [0.25, 0.5, 0.125]

  def __init__(self, *a, **kw):
    pass

  def predict_csv(self, input_path, output_path):
    with open(output_path, 'w') as f:
      f.write('logits,probs\n')
      f.writelines('0.0,%r\n' % p for p in self.probs)
    return len(self.probs)


@pytest.mark.parametrize('case', ['no_cmp', 'match', 'within_tol',
                                  'mismatch', 'rows'])
def test_predict_and_chk_lines_and_exit_codes_equal_jax(tmp_path,
                                                        monkeypatch, capsys,
                                                        case):
  from easyrec_torch.export import predictor as t_predictor
  from easyrec_tpu.export import predictor as j_predictor
  monkeypatch.setattr(t_predictor, 'Predictor', _FakePredictor)
  monkeypatch.setattr(j_predictor, 'Predictor', _FakePredictor)
  want = {'match': [0.25, 0.5, 0.125], 'within_tol': [0.25, 0.50005, 0.125],
          'mismatch': [0.25, 0.6, 0.125], 'rows': [0.25, 0.5]}
  args = ['--export_dir', 'e', '--input_path', 'in.csv']
  if case != 'no_cmp':
    cmp_path = str(tmp_path / 'want.csv')
    with open(cmp_path, 'w') as f:
      f.write('probs\n' + ''.join('%r\n' % p for p in want[case]))
    args += ['--cmp_path', cmp_path]
  results = []
  for sub, tool in (('jax', j_pchk), ('port', t_pchk)):
    out = str(tmp_path / 'out.csv')
    try:
      tool.main(args + ['--output_path', out])
      code = 0
    except SystemExit as e:
      code = e.code
    results.append((code, capsys.readouterr().out))
  assert results[1] == results[0]
  assert results[1][0] == (1 if case in ('mismatch', 'rows') else 0)


@pytest.fixture(scope='module')
def port_export(tmp_path_factory):
  tmp = tmp_path_factory.mktemp('export')
  path = fixtures.write_pipeline(tmp, num_steps=20)
  result = t_main.train_and_evaluate(path, device='cpu')
  return path, result


def test_predict_and_chk_and_view_export_on_a_port_export(port_export,
                                                          tmp_path,
                                                          monkeypatch):
  """The real tools on a port export: predict_and_chk's answers against
  the Trainer's eval forward (probs within 1e-6) exit 0; view_export
  describes every tensor and runs the JAX tool's synthetic row."""
  path, result = port_export
  export_dir = result['export_dir']
  cfg = t_config.get_configs_from_pipeline_file(path)
  eval_csv = t_config.get_eval_input_path(cfg)
  rows = t_main.predict(path, input_path=eval_csv, device='cpu')
  want = str(tmp_path / 'want.csv')
  with open(want, 'w') as f:
    f.write('probs\n' + ''.join('%r\n' % float(r['probs']) for r in rows))
  res = t_pchk.predict_and_check(export_dir, eval_csv,
                                 str(tmp_path / 'out.csv'), cmp_path=want,
                                 tol=1e-6, device='cpu')
  assert res['matched'] and res['num_predictions'] == len(rows) == 1024
  summary = t_view.describe_export(export_dir)
  import torch
  state = torch.load(os.path.join(export_dir, 'variables', 'variables.pt'),
                     weights_only=True)
  assert summary['meta'] == json.load(
      open(os.path.join(export_dir, 'export_meta.json')))
  n = sum(t.numel() for t in state['model'].values()) + \
      sum(t.numel() for t in state['tables'].values())
  assert summary['num_parameters'] >= n
  got = t_view.smoke_predict(export_dir, device='cpu')
  assert set(got) >= {'probs', 'logits'} and 0.0 < got['probs'] < 1.0
  # the JAX tool's synthetic row, captured from its Predictor
  seen = []

  class _Capture:
    def __init__(self, export_dir, *a, **kw):
      from easyrec_torch.export.predictor import Predictor
      self._p = Predictor(export_dir, device='cpu')
      self.config = j_config.get_configs_from_pipeline_file(path)
      self.input_names = self._p.input_names

    def predict(self, rows):
      seen.extend(rows)
      return [{'probs': 0.5}]

  from easyrec_tpu.export import predictor as j_predictor
  monkeypatch.setattr(j_predictor, 'Predictor', _Capture)
  j_view.smoke_predict(export_dir)
  from easyrec_torch.export.predictor import Predictor
  assert t_view.smoke_row(Predictor(export_dir, device='cpu')) == seen[0]


SPACE = [
    {'name': 'train_config.optimizer_config[0].adam_optimizer.'
             'learning_rate.constant_learning_rate.learning_rate',
     'type': 'double', 'min': 1e-4, 'max': 1e-1, 'log_scale': True},
    {'name': 'model_config.deepfm.dnn.hidden_units',
     'type': 'categorical', 'candidates': [[16], [32, 16], [8, 8, 8]]},
    {'name': 'train_config.num_steps', 'type': 'int', 'min': 2, 'max': 9},
]


def _fake_train(trials):
  def train(config, **kw):
    lr = (config.train_config.optimizer_config[0].adam_optimizer
          .learning_rate.constant_learning_rate.learning_rate)
    units = list(config.model_config.deepfm.dnn.hidden_units)
    auc = 0.9 - (np.log10(lr) + 2.5) ** 2 - 0.01 * len(units) + \
        0.001 * config.train_config.num_steps
    trials.append(config.model_dir)
    return {'eval_metrics': {'auc': float(auc)}}
  return train


@pytest.mark.parametrize('mode', ['random', 'grid', 'bayes'])
def test_tuner_trials_equal_the_jax_tuners(tmp_path, monkeypatch, mode):
  path = fixtures.write_pipeline(tmp_path, num_steps=1)
  runs = []
  for main_mod, tuner, config_util in ((j_main, j_tuner, j_config),
                                       (t_main, t_tuner, t_config)):
    dirs = []
    monkeypatch.setattr(main_mod, 'train_and_evaluate', _fake_train(dirs))
    cfg = config_util.get_configs_from_pipeline_file(path)
    summary = tuner.LocalTuner(cfg, SPACE, metric='auc', mode=mode,
                               num_trials=8, grid_points=2, seed=11).run()
    runs.append((summary, dirs))
  (js, jd), (ts, td) = runs
  assert td == jd
  assert len(ts['trials']) == len(js['trials']) == (12 if mode == 'grid'
                                                     else 8)
  for jt, tt in zip(js['trials'], ts['trials']):
    for k, v in jt['assignment'].items():
      got = tt['assignment'][k]
      if mode == 'bayes' and isinstance(v, float):
        assert abs(got - v) <= 1e-9 * abs(v), k
      else:
        assert got == v, k
    assert abs(tt['auc'] - jt['auc']) <= 1e-9
  assert ts['best']['trial'] == js['best']['trial']
  written = json.load(open(os.path.join(os.path.dirname(path), 'ckpt',
                                        'hpo_result.json')))
  assert written['best']['trial'] == ts['best']['trial']


def test_tuner_trains_its_trials_on_the_cpu(tmp_path):
  path = fixtures.write_pipeline(tmp_path, num_steps=20)
  space_path = str(tmp_path / 'space.json')
  with open(space_path, 'w') as f:
    json.dump(SPACE[:2], f)
  assert t_tuner.main(['--pipeline_config_path', path, '--search_space_path',
                       space_path, '--num_trials', '2', '--device',
                       'cpu']) is None
  result = json.load(open(os.path.join(str(tmp_path), 'ckpt',
                                       'hpo_result.json')))
  assert len(result['trials']) == 2 and result['best']['auc'] > 0.5
  for i in range(2):
    assert os.path.isdir(os.path.join(str(tmp_path), 'ckpt',
                                      'hpo_trial_%d' % i, 'checkpoints'))


VD_BODY = """
  feature_groups {
    group_name: "all"
    feature_names: "d1" feature_names: "d2"
    feature_names: "c1" feature_names: "c2" feature_names: "c3"
    wide_deep: DEEP
  }
  backbone {
    blocks {
      name: "all"
      inputs { feature_group_name: "all" }
      input_layer { }
    }
    blocks {
      name: "mlp"
      inputs { block_name: "all" }
      keras_layer { class_name: "MLP" mlp { hidden_units: [16] } }
    }
    concat_blocks: "mlp"
  }
  variational_dropout { regularization_lambda: 0.01 }
"""


def test_feature_selection_reads_a_port_checkpoint(tmp_path, capsys):
  path = fixtures.write_pipeline(tmp_path, model_class='RankModel',
                                 model_body=VD_BODY, num_steps=20)
  result = t_main.train_and_evaluate(path, device='cpu')
  cfg = t_config.get_configs_from_pipeline_file(path)
  imp = t_fsel.feature_importance(cfg, device='cpu')
  assert sorted(imp) == ['c1', 'c2', 'c3', 'd1', 'd2']
  logit = result['trainer'].model.state_dict()
  logit = [v for k, v in logit.items() if k.endswith('logit_p')][0]
  want = 1.0 - 1.0 / (1.0 + np.exp(-logit.numpy().astype(np.float64)))
  np.testing.assert_array_equal([imp[n] for n in ('d1', 'd2', 'c1', 'c2',
                                                  'c3')], want)
  jcfg = j_config.get_configs_from_pipeline_file(path)
  assert t_fsel._group_feature_names(cfg, 'all') == \
      j_fsel._group_feature_names(jcfg, 'all')
  out = str(tmp_path / 'imp.json')
  t_fsel.main(['--pipeline_config_path', path, '--output_path', out,
               '--topk', '3', '--device', 'cpu'])
  assert len(json.load(open(out))) == 3
  assert len(capsys.readouterr().out.splitlines()) == 3


EXIT_SCRIPT = r"""
import threading, time
t = threading.Thread(target=lambda: time.sleep(120))
t.start()  # a non-daemon thread: sys.exit would wait 120 s on it
from easyrec_torch.utils.proc import exit_after
exit_after(7)
"""


def test_exit_after_skips_the_shutdown_join():
  start = time.time()
  proc = subprocess.run([sys.executable, '-c', EXIT_SCRIPT], timeout=60,
                        capture_output=True, text=True, cwd=REPO,
                        env={'PATH': '/usr/bin:/bin', 'PYTHONPATH': REPO})
  assert proc.returncode == 7
  assert time.time() - start < 30
  assert 'non-daemon threads still alive' in proc.stderr
  for cli in ('train_eval', 'eval', 'predict', 'export_cli'):
    src = open(os.path.join(REPO, 'easyrec_torch', cli + '.py')).read()
    assert src.rstrip().endswith('exit_after(_rc)'), cli


def test_zoo_registers_every_ported_model():
  from easyrec_torch.models import zoo  # noqa: F401
  from easyrec_torch.utils.registry import MODELS
  missing = [m for m in t_config._PORTED_MODELS if m not in MODELS]
  assert missing == []
