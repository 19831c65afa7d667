"""fg.json configs, --check_mode and the label functions of the port
against the JAX package on the CPU: convert_rtp_fg on samples/fg/
taobao_fg.json and on tests/test_fg_util.py's fixtures (and one of every
other fg type), field for field through tests/test_torch_samples.py's
_compare; the sample's config loaded through main; validate_columns on
tests/test_check_mode.py's bad columns, the same error (type, message) at
the same feature, row and value; a label field's user_define_fn and
extra_label_func through both pipelines; the train CLI's flags."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from easyrec_torch import main as t_main
from easyrec_torch.config import config_util as t_config
from easyrec_torch.data import check as t_check
from easyrec_torch.data import input_pipeline as t_input
from easyrec_torch.features import feature_spec as t_fs
from easyrec_torch.utils import fg_util as t_fg
from easyrec_tpu import main as j_main
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.data import check as j_check
from easyrec_tpu.data import input_pipeline as j_input
from easyrec_tpu.features import feature_spec as j_fs
from easyrec_tpu.utils import fg_util as j_fg
from tests import fixtures
from tests.test_check_mode import CONFIG as CHECK_CONFIG
from tests.test_fg_util import FG
from tests.test_torch_samples import _compare

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one of every other fg type and option convert_rtp_fg reads
FG_ALL = {
    'features': [
        {'feature_type': 'id_feature', 'expression': 'user:kv',
         'kv_separator': ':', 'hash_bucket_size': 10},
        {'feature_type': 'id_feature', 'expression': 'item:vf',
         'vocab_file': 'vocab.txt', 'embedding_dim': 4},
        {'feature_type': 'id_feature', 'expression': 'item:nb',
         'num_buckets': 7},
        {'feature_type': 'id_feature', 'expression': 'item:bd',
         'boundaries': [1, 2]},
        {'feature_type': 'id_feature', 'expression': 'item:dflt'},
        {'feature_type': 'raw_feature', 'expression': 'user:vec',
         'value_dimension': 3, 'normalizer': 'numpy.log1p',
         'value_type': 'double'},
        {'feature_type': 'raw_feature', 'expression': 'user:proj',
         'embedding_dimension': 6, 'value_type': 'integer'},
        {'feature_type': 'lookup_feature', 'feature_name': 'lk',
         'key': 'item:cate', 'map': 'user:kvmap', 'hash_bucket_size': 50},
        {'feature_type': 'match_feature', 'feature_name': 'mt',
         'user': 'user:umap', 'category': 'item:cate', 'item': 'item:iid',
         'needDiscrete': False, 'boundaries': [0.5]},
        {'feature_type': 'lookup_feature', 'feature_name': 'lk_bare',
         'expression': 'user:bare'},
        {'feature_type': 'expr_feature', 'feature_name': 'ratio',
         'expression': 'a / (b + 1)', 'variables': ['user:a', 'item:b'],
         'embedding_dimension': 4},
        {'sequence_name': 'seq', 'sequence_length': 7,
         'sequence_delim': ';',
         'features': [
             {'feature_type': 'raw_feature', 'expression': 'item:price',
              'boundaries': [1, 10]},
             {'feature_type': 'id_feature', 'expression': 'item:iid',
              'vocab_list': ['a', 'b']}]},
    ],
}


def _compare_converted(j_out, t_out):
  assert j_out['label_fields'] == t_out['label_fields']
  for key in ('feature_configs', 'input_fields'):
    assert len(j_out[key]) == len(t_out[key]), key
    for i, (a, b) in enumerate(zip(j_out[key], t_out[key])):
      found = set()
      _compare(a, b, '%s[%d]' % (key, i), found)
      assert not found, found


@pytest.mark.parametrize('fg', ['taobao', 'fg_util', 'all_types'])
def test_convert_rtp_fg_matches_jax(fg):
  if fg == 'taobao':
    with open(os.path.join(REPO, 'samples', 'fg', 'taobao_fg.json')) as f:
      fg = json.load(f)
  else:
    fg = FG if fg == 'fg_util' else FG_ALL
  for kw in ({}, {'embedding_dim': 8, 'label_fields': ['y']}):
    _compare_converted(j_fg.convert_rtp_fg(copy.deepcopy(fg), **kw),
                       t_fg.convert_rtp_fg(copy.deepcopy(fg), **kw))
  with pytest.raises(ValueError, match='pretend_feature'):
    t_fg.convert_rtp_fg({'features': [{'feature_type': 'pretend_feature'}]})


def test_taobao_fg_sample_loads_as_jax(monkeypatch):
  """samples/taobao_fg.config's relative fg_json_path resolves from the
  working directory in both packages; the loaded configs agree field for
  field, and the port accepts the result."""
  monkeypatch.chdir(REPO)
  path = os.path.join(REPO, 'samples', 'taobao_fg.config')
  t_cfg = t_main.load_config(path)
  j_cfg = j_main._load(path)
  found = set()
  _compare(j_cfg, t_cfg, 'taobao_fg', found)
  assert not found, found
  names = [f.input_name for f in t_cfg.data_config.input_fields]
  assert names == ['clk', 'user_id', 'cms_segid', 'final_gender_code',
                   'age_level', 'occupation', 'adgroup_id', 'cate_id',
                   'brand', 'price', 'tags', 'click_seq__cate_id',
                   'click_seq__brand']
  assert list(t_cfg.data_config.label_fields) == ['clk']
  t_config.check_ported(t_cfg)
  # a config that sets its own fields keeps them
  t_cfg.data_config.label_fields = ['other']
  t_fg.load_fg_json_to_config(t_cfg)
  assert list(t_cfg.data_config.label_fields) == ['other']


@pytest.mark.parametrize('text', [
    'feature_configs { input_names: "t" input_names: "u" feature_type: '
    'ComboFeature combo_input_seps: "" combo_input_seps: "|" '
    'combo_join_sep: "#" hash_bucket_size: 10 }',
    'feature_configs { input_names: "k" input_names: "m" feature_type: '
    'LookupFeature lookup_max_sel_elem_num: 3 }',
    'feature_configs { input_names: "a" feature_type: ExprFeature '
    'expression: "a * 2" }',
    'feature_configs { input_names: "a" feature_type: PassThroughFeature }',
    'train_config { incr_save_config { sparse_save_steps: 5 '
    'dense_save_secs: 7 kafka { server: "s:1" topic: "t" '
    'consumer { offset: 3 } } } save_summary_steps: 4 }',
    'train_config { incr_save_config { datahub { akId: "a" akSecret: "b" '
    'region: "r" project: "p" topic: "t" } } }',
    'train_config { incr_save_config { fs { relative: false '
    'incr_save_dir: "/x" } } }',
    'fg_json_path: "fg.json"',
    'data_config { input_fields { input_name: "l" user_define_fn: "f.g" } '
    'extra_label_func { label_name: "y" label_func: "a.b" } }',
])
def test_slice_fields_read_as_jax_and_pass(text):
  """The fields this slice ports read as the protobuf parse reads them,
  and check_ported passes them."""
  text = 'model_config { model_class: "DeepFM" }\n' + text
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  found = set()
  _compare(j_config.get_configs_from_pipeline_str(text), t_cfg, 'cfg', found)
  assert not found, found
  t_config.check_ported(t_cfg)


# ------------------------------------------------------------- check mode


def _check_specs():
  text = CHECK_CONFIG.format(train='x').replace('{{', '{').replace('}}', '}')
  t = t_config.get_configs_from_pipeline_str(text)
  j = j_config.get_configs_from_pipeline_str(text)
  return (t_fs.build_feature_specs(t_config.get_feature_configs(t)),
          j_fs.build_feature_specs(j_config.get_feature_configs(j)))


GOOD = [('1', '0.1|0.2|0.3', 'a:1.5|b:2'), ('0', '1|2|3', 'c:0.5')]
BAD = {
    'raw_arity': ('1', '0.1|0.2', 'a:1'),
    'raw_value': ('1', '0.1|oops|0.3', 'a:1'),
    'kv_split': ('1', '1|2|3', 'a:1:9'),
    'kv_weight': ('1', '1|2|3', 'a:xx'),
    'kv_blank': ('1', '1|2|3', 'a:'),
    'label': ('huh', '1|2|3', 'a:1'),
}


def _raised(fn):
  try:
    fn()
  except ValueError as e:
    return type(e).__name__, str(e)
  return None


@pytest.mark.parametrize('bad', sorted(BAD))
def test_validate_columns_points_as_jax(bad):
  t_specs, j_specs = _check_specs()
  rows = GOOD + [BAD[bad]]
  cols = {name: np.array([r[i] for r in rows], dtype=object)
          for i, name in enumerate(('label', 'vec', 'kvtags'))}
  t_err = _raised(lambda: t_check.validate_columns(t_specs, dict(cols),
                                                   ['label']))
  j_err = _raised(lambda: j_check.validate_columns(j_specs, dict(cols),
                                                   ['label']))
  assert t_err is not None and t_err == j_err
  assert 'row 2' in t_err[1]
  assert t_check.validate_columns(
      t_specs, {k: v[:2] for k, v in cols.items()}, ['label']) is None


def test_seq_raw_and_lookup_validators_as_jax():
  for fn, args in (
      ('_check_seq_raw', (np.array(['1|2', '3;4|5']), '|', ';', 2, 'seq')),
      ('_check_seq_raw', (np.array(['1|x;2|3']), '|', ';', 2, 'seq')),
      ('_check_lookup_map', (np.array(['a:1', 'b:2:3']), '|', ':', 'lk'))):
    t_err = _raised(lambda: getattr(t_check, fn)(*args))
    j_err = _raised(lambda: getattr(j_check, fn)(*args))
    assert t_err is not None and t_err == j_err


def _pipeline(tmp_path, rows, check_mode):
  train = os.path.join(str(tmp_path), 'train.csv')
  with open(train, 'w') as f:
    f.write(''.join(','.join(r) + '\n' for r in rows))
  cfg = t_config.get_configs_from_pipeline_str(
      CHECK_CONFIG.format(train=train))
  return t_input.InputPipeline(cfg.data_config,
                               t_config.get_feature_configs(cfg), train,
                               check_mode=check_mode)


def test_pipeline_check_mode(tmp_path):
  """Under check_mode the port's pipeline raises CheckError at the bad
  row of the chunk; without it, the row reads its defaults."""
  with pytest.raises(t_check.CheckError,
                     match=r"field 'kvtags' row 2.*'a:1:9'"):
    next(iter(_pipeline(tmp_path, GOOD + [BAD['kv_split']], True)))
  batch = next(iter(_pipeline(tmp_path, GOOD * 4, True)))
  assert batch['feat.vec.weights'].shape == (8, 3)
  next(iter(_pipeline(tmp_path, GOOD + [BAD['kv_split']], False)))
  # a FLOAT label the reader cannot type names its value
  with pytest.raises(ValueError, match='huh'):
    next(iter(_pipeline(tmp_path, GOOD + [BAD['label']], True)))


# ---------------------------------------------------------- label functions


def halve(values):
  """A label field's user_define_fn."""
  return values * 0.5


LABEL_CONFIG = '''
data_config {
  batch_size: 16
  label_fields: "label"
  label_fields: "buy"
  input_fields { input_name: "label" input_type: FLOAT
                 user_define_fn: "tests.test_torch_fg_check.halve" }
  input_fields { input_name: "buy" input_type: INT32
                 user_define_fn: "numpy.log1p" }
  input_fields { input_name: "c1" input_type: STRING }
  extra_label_func { label_name: "squared"
                     label_func: "tests.fixtures.extra_label_and" }
  input_type: CSVInput
  shuffle: false
}
feature_config {
  features { input_names: "c1" feature_type: IdFeature
             hash_bucket_size: 10 embedding_dim: 4 }
}
'''


@pytest.mark.parametrize('mode', ['train', 'predict'])
def test_label_functions_match_jax(tmp_path, mode):
  path = os.path.join(str(tmp_path), 'd.csv')
  with open(path, 'w') as f:
    for i in range(40):
      f.write('%.2f,%d,c%d\n' % (i / 7.0, i % 4, i % 5))
  t_cfg = t_config.get_configs_from_pipeline_str(LABEL_CONFIG)
  j_cfg = j_config.get_configs_from_pipeline_str(LABEL_CONFIG)
  t_b = next(iter(t_input.InputPipeline(
      t_cfg.data_config, t_config.get_feature_configs(t_cfg), path,
      mode=mode)))
  j_b = next(iter(j_input.InputPipeline(
      j_cfg.data_config, j_config.get_feature_configs(j_cfg), path,
      mode=mode)))
  labels = sorted(k for k in j_b if k.startswith('label.'))
  assert labels == sorted(k for k in t_b if k.startswith('label.'))
  assert ('label.squared' in labels) == (mode == 'train')
  for k in labels:
    assert t_b[k].dtype == j_b[k].dtype == np.float32
    np.testing.assert_array_equal(t_b[k], j_b[k], err_msg=k)
  np.testing.assert_array_equal(
      t_b['label.label'][:16],
      np.float32([float('%.2f' % (i / 7.0)) for i in range(16)]) * 0.5)


# ------------------------------------------------------------------ the CLI


def test_train_cli_flags(tmp_path):
  """--model_dir, --continue_train, --fit_on_eval(_steps), --check_mode
  and --fine_tune_checkpoint, in subprocesses on the CPU."""
  env = dict(os.environ, PYTHONPATH=REPO)

  def run(*args):
    r = subprocess.run([sys.executable, '-m', 'easyrec_torch.train_eval',
                        '--pipeline_config_path', path, '--device', 'cpu',
                        *args], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stderr

  path = fixtures.write_pipeline(tmp_path, num_steps=20)
  md = os.path.join(str(tmp_path), 'md')
  out = run('--model_dir', md, '--check_mode', '--fit_on_eval',
            '--fit_on_eval_steps', '3')
  assert 'done: step=23' in out and 'fit_on_eval: 3 extra steps' in out
  assert os.path.isdir(os.path.join(md, 'checkpoints', '20'))
  out = run('--model_dir', md, '--continue_train', '--num_steps', '30')
  assert 'restored checkpoint at step 20' in out and 'done: step=30' in out
  assert 'already contains checkpoints' not in out
  ft = os.path.join(str(tmp_path), 'ft')
  out = run('--model_dir', ft, '--fine_tune_checkpoint', md,
            '--num_steps', '5')
  assert 'done: step=5' in out and 'fine-tune' in out.lower()


@pytest.mark.parametrize('bad', ['kv_split', 'raw_value'])
def test_eval_cli_check_mode_points_as_jax(tmp_path, bad):
  """The eval CLI's --check_mode (JAX eval.py:22, :35; main.py:104-113):
  on a checkpoint trained from good rows, an eval input with a bad row
  raises the JAX eval's error, type and message, through
  `python -m easyrec_torch.eval` (its main, in process) and through
  main.evaluate and distribute_evaluate; without the flag the row reads
  its defaults and the eval runs."""
  from easyrec_torch import eval as t_eval_cli
  train = os.path.join(str(tmp_path), 'train.csv')
  evalp = os.path.join(str(tmp_path), 'eval.csv')
  with open(train, 'w') as f:
    f.write(''.join(','.join(r) + '\n' for r in GOOD * 8))
  with open(evalp, 'w') as f:
    f.write(''.join(','.join(r) + '\n' for r in GOOD + [BAD[bad]]))
  text = CHECK_CONFIG.format(train=train).replace(
      'eval_input_path: "%s"' % train, 'eval_input_path: "%s"' % evalp)
  text = text.replace('model_dir: ""', 'model_dir: "%s"' % os.path.join(
      str(tmp_path), 'md'))
  path = os.path.join(str(tmp_path), 'pipeline.config')
  with open(path, 'w') as f:
    f.write(text)
  t_main.train_and_evaluate(path, device='cpu',
                            edit_config_json={'export_config.exporter_type':
                                              'none'})
  j_err = _raised(lambda: j_main.evaluate(path, check_mode=True))
  assert j_err is not None and j_err[0] == 'CheckError', j_err
  for run in (lambda: t_eval_cli.main(['--pipeline_config_path', path,
                                       '--check_mode', '--device', 'cpu']),
              lambda: t_main.distribute_evaluate(path, device='cpu',
                                                 check_mode=True)):
    assert _raised(run) == j_err
  metrics = t_main.evaluate(path, device='cpu')
  assert 'auc' in metrics
