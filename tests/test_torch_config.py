"""The port's text-format config reader (easyrec_torch/config) against the
JAX package's protobuf parse: every field of the port's schema, set or
left at its proto default, reads the same on both sides."""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.config import schema
from easyrec_torch.config import text_format
from easyrec_torch.layers import dnn as t_dnn
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_tpu.config import config_util as j_config
from easyrec_torch.utils.synthetic import synthetic_batch as \
    t_synthetic_batch
from easyrec_tpu.layers import dnn as j_dnn
from easyrec_tpu.utils import flagship as j_flagship
from easyrec_torch.utils import flagship as t_flagship
from tests import fixtures


def _is_repeated(fd):
  rep = getattr(fd, 'is_repeated', None)
  if rep is None:
    return fd.label == fd.LABEL_REPEATED
  return rep() if callable(rep) else rep


def _assert_same(t_msg, j_msg, path):
  """Walk every field of the port's schema for t_msg's type."""
  desc = j_msg.DESCRIPTOR
  for spec in schema.MESSAGES[t_msg.type_name]:
    where = '%s.%s' % (path, spec.name)
    fd = desc.fields_by_name[spec.name]
    assert spec.repeated == _is_repeated(fd), where
    if spec.oneof is not None:
      assert t_msg.WhichOneof(spec.oneof) == j_msg.WhichOneof(spec.oneof), \
          where
    if spec.kind == 'unported':
      if spec.repeated:
        assert not len(getattr(j_msg, spec.name)), where
      else:
        assert not j_msg.HasField(spec.name), where
      continue
    got, want = getattr(t_msg, spec.name), getattr(j_msg, spec.name)
    if not spec.repeated and not spec.message_type and fd.has_presence:
      assert t_msg.HasField(spec.name) == j_msg.HasField(spec.name), where
    if spec.message_type and fd.message_type.GetOptions().map_entry:
      # a protobuf map (Struct.fields): the port's key/value entries
      t_map = {e.key: e.value for e in got}
      assert sorted(t_map) == sorted(want), where
      for k in want:
        _assert_same(t_map[k], want[k], '%s[%s]' % (where, k))
      continue
    if spec.message_type:
      if spec.repeated:
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
          _assert_same(g, w, '%s[%d]' % (where, i))
      else:
        _assert_same(got, want, where)
      continue
    if spec.enum_type:
      names = fd.enum_type.values_by_number
      want = [names[v].name for v in want] if spec.repeated \
          else names[want].name
    if spec.repeated:
      assert list(got) == list(want), where
    else:
      assert got == want and type(got) is type(want), \
          (where, got, want)


def test_flagship_config_matches_protobuf():
  _assert_same(t_flagship.criteo_deepfm_config(),
               j_flagship.criteo_deepfm_config(model_dir=''), 'config')


def test_fixture_config_matches_protobuf(tmp_path):
  path = fixtures.write_pipeline(tmp_path)
  t_cfg = t_config.get_configs_from_pipeline_file(path)
  j_cfg = j_config.get_configs_from_pipeline_file(path)
  _assert_same(t_cfg, j_cfg, 'config')
  assert t_config.get_train_input_path(t_cfg) == j_cfg.train_input_path
  assert t_config.get_eval_input_path(t_cfg) == j_cfg.eval_input_path
  t_feats = t_config.get_feature_configs(t_cfg)
  j_feats = j_config.get_feature_configs(j_cfg)
  assert len(t_feats) == len(j_feats) == 5
  for t_fc, j_fc in zip(t_feats, j_feats):
    _assert_same(t_fc, j_fc, 'feature')


TEXT = r'''
# comment
model_dir: 'a\'b"c\n\x41\101é' "tail"
train_config {
  optimizer_config: {
    adam_optimizer { beta1: 0.8 beta2: 9.99e-1
      learning_rate { constant_learning_rate { learning_rate: 1e-3 } } }
    embedding_learning_rate_multiplier: 2
  }
  num_steps: 0x10;
}
eval_config < metrics_set { auc { num_thresholds: 7 } } >
data_config {
  label_fields: ["a", "b"]
  label_fields: "c"
  input_type: DummyInput
  auto_expand_input_fields: true
  input_fields { input_name: "f[1-3]" input_type: INT64 default_val: "4" }
  with_header: false
  unknown_field_the_port_ignores { x: 1 y: [1, 2] }
}
feature_configs {
  input_names: "f1" feature_type: IdFeature embedding_dim: 4
  num_buckets: 10 shared_names: ["f[2-3]"]
  boundaries: [0.5, 1, 2.25]
}
model_config {
  model_class: "DeepFM"
  feature_groups { group_name: "g" feature_names: "f[1-2]" wide_deep: WIDE }
  deepfm { dnn { hidden_units: [8, 4] dropout_ratio: [0.1] use_bn: false } }
  embedding_regularization: 1.5e-5
}
'''


def test_text_format_values_match_protobuf():
  t_cfg = t_config.get_configs_from_pipeline_str(TEXT)
  j_cfg = j_config.get_configs_from_pipeline_str(TEXT)
  _assert_same(t_cfg, j_cfg, 'config')
  assert t_cfg.model_dir == 'a\'b"c\nAAétail'
  assert t_cfg.train_config.num_steps == 16
  # proto floats hold float32 values
  assert t_cfg.train_config.optimizer_config[0].adam_optimizer.beta1 == \
      float(np.float32(0.8))
  assert [f.input_name for f in t_cfg.data_config.input_fields] == \
      ['f1', 'f2', 'f3']
  assert [fc.input_names for fc in t_config.get_feature_configs(t_cfg)] == \
      [['f1'], ['f2'], ['f3']]
  assert t_cfg.model_config.feature_groups[0].feature_names == ['f1', 'f2']


@pytest.mark.parametrize('fields', ['', 'learning_rate { constant_learning_rate '
                                    '{ learning_rate: 0.03 } }'])
@pytest.mark.parametrize('kind,extra', [
    ('rms_prop_optimizer', 'decay: 0.8 epsilon: 0.5 '
                           'momentum_optimizer_value: 0.1'),
    ('momentum_optimizer', 'momentum_optimizer_value: 0.7'),
    ('adam_optimizer', 'beta1: 0.8'),
    ('momentumw_optimizer', 'weight_decay: 0.01'),
    ('adamw_optimizer', 'weight_decay: 0.02 beta2: 0.99'),
    ('adam_async_optimizer', ''),
    ('adagrad_optimizer', 'initial_accumulator_value: 0.3'),
    ('ftrl_optimizer', 'learning_rate_power: -0.6 l1_reg: 0.1 l2_reg: 0.2 '
                       'l2_shrinkage_reg: 0.3'),
    ('adam_asyncw_optimizer', 'weight_decay: 0.04'),
    ('lazy_adam_optimizer', 'beta2: 0.9')])
def test_optimizer_messages_match_protobuf(kind, extra, fields):
  """Every optimizer message, with its fields set or left at the defaults
  of train.proto, and gradient_clipping_by_norm, read as the protobuf
  parse reads them; none is refused as unported."""
  text = ('train_config { optimizer_config { %s { %s } '
          'embedding_learning_rate_multiplier: 0.5 } '
          'optimizer_config { %s { %s %s } } '
          'gradient_clipping_by_norm: 2.5 }\n'
          'model_config { model_class: "DeepFM" }'
          % (kind, fields, kind, extra, fields))
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  _assert_same(t_cfg, j_config.get_configs_from_pipeline_str(text), 'config')
  t_config.check_ported(t_cfg)


@pytest.mark.parametrize('text,what', [
    ('model_config { model_class: "DIN" }', "model_class 'DIN'"),
    # the streaming, warehouse and Parquet inputs are ported: these three
    # cases now pass check_ported (what is None), under their former ids
    pytest.param('kafka_train_input { server: "s" }', None,
                 id='kafka_train_input { server: "s" }-kafka_train_input'),
    pytest.param('data_config { input_type: OdpsInput }', None,
                 id='data_config { input_type: OdpsInput }-'
                    'input_type OdpsInput'),
    pytest.param('data_config { input_type: ParquetInput }', None,
                 id='data_config { input_type: ParquetInput }-'
                    'input_type ParquetInput'),
    ('feature_configs { input_names: "s" feature_type: SequenceFeature '
     'sequence_combiner { text_cnn { mlp { hidden_units: 4 } } } }',
     'text_cnn.mlp'),
])
def test_unported_parts_raise_naming_them(text, what):
  base = 'model_config { model_class: "DeepFM" }\n'
  cfg = t_config.get_configs_from_pipeline_str(base + text)
  if what is None:
    t_config.check_ported(cfg)
    return
  with pytest.raises(NotImplementedError, match=what):
    t_config.check_ported(cfg)


@pytest.mark.parametrize('text,what', [
    ('train_config { dead_line: "20220508 23:59:59" }', 'dead_line'),
    ('train_config { enable_oss_stop_signal: true }',
     'enable_oss_stop_signal'),
    ('export_config { exporter_type: "best" }', 'export_config'),
    ('eval_config { eval_online: true }', 'eval_online'),
])
def test_hook_and_export_fields_are_ported(text, what):
  """The fields of the in-train hooks and the exporter, unported until
  the serving slice, read as the protobuf parse reads them and pass
  check_ported."""
  base = 'model_config { model_class: "DeepFM" }\n'
  cfg = t_config.get_configs_from_pipeline_str(base + text)
  _assert_same(cfg, j_config.get_configs_from_pipeline_str(base + text),
               'config')
  assert what in text_format.to_text(cfg)
  t_config.check_ported(cfg)


def test_a_read_empty_repeated_field_is_not_set():
  """Reading a repeated field (as the models read a group's
  sequence_features) leaves it empty, which protobuf counts as unset:
  check_ported still passes, so one config can build two trainers."""
  cfg = t_flagship.criteo_deepfm_config(batch_size=8, hash_bucket_size=10,
                                        num_dense=1, num_cat=1)
  for group in cfg.model_config.feature_groups:
    assert list(group.sequence_features) == []
  assert not cfg.train_config.freeze_gradient
  fc = t_config.get_feature_configs(cfg)[0]
  assert not fc.combo_input_seps
  t_config.check_ported(cfg)
  assert 'combo_input_seps' not in text_format.to_text(cfg)
  fc.combo_input_seps = ['#']
  assert 'combo_input_seps' in text_format.to_text(cfg)


def test_parse_errors():
  with pytest.raises(text_format.ParseError):
    text_format.parse('train_config { num_steps: 1 ')
  with pytest.raises(text_format.ParseError):
    text_format.parse('data_config { input_type: NoSuchInput }')
  with pytest.raises(text_format.ParseError):
    text_format.parse('train_config { num_steps: 1.5 }')


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the samples with a backbone, less kd_backbone, which sets the unported
# kd
BACKBONE_SAMPLES = sorted(
    p for p in glob.glob(os.path.join(REPO, 'samples', '*.config'))
    if 'backbone {' in open(p).read() and 'kd {' not in open(p).read())


@pytest.mark.parametrize('path', BACKBONE_SAMPLES,
                         ids=[os.path.basename(p)[:-7]
                              for p in BACKBONE_SAMPLES])
def test_backbone_messages_match_protobuf(path):
  """Every backbone sample's model_config: each field of the backbone's
  messages (layers.proto, common.proto's MLP, models.proto's ModelParams,
  google.protobuf.Struct), set or left at its proto default, reads the
  same as the protobuf parse; so the registry's Parameter reads the
  defaults the JAX one reads."""
  _assert_same(t_config.get_configs_from_pipeline_file(path).model_config,
               j_config.get_configs_from_pipeline_file(path).model_config,
               'model_config')


# DNN settings that check_ported passed and the model refused to build
# before dropout, dice and softmax were ported
DNN_CASES = {
    'dice': 'dnn { hidden_units: [8, 4] activation: "dice" }',
    'softmax': 'dnn { hidden_units: [8, 4] activation: "softmax" }',
    'dropout': 'dnn { hidden_units: [8, 4] dropout_ratio: [0.1, 0.1] }',
}


def _dnn_config(case):
  """The small flagship DeepFM with its deep DNN set to the case."""
  text = text_format.to_text(t_flagship.criteo_deepfm_config(
      batch_size=64, hash_bucket_size=50, num_dense=2, num_cat=3))
  dnn = ('dnn {\n      hidden_units: 256\n      hidden_units: 128\n'
         '      hidden_units: 64\n    }')
  assert dnn in text
  return text.replace(dnn, DNN_CASES[case], 1)


@pytest.mark.parametrize('case', sorted(DNN_CASES))
def test_dnn_settings_check_ported_passes_are_built(case):
  """A DeepFM whose deep DNN sets activation dice or softmax, or a
  nonzero dropout_ratio: check_ported accepts it, its Trainer builds and
  trains a step; dice and softmax towers are held to the JAX DNN in eval
  mode (1e-5) from one set of flax variables, Dice's `dice_<i>/alpha`
  and `dice_<i>/BatchNorm_0` statistics carried by convert.py."""
  text = _dnn_config(case)
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  t_config.check_ported(t_cfg)
  trainer = TTrainer(t_cfg, device='cpu')
  trainer.init_state()
  batch = t_synthetic_batch(trainer.specs, ['label'], 64, seed=0)
  loss = trainer.train_step(to_device(batch, torch.device('cpu')))
  assert np.isfinite(float(loss['total_loss']))
  if case == 'dropout':
    return
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  x = np.random.default_rng(0).standard_normal((32, 12)).astype(np.float32)
  j_mod = j_dnn.DNN.from_config(j_cfg.model_config.deepfm.dnn)
  variables = j_mod.init(jax.random.PRNGKey(0), x, False)
  rng = np.random.default_rng(1)
  variables = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + rng.random(np.shape(a)).astype(np.float32),
      variables)
  t_mod = t_dnn.DNN.from_config(t_cfg.model_config.deepfm.dnn, 12)
  sd = convert.flax_to_state_dict(variables['params'],
                                  variables['batch_stats'], root=None)
  assert sorted(sd) == sorted(t_mod.state_dict())
  if case == 'dice':
    assert 'dice_1.alpha' in sd and 'dice_0.BatchNorm_0.running_var' in sd
  t_mod.load_state_dict(sd)
  t_mod.eval()
  np.testing.assert_allclose(
      t_mod(torch.from_numpy(x)).detach().numpy(),
      np.asarray(j_mod.apply(variables, x, False)), rtol=1e-5, atol=1e-5)


def test_dnn_dropout_mask_keeps_its_share():
  """dropout_ratio 0.1 in training: over 10^5 elements the kept share is
  within 4 sigma of 0.9 and every kept value is scaled by 1 / 0.9."""
  drop = t_dnn.Dropout(0.1)
  t_dnn.set_generator(drop, torch.Generator().manual_seed(0))
  x = torch.ones(1000, 100)
  y = drop(x)
  kept = (y != 0).float().mean().item()
  assert abs(kept - 0.9) < 4 * np.sqrt(0.9 * 0.1 / x.numel())
  np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.9, rtol=1e-6)
  drop.eval()
  assert drop(x) is x
