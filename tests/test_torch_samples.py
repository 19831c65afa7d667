"""Every samples/*.config through the port's config reader against the JAX
package's protobuf parse: each field the JAX side sets is read by the port
with the same value, or listed in the port's schema as unported (so
check_ported names it), or on IGNORED below, fields that change nothing the
port computes. The samples that pass check_ported are counted and named,
each trains a step on the CPU (the gzip CSV sample through its gzip
reader, the TFRecord sample through its TFRecord reader), and a gzip copy
of a CSV reads as the CSV does."""

import glob
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from easyrec_torch.config import config_util as t_config
from easyrec_torch.config import schema
from easyrec_torch.config import text_format as t_text
from easyrec_torch.data import input_pipeline as t_input
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_tpu.config import config_util as j_config
from tests import fixtures
from tests.test_samples import (MM_COLS, STANDARD_COLS, _write_csv,
                                _write_edges, _write_items)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = sorted(glob.glob(os.path.join(REPO, 'samples', '*.config')))

# Fields a sample sets that the port's schema does not hold, each with why
# it changes nothing the port computes.
IGNORED = {
    # export_config's TF placeholder knobs: they shape the reference's
    # SavedModel signature, and neither the JAX package nor the port
    # reads them
    'ExportConfig.batch_size', 'ExportConfig.multi_placeholder',
    'ExportConfig.filter_inputs', 'ExportConfig.placeholder_named_by_input',
    'ExportConfig.multi_value_fields', 'ExportConfig.auto_multi_value',
}

# The samples check_ported accepts: the 46 of the classic, sequence and
# multi-task families, then the backbone DSL's 20 and the three with
# variational_dropout (which only a backbone reads), then the match
# family's 19 (kd_backbone, a backbone RankModel with a kd term, among
# them), then the rest of the rank zoo's 15 (CMBF, Uniter and DBMTL's
# multi-modal bottoms; the ranking losses, the grouped and multi-class
# metrics, bf16 and freeze_gradient).
PORTED = ['autoint', 'autoint_seq_group', 'best_exporter_early_stop',
          'dbmtl', 'dbmtl_seq_group_attention', 'dbmtl_seq_numeric_boundary',
          'dcn_max_f1', 'dcn_seq_group', 'dcn_v2', 'dead_line_stop',
          'deepfm', 'deepfm_adamw', 'deepfm_ema', 'deepfm_ev_params',
          'deepfm_focal_f1', 'deepfm_gzip_csv', 'deepfm_momentumw',
          'deepfm_multi_loss', 'deepfm_sample_weight', 'deepfm_seq_attn',
          'deepfm_tfrecord', 'deepfm_vocab', 'deepfm_with_embed',
          'din_kv_tags_seq_combiner', 'dlrm', 'esmm', 'esmm_seq', 'fm',
          'mmoe', 'mmoe_seq_aux_hist', 'mmoe_uncertainty_weight',
          'multi_opt_seq_din', 'multi_tower_bst', 'multi_tower_din',
          'multi_tower_plain', 'ple', 'ple_seq_group', 'raw_boundaries',
          'rocket_launching', 'rocket_logit_distill', 'rocket_seq',
          'seq_text_cnn_combiner', 'share_embedding_not_used',
          'simple_multi_task', 'wide_and_deep', 'wide_and_deep_no_final']
BACKBONE = ['aitm_backbone', 'autodis_numeric', 'bst_backbone',
            'cdn_backbone', 'cin_backbone', 'cl4srec_backbone',
            'contrastive_backbone', 'dcn_backbone', 'deepfm_backbone',
            'dlrm_autodis', 'dlrm_backbone', 'dlrm_narydis', 'dlrm_periodic',
            'dlrm_senet_backbone', 'fibinet_backbone', 'highway_backbone',
            'masknet_backbone', 'periodic_numeric', 'ppnet_backbone',
            'wide_and_deep_backbone']
VARIATIONAL_DROPOUT = ['dbmtl_variational_dropout',
                       'esmm_variational_dropout',
                       'multi_tower_variational_dropout']
MATCH = ['dat', 'dat_inner_simi', 'dropoutnet', 'dropoutnet_neg_sampler_v2',
         'dssm_hard_neg_sampler', 'dssm_kd', 'dssm_neg_sampler', 'dssm_reg',
         'dssm_senet', 'kd_backbone', 'metric_learning_i2i',
         'metric_learning_ms', 'mind', 'mind_neg_sampler', 'mind_time_id',
         'multi_tower_recall', 'parallel_dssm_backbone', 'pdn',
         'pdn_neg_sampler']
RANK_EXTRA = ['cmbf', 'cmbf_image_only', 'cmbf_multi_loss', 'cmbf_text_only',
              'dbmtl_cmbf', 'dbmtl_uniter', 'deepfm_bf16', 'deepfm_multi_cls',
              'deepfm_ziln', 'gauc_session_metrics', 'losses_pairwise',
              'multi_optimizer_freeze', 'uniter', 'uniter_image_only',
              'uniter_text_only']
PORTED = sorted(PORTED + BACKBONE + VARIATIONAL_DROPOUT + MATCH + RANK_EXTRA)

# The samples still refused, with the part check_ported names: feature
# types and fg (ROADMAP A6d), incremental saves (A2's leftovers) and
# Parquet, which needs pyarrow.
REFUSED = {
    'combo_cross': 'combo_input_seps',
    'expr_feature': 'expression',
    'lookup_feature': 'feature_type LookupFeature',
    'taobao_fg': 'fg_json_path',
    'deepfm_incr_save': 'incr_save_config',
    'ev_incr_save': 'incr_save_config',
    'dlrm_parquet': 'input_type ParquetInput',
}


def _name(path):
  return os.path.basename(path)[:-len('.config')]


def _compare(j_msg, t_msg, path, found):
  """Walk every field j_msg sets; collect unported and ignored ones in
  `found`, assert the rest read alike."""
  for fd, j_val in j_msg.ListFields():
    where = '%s.%s' % (t_msg.type_name, fd.name)
    if not schema.has_field(t_msg.type_name, fd.name):
      assert where in IGNORED, '%s (%s) is neither read nor listed' % (
          where, path)
      found.add(where)
      continue
    spec = schema.field(t_msg.type_name, fd.name)
    if spec.kind == 'unported':
      found.add('unported:' + where)
      continue
    t_val = getattr(t_msg, fd.name)
    if fd.message_type is not None and \
        fd.message_type.GetOptions().map_entry:
      # a protobuf map (Struct.fields): the port holds its entries as a
      # list of key/value messages, the last of a key winning
      t_map = {e.key: e.value for e in t_val}
      assert sorted(t_map) == sorted(j_val), where
      for k in j_val:
        _compare(j_val[k], t_map[k], '%s.%s[%s]' % (path, fd.name, k),
                 found)
      continue
    if spec.message_type:
      j_items = list(j_val) if spec.repeated else [j_val]
      t_items = list(t_val) if spec.repeated else [t_val]
      assert len(j_items) == len(t_items), where
      for i, (a, b) in enumerate(zip(j_items, t_items)):
        _compare(a, b, '%s.%s[%d]' % (path, fd.name, i), found)
      continue
    if spec.enum_type:
      names = fd.enum_type.values_by_number
      j_val = [names[v].name for v in j_val] if spec.repeated \
          else names[j_val].name
    if spec.repeated:
      assert list(t_val) == list(j_val), where
    else:
      assert t_val == j_val, (where, t_val, j_val)


@pytest.mark.parametrize('path', SAMPLES, ids=[_name(p) for p in SAMPLES])
def test_every_field_is_read_or_listed(path):
  j_cfg = j_config.get_configs_from_pipeline_file(path)
  t_cfg = t_config.get_configs_from_pipeline_file(path)
  found = set()
  _compare(j_cfg, t_cfg, _name(path), found)
  unported = {f for f in found if f.startswith('unported:')}
  if unported:
    with pytest.raises(NotImplementedError):
      t_config.check_ported(t_cfg)


def _passes(path):
  try:
    t_config.check_ported(t_config.get_configs_from_pipeline_file(path))
  except NotImplementedError:
    return False
  return True


def test_samples_that_pass_check_ported():
  assert [_name(p) for p in SAMPLES if _passes(p)] == PORTED
  assert len(PORTED) == 103
  assert len(SAMPLES) - len(PORTED) == len(REFUSED) == 7
  for name, part in REFUSED.items():
    with pytest.raises(NotImplementedError, match=part):
      t_config.check_ported(t_config.get_configs_from_pipeline_file(
          os.path.join(REPO, 'samples', name + '.config')))
  for name, field in (('dead_line_stop', 'dead_line'),
                      ('best_exporter_early_stop', 'export_config')):
    cfg = t_config.get_configs_from_pipeline_file(
        os.path.join(REPO, 'samples', name + '.config'))
    assert field in t_text.to_text(cfg)
    t_config.check_ported(cfg)
  # the text_cnn sequence combiner, which failed by name before the
  # sequence family was ported, passes
  cfg = t_config.get_configs_from_pipeline_file(
      os.path.join(REPO, 'samples', 'seq_text_cnn_combiner.config'))
  assert cfg.feature_config.features[-1].sequence_combiner.WhichOneof(
      'combiner') == 'text_cnn'
  t_config.check_ported(cfg)


@pytest.mark.parametrize('name', PORTED)
def test_ported_samples_train_a_step(name, tmp_path):
  """Each sample check_ported accepts, on data of its declared columns
  (tests/test_samples.py's generator; a sampler's items.txt and edges.txt
  by its writers), model_dir cleared: its train input (the gzip sample
  through gzip) feeds one step on the CPU; deepfm_ema's EMA of the dense
  parameters moves with it. A multi-task sample's loss has one term per
  task, a kd sample's its kd term, and a sampler's batch its views."""
  cfg = t_config.get_configs_from_pipeline_file(
      os.path.join(REPO, 'samples', name + '.config'))
  cols = [f.input_name for f in cfg.data_config.input_fields]
  assert set(cols) <= set(STANDARD_COLS) | set(MM_COLS) | {'seq_price',
                                                            'teacher'}
  which = cfg.data_config.WhichOneof('sampler')
  if which:
    sampler = getattr(cfg.data_config, which)
    _write_items(str(tmp_path / 'items.txt'))
    _write_edges(str(tmp_path / 'edges.txt'))
    for field in ('input_path', 'user_input_path', 'item_input_path',
                  'pos_edge_input_path', 'hard_neg_edge_input_path'):
      if schema.has_field(sampler.type_name, field):
        setattr(sampler, field, str(tmp_path / (
            'edges.txt' if 'edge' in field else 'items.txt')))
  train = str(tmp_path / 'train.csv')
  _write_csv(train, cols, 64, seed=11)
  if cfg.data_config.input_type == 'TFRecordInput':
    train = _csv_to_tfrecord(train, cfg.data_config.input_fields)
  elif cfg.train_input_path.endswith('.gz'):
    with open(train, 'rb') as src, gzip.open(train + '.gz', 'wb') as g:
      shutil.copyfileobj(src, g)
    train += '.gz'
  cfg.train_input_path = cfg.eval_input_path = train
  cfg.model_dir = ''
  cfg.data_config.batch_size = 32
  trainer = TTrainer(cfg, device='cpu')
  trainer.init_state()
  before = {k: v.detach().clone()
            for k, v in trainer.model.named_parameters()}
  batch = next(iter(trainer.train_input()))
  assert ('neg.feat.iid.ids' in batch) == bool(which)
  assert ('hard_neg_mask' in batch) == (which == 'hard_negative_sampler')
  loss = trainer.train_step(to_device(batch, torch.device('cpu')))
  for kd in cfg.model_config.kd:
    assert kd.loss_name in loss
  assert np.isfinite(float(loss['total_loss']))
  model = cfg.model_config.WhichOneof('model')
  if model in ('mmoe', 'esmm', 'dbmtl', 'simple_multi_task', 'ple'):
    # one term a task, and dbmtl_cmbf's cvr ORDER_CALIBRATE_LOSS
    # against its relation tower ctr
    calibrated = name == 'dbmtl_cmbf'
    assert len(loss) == (4 if calibrated else 3), sorted(loss)
    assert ('order_calibrate_loss_ctr_cvr' in loss) == calibrated
  if name == 'aitm_backbone':
    # the two cross entropies: cvr's ORDER_CALIBRATE_LOSS compares it
    # with its relation towers, and it names none
    assert sorted(loss) == ['classification_loss_ctr',
                            'classification_loss_cvr', 'total_loss']
  # the AuxiliaryLoss samples add aux_loss to the total
  assert ('aux_loss' in loss) == (name in ('cl4srec_backbone',
                                           'contrastive_backbone'))
  if model == 'rocket_launching':
    # light and booster cross entropies and the hint; no light hidden
    # layer of the samples has its booster partner's width, so none
    # distills features
    assert sorted(loss) == ['booster_ce', 'hint_loss', 'light_ce',
                            'total_loss']
  if name == 'deepfm_multi_loss':
    assert sorted(loss) == ['BINARY_FOCAL_LOSS', 'CLASSIFICATION',
                            'total_loss']
    assert tuple(trainer.model.loss_uncertainty.shape) == (2,)
  ema = trainer.dense_opt.named_ema()
  assert (ema is not None) == (name == 'deepfm_ema')
  if ema is not None:
    decay = trainer.dense_opt.ema_decay
    for k, p in trainer.model.named_parameters():
      assert torch.equal(ema[k], decay * before[k] + (1.0 - decay) * p), k


def _csv_to_tfrecord(path, fields):
  """The generator's CSV as tf.Example records (the JAX package's writer,
  floats as float_list, strings as bytes_list), as tests/test_samples.py
  converts it."""
  from easyrec_tpu.data import tfrecord
  kinds = [(f.input_name, f.input_type) for f in fields]
  with open(path) as f:
    rows = [{name: float(v) if kind == 'FLOAT' else v
             for (name, kind), v in zip(kinds, line.rstrip('\n').split(','))}
            for line in f]
  dst = path[:-len('.csv')] + '.tfrecord'
  tfrecord.write_records(dst, (tfrecord.columns_to_example(r)
                               for r in rows))
  return dst


def test_gzip_csv_reads_as_the_csv(tmp_path):
  """A gzip copy of the CLI fixture's CSV, written as tests/
  test_samples.py writes one, gives the same batches as the CSV, shuffled
  and across two epochs."""
  path = fixtures.write_pipeline(tmp_path)
  cfg = t_config.get_configs_from_pipeline_file(path)
  src = t_config.get_train_input_path(cfg)
  with open(src, 'rb') as f, gzip.open(src + '.gz', 'wb') as g:
    shutil.copyfileobj(f, g)
  pipes = [iter(t_input.InputPipeline(
      cfg.data_config, t_config.get_feature_configs(cfg), p, batch_size=256))
           for p in (src, src + '.gz')]
  for _ in range(20):
    a, b = next(pipes[0]), next(pipes[1])
    assert sorted(a) == sorted(b)
    for k in a:
      np.testing.assert_array_equal(a[k], b[k], err_msg=k)
