"""Every samples/*.config through the port's config reader against the JAX
package's protobuf parse: each field the JAX side sets is read by the port
with the same value, or listed in the port's schema as unported (so
check_ported names it), or on IGNORED below, fields that change nothing the
port computes. The samples that pass check_ported are counted and named,
each trains a step on the CPU (the gzip CSV sample through its gzip
reader), and a gzip copy of a CSV reads as the CSV does."""

import glob
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from easyrec_torch.config import config_util as t_config
from easyrec_torch.config import schema
from easyrec_torch.data import input_pipeline as t_input
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_tpu.config import config_util as j_config
from tests import fixtures
from tests.test_samples import MM_COLS, STANDARD_COLS, _write_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = sorted(glob.glob(os.path.join(REPO, 'samples', '*.config')))

# Fields a sample sets that the port's schema does not hold, each with why
# it changes nothing the port computes.
IGNORED = {
    # the EMA's decay; use_moving_average, which would read it, raises in
    # the port's optimizer builder (optim/builder.py)
    'Optimizer.moving_average_decay',
}

# The samples check_ported accepts. Among those it rejects,
# dead_line_stop (train_config.dead_line), best_exporter_early_stop
# (export_config) and seq_text_cnn_combiner (sequence_combiner, which would
# otherwise fail by name at its first forward) set nothing else the port
# lacks.
PORTED = ['deepfm_adamw', 'deepfm_ema', 'deepfm_ev_params', 'deepfm_gzip_csv',
          'deepfm_momentumw', 'deepfm_with_embed', 'multi_opt_seq_din',
          'raw_boundaries']


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
  assert len(PORTED) == 8
  for name, what in (('dead_line_stop', 'dead_line'),
                     ('best_exporter_early_stop', 'export_config'),
                     ('seq_text_cnn_combiner', 'sequence_combiner')):
    cfg = t_config.get_configs_from_pipeline_file(
        os.path.join(REPO, 'samples', name + '.config'))
    with pytest.raises(NotImplementedError, match=what):
      t_config.check_ported(cfg)


@pytest.mark.parametrize('name', PORTED)
def test_ported_samples_train_a_step(name, tmp_path):
  """Each sample check_ported accepts, on data of its declared columns
  (tests/test_samples.py's generator), model_dir cleared: its train input
  (the gzip sample through gzip) feeds one step on the CPU; deepfm_ema
  stops at its optimizer, use_moving_average, by name."""
  cfg = t_config.get_configs_from_pipeline_file(
      os.path.join(REPO, 'samples', name + '.config'))
  cols = [f.input_name for f in cfg.data_config.input_fields]
  assert set(cols) <= set(STANDARD_COLS) | set(MM_COLS)
  train = str(tmp_path / 'train.csv')
  _write_csv(train, cols, 64, seed=11)
  if cfg.train_input_path.endswith('.gz'):
    with open(train, 'rb') as src, gzip.open(train + '.gz', 'wb') as g:
      shutil.copyfileobj(src, g)
    train += '.gz'
  cfg.train_input_path = cfg.eval_input_path = train
  cfg.model_dir = ''
  cfg.data_config.batch_size = 32
  if name == 'deepfm_ema':
    with pytest.raises(NotImplementedError, match='use_moving_average'):
      TTrainer(cfg, device='cpu')
    return
  trainer = TTrainer(cfg, device='cpu')
  trainer.init_state()
  batch = next(iter(trainer.train_input()))
  loss = trainer.train_step(to_device(batch, torch.device('cpu')))
  assert np.isfinite(float(loss['total_loss']))


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
