"""TFRecord input of the port (easyrec_torch/data/tfrecord.py and the
TFRecordInput reader of data/input_pipeline.py) against the JAX package:
files its writer writes read back record by record and column by column,
and samples/deepfm_tfrecord.config's batches equal the JAX reader's, plain
and gzip, train and eval."""

import gzip
import os
import shutil

import numpy as np
import pytest

from easyrec_torch.config import config_util as t_config
from easyrec_torch.data import input_pipeline as t_input
from easyrec_torch.data import tfrecord as t_tfr
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.data import input_pipeline as j_input
from easyrec_tpu.data import tfrecord as j_tfr
from tests.test_samples import _write_csv
from tests.test_torch_data import _assert_batches_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ['s', 'f', 'i', 'tags', 'vec', 'ids', 'empty_f', 'missing']
ROWS = [
    {'s': 'u1', 'f': 0.25, 'i': 7, 'tags': ['a', 'b', 'c'],
     'vec': [0.5, 1.5], 'ids': [3, 4, 5], 'empty_f': []},
    {'s': 'é中', 'f': -1e30, 'i': -(1 << 40), 'tags': ['z'], 'vec': [2.0],
     'ids': [1 << 62], 'empty_f': [0.0]},
    {'s': '', 'f': 3.0, 'i': 0, 'tags': [], 'vec': [], 'ids': [],
     'empty_f': []},
]


def _write(path, rows):
  return j_tfr.write_records(path, (j_tfr.columns_to_example(r)
                                    for r in rows))


def test_records_and_columns_read_as_jax_reads_them(tmp_path):
  """Payloads bit-equal with their CRCs checked, and every column (bytes
  joined by '|', one number as itself, several as a list, '' where the
  feature is missing or empty) as the JAX package's protobuf parse gives
  it; a gzip copy reads the same by its suffix."""
  path = str(tmp_path / 'd.tfrecord')
  assert _write(path, ROWS) == 3
  with open(path, 'rb') as src, gzip.open(path + '.gz', 'wb') as g:
    shutil.copyfileobj(src, g)
  want = list(j_tfr.read_records(path, verify_crc=True))
  for p in (path, path + '.gz'):
    got = list(t_tfr.read_records(p, verify_crc=True))
    assert got == want
  types = {n: 0 for n in FIELDS}
  j_cols = j_tfr.example_to_columns(want, FIELDS, types)
  t_cols = t_tfr.example_to_columns(want, FIELDS)
  assert t_cols == j_cols
  # the JAX writer stores an empty list as an empty int64_list
  assert t_cols['tags'] == ['a|b|c', 'z', []]
  assert t_cols['missing'] == ['', '', '']


def test_crc_and_writer_match_jax(tmp_path):
  """The port's CRC32-C equals the JAX package's; a file of the JAX
  writer passes the port's CRC check, and a corrupt payload fails it."""
  rng = np.random.default_rng(0)
  for n in (0, 1, 7, 100, 4099):
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    assert t_tfr._masked_crc(data) == j_tfr._masked_crc(data)
  a = str(tmp_path / 'a')
  _write(a, ROWS)
  assert len(list(t_tfr.read_records(a, verify_crc=True))) == len(ROWS)
  raw = bytearray(open(a, 'rb').read())
  raw[14] ^= 0xFF
  open(a, 'wb').write(bytes(raw))
  with pytest.raises(IOError):
    list(t_tfr.read_records(a, verify_crc=True))


def _tfrecord_sample(tmp_path, n_train=700, n_eval=300):
  """samples/deepfm_tfrecord.config on TFRecords made from its columns
  as tests/test_samples.py makes them (floats as float_list, strings as
  bytes_list)."""
  path = os.path.join(REPO, 'samples', 'deepfm_tfrecord.config')
  t_cfg = t_config.get_configs_from_pipeline_file(path)
  j_cfg = j_config.get_configs_from_pipeline_file(path)
  fields = [(f.input_name, f.input_type) for f in
            t_cfg.data_config.input_fields]
  out = []
  for tag, n, seed in (('train', n_train, 1), ('eval', n_eval, 2)):
    csv = str(tmp_path / ('%s.csv' % tag))
    _write_csv(csv, [name for name, _ in fields], n, seed)
    rows = []
    with open(csv) as f:
      for line in f:
        vals = line.rstrip('\n').split(',')
        rows.append({name: float(v) if kind == 'FLOAT' else v
                     for (name, kind), v in zip(fields, vals)})
    dst = str(tmp_path / ('%s.tfrecord' % tag))
    _write(dst, rows)
    out.append(dst)
  return t_cfg, j_cfg, out


@pytest.mark.parametrize('compress', [False, True])
def test_deepfm_tfrecord_batches_equal_jax(tmp_path, compress):
  """The sample's train input (shuffled, 2 epochs) and eval input (its
  last batch padded) through both InputPipelines: the same batches bit
  for bit; with GZIP files by data_compression_type."""
  t_cfg, j_cfg, (train, evalp) = _tfrecord_sample(tmp_path)
  assert t_cfg.data_config.input_type == 'TFRecordInput'
  if compress:
    for p in (train, evalp):
      with open(p, 'rb') as src, gzip.open(p + '.z', 'wb') as g:
        shutil.copyfileobj(src, g)
      os.replace(p + '.z', p)
    t_cfg.data_config.data_compression_type = 'GZIP'
    j_cfg.data_config.data_compression_type = 'GZIP'
  t_cfg.data_config.num_epochs = j_cfg.data_config.num_epochs = 2
  for mode, path, n in (('train', train, 12), ('eval', evalp, 4)):
    t_pipe = t_input.InputPipeline(
        t_cfg.data_config, t_config.get_feature_configs(t_cfg), path,
        mode=mode, batch_size=128)
    j_pipe = j_input.InputPipeline(
        j_cfg.data_config, j_config.get_feature_configs(j_cfg), path,
        mode=mode, batch_size=128)
    _assert_batches_equal(t_pipe, j_pipe, n)


def test_tfrecord_rows_shard_as_jax(tmp_path):
  """shard_num 3: each reader's rows (index across its files modulo 3) as
  the JAX reader's."""
  t_cfg, j_cfg, (train, _) = _tfrecord_sample(tmp_path, 200, 10)
  t_cfg.data_config.shuffle = j_cfg.data_config.shuffle = False
  for i in range(3):
    t_pipe = t_input.InputPipeline(
        t_cfg.data_config, t_config.get_feature_configs(t_cfg), train,
        mode='eval', batch_size=32, shard_index=i, shard_num=3)
    j_pipe = j_input.InputPipeline(
        j_cfg.data_config, j_config.get_feature_configs(j_cfg), train,
        mode='eval', batch_size=32, shard_index=i, shard_num=3)
    _assert_batches_equal(t_pipe, j_pipe, 4)


def test_multi_value_numeric_field_is_refused(tmp_path):
  """A FLOAT field with several values in a row (the JAX package's arrow
  list column) raises, naming the field."""
  t_cfg, _, _ = _tfrecord_sample(tmp_path, 10, 10)
  path = str(tmp_path / 'multi.tfrecord')
  _write(path, [{'label': 1.0, 'uid': 'a', 'iid': 'b', 'cate': 'c',
                 'age': [1.0, 2.0]}])
  pipe = t_input.InputPipeline(t_cfg.data_config,
                               t_config.get_feature_configs(t_cfg), path,
                               mode='eval', batch_size=4)
  with pytest.raises(NotImplementedError, match='age'):
    next(iter(pipe))
