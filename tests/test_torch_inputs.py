"""The port's file and warehouse readers on the CPU, against the JAX
package: RTP (its separators, a missing label, short feature lists, file
and row sharding), Criteo's binary layout (file and row sharding, and ids
of 0x80000000 and above, which the converter wraps to negative int32,
through IdFeature's hash and num_buckets schemes), and the Hive and ODPS
warehouse exports (the table's resolution, CSV exports, the errors). Every
batch equals the JAX InputPipeline's exactly on the same files, and the
port's criteo_convert writes the JAX tool's bytes."""

import glob
import gzip
import os

import numpy as np
import pytest

from easyrec_torch.config import config_util as t_config
from easyrec_torch.data import input_pipeline as t_ip
from easyrec_torch.tools import criteo_convert as t_convert
from easyrec_torch.utils import flagship as t_flagship
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.data import input_pipeline as j_ip
from easyrec_tpu.tools import criteo_convert as j_convert


def _both(text):
  return (j_config.get_configs_from_pipeline_str(text),
          t_config.get_configs_from_pipeline_str(text))


def _same_batches(jc, tc, path, mode='eval', shard=(0, 1), **kw):
  """Both packages' pipelines over `path`: every batch equal, key for key
  and dtype for dtype; returns the live row count."""
  jp = j_ip.InputPipeline(jc.data_config, j_config.get_feature_configs(jc),
                          path, mode=mode, shard_index=shard[0],
                          shard_num=shard[1], **kw)
  tp = t_ip.InputPipeline(tc.data_config, t_config.get_feature_configs(tc),
                          path, mode=mode, shard_index=shard[0],
                          shard_num=shard[1], **kw)
  jbs, tbs = list(jp), list(tp)
  assert len(tbs) == len(jbs)
  for i, (jb, tb) in enumerate(zip(jbs, tbs)):
    assert sorted(tb) == sorted(jb)
    for k in jb:
      np.testing.assert_array_equal(tb[k], jb[k], err_msg='%d %s' % (i, k))
      assert tb[k].dtype == jb[k].dtype, k
  return int(sum((b['sample_weight'] > 0).sum() for b in tbs))


RTP_CONFIG = """
data_config {
  batch_size: 16
  num_epochs: 1
  shuffle: false
  label_fields: "label"
  label_fields: "buy"
  input_fields { input_name: "label" input_type: FLOAT }
  input_fields { input_name: "buy" input_type: FLOAT }
  input_fields { input_name: "num" input_type: FLOAT }
  input_fields { input_name: "cat" input_type: STRING }
  input_fields { input_name: "tags" input_type: STRING }
  input_type: %s
  %s
}
feature_config {
  features { input_names: "num" feature_type: RawFeature }
  features { input_names: "cat" feature_type: IdFeature
             embedding_dim: 4 hash_bucket_size: 50 }
  features { input_names: "tags" feature_type: TagFeature separator: "|"
             embedding_dim: 4 hash_bucket_size: 30 }
}
model_config { model_class: "DeepFM" }
"""


def _write_rtp(path, n, rtp_sep, feat_sep, seed):
  rng = np.random.default_rng(seed)
  with open(path, 'w') as f:
    for i in range(n):
      feats = ['%.1f' % (i * 0.5), 'c%d' % rng.integers(0, 9),
               '|'.join('t%d' % t for t in rng.integers(0, 20, i % 3 + 1))]
      if i % 7 == 3:
        feats = feats[:1]                    # a short feature list
      labels = ['%d' % (i % 2), '%d' % (i % 3 == 0)]
      if i % 11 == 5:
        labels = labels[:1]                  # a missing label
      if i % 13 == 6:
        labels = []                          # no label at all
      f.write(rtp_sep.join(labels + [feat_sep.join(feats)]) + '\n')
      if i % 17 == 0:
        f.write('\n')                        # an empty line, skipped


@pytest.mark.parametrize('input_type,extra,rtp_sep,feat_sep,shard', [
    ('RTPInput', 'separator: "\\002"', ';', '\002', (0, 1)),
    ('RTPInputV2', 'separator: "\\002" rtp_separator: "#"', '#', '\002',
     (0, 1)),
    ('OdpsRTPInput', 'separator: ","', ';', ',', (1, 2)),
    ('OdpsRTPInputV2', 'separator: "\\002" file_shard: true', ';', '\002',
     (1, 2)),
], ids=['default', 'rtp_separator', 'row_shard', 'file_shard'])
def test_rtp_batches_equal_jax(tmp_path, input_type, extra, rtp_sep,
                               feat_sep, shard):
  for i in range(3):
    _write_rtp(str(tmp_path / ('part%d.rtp' % i)), 45 + 10 * i, rtp_sep,
               feat_sep, seed=i)
  jc, tc = _both(RTP_CONFIG % (input_type, extra))
  rows = _same_batches(jc, tc, str(tmp_path / '*.rtp'), shard=shard)
  assert rows > 16


def _criteo_text(path, c1, extra=''):
  fields = ['label'] + ['d%d' % i for i in range(1, 14)] + \
      ['c%d' % i for i in range(1, 27)]
  lines = '\n'.join('input_fields { input_name: "%s" input_type: %s }' %
                    (f, 'STRING' if f.startswith('c') else 'FLOAT')
                    for f in fields)
  return """
train_input_path: "%s"
data_config {
  batch_size: 32
  num_epochs: 1
  shuffle: false
  label_fields: "label"
  %s
  input_type: CriteoInput
  %s
}
feature_config {
  features { input_names: "d1" feature_type: RawFeature }
  features { input_names: "c1" feature_type: IdFeature embedding_dim: 4
             %s }
  features { input_names: "c26" feature_type: IdFeature embedding_dim: 4
             hash_bucket_size: 1000 }
}
model_config { model_class: "DeepFM" }
""" % (path, lines, extra, c1)


def _write_tsv(path, n, seed, blanks=True):
  """Criteo day TSV lines: label, 13 ints (some negative), 26 hex ids, a
  share of them 0x80000000 or above; blanks, short and long lines."""
  rng = np.random.default_rng(seed)
  opener = gzip.open if path.endswith('.gz') else open
  with opener(path, 'wt') as f:
    for i in range(n):
      dense = [str(v) for v in rng.integers(-2, 5000, 13)]
      ids = ['%08x' % v for v in rng.integers(0, 1 << 32, 26,
                                              dtype=np.uint64)]
      if blanks and i % 6 == 1:
        ids[3] = '%x' % rng.integers(0, 4096)   # an id of fewer digits
      if blanks:
        for j in rng.choice(39, 5, replace=False):
          if j < 13:
            dense[j] = ''
          else:
            ids[j - 13] = ''
      parts = [str(int(rng.random() < 0.3))] + dense + ids
      if blanks and i % 9 == 4:
        parts = parts[:20]                   # a short line
      if blanks and i % 10 == 7:
        parts = parts + ['7f']               # a field past the 40th
      f.write('\t'.join(parts) + '\n')


def test_criteo_convert_writes_the_jax_tools_bytes(tmp_path):
  src = tmp_path / 'src'
  src.mkdir()
  _write_tsv(str(src / 'day_0.tsv'), 300, seed=1)
  _write_tsv(str(src / 'day_1.gz'), 120, seed=2)
  outs = []
  for name, tool in (('jax', j_convert), ('port', t_convert)):
    tool.main(['--input_path', str(src / 'day_*'), '--output_dir',
               str(tmp_path / name)])
    outs.append({os.path.basename(p): open(p, 'rb').read()
                 for p in glob.glob(str(tmp_path / name / '*'))})
  assert sorted(outs[0]) == ['day_0.bin', 'day_1.bin']
  assert outs[1] == outs[0]
  recs = np.frombuffer(outs[1]['day_0.bin'], '<i4').reshape(-1, 40)
  assert len(recs) == 300 and (recs[:, 14:] < 0).any()
  # a chunk boundary inside the file changes nothing
  small = str(tmp_path / 'small.bin')
  assert t_convert.convert_file(str(src / 'day_0.tsv'), small,
                                chunk_rows=7) == 300
  assert open(small, 'rb').read() == outs[0]['day_0.bin']


@pytest.mark.parametrize('c1,extra,shard', [
    ('hash_bucket_size: 1000', '', (0, 1)),
    ('num_buckets: 50', '', (0, 1)),
    ('hash_bucket_size: 1000', '', (1, 3)),
    ('hash_bucket_size: 1000', 'file_shard: true', (1, 2)),
], ids=['hash', 'num_buckets', 'row_shard', 'file_shard'])
def test_criteo_binary_batches_equal_jax(tmp_path, c1, extra, shard):
  """Packed records, negative ids among them, through the whole
  pipeline: IdFeature hashes the int64 id's text (a wrapped id reads
  '-123...') and clips a num_buckets id into [0, n)."""
  for i in range(3):
    tsv = str(tmp_path / ('day_%d.tsv' % i))
    _write_tsv(tsv, 70 + 20 * i, seed=10 + i)
    t_convert.convert_file(tsv, str(tmp_path / ('day_%d.bin' % i)))
  path = str(tmp_path / '*.bin')
  jc, tc = _both(_criteo_text(path, c1, extra))
  assert _same_batches(jc, tc, path, shard=shard) > 0
  chunk = next(t_ip.create_reader(tc.data_config, path).chunks(1000))
  assert chunk['c1'].dtype == np.int64 and (chunk['c1'] < 0).any()
  assert chunk['label'].dtype == np.float32


def test_flagship_deepfm_reads_the_binary_layout_as_jax(tmp_path):
  """The flagship DeepFM's schema (13 raw, 26 hashed ids) as CriteoInput
  on converted files: its batches equal the JAX pipeline's."""
  tsv = str(tmp_path / 'day_0.tsv')
  _write_tsv(tsv, 300, seed=5)
  t_convert.convert_file(tsv, str(tmp_path / 'day_0.bin'))
  cfg = t_flagship.criteo_deepfm_config(batch_size=128,
                                        hash_bucket_size=1000)
  cfg.data_config.input_type = 'CriteoInput'
  cfg.data_config.shuffle = False
  cfg.data_config.num_epochs = 1
  from easyrec_torch.config.text_format import to_text
  jc, tc = _both(to_text(cfg))
  assert _same_batches(jc, tc, str(tmp_path / 'day_0.bin'),
                       mode='train') == 300


WAREHOUSE = """
train_input_path: "%s"
data_config {
  batch_size: 8
  num_epochs: 1
  shuffle: false
  label_fields: "label"
  input_fields { input_name: "label" input_type: FLOAT }
  input_fields { input_name: "cat" input_type: STRING }
  input_fields { input_name: "n" input_type: INT64 default_val: "3" }
  input_type: %s
}
feature_config {
  features { input_names: "cat" feature_type: IdFeature
             embedding_dim: 4 hash_bucket_size: 50 }
  features { input_names: "n" feature_type: IdFeature
             embedding_dim: 4 num_buckets: 10 }
}
model_config { model_class: "DeepFM" }
"""


def _export(root, table, n, gz=False):
  os.makedirs(os.path.join(root, table), exist_ok=True)
  lines = ''.join('%d,c%d,%s\n' % (i % 2, i % 5, '' if i % 4 == 0 else i % 9)
                  for i in range(n))
  path = os.path.join(root, table, 'part-0.csv' + ('.gz' if gz else ''))
  with (gzip.open(path, 'wt') if gz else open(path, 'w')) as f:
    f.write(lines)
  return path


@pytest.mark.parametrize('input_type', ['OdpsInputV2', 'HiveInput',
                                        'OdpsInput', 'OdpsInputV3',
                                        'HiveRTPInput'])
def test_warehouse_exports_read_as_jax(tmp_path, monkeypatch, input_type):
  """odps:// paths and a bare table name resolve under
  EASYREC_WAREHOUSE_EXPORT_DIR/<table>/, a direct path is read as it is,
  and a HiveConfig message names its table; the CSV rows equal the JAX
  package's batches."""
  root = str(tmp_path / 'exports')
  _export(root, 'mytable', 29)
  _export(root, 'gztable', 17, gz=True)
  monkeypatch.setenv('EASYREC_WAREHOUSE_EXPORT_DIR', root)
  for path, rows in (('odps://proj/tables/mytable', 29), ('gztable', 17),
                     (os.path.join(root, 'mytable', '*.csv'), 29)):
    jc, tc = _both(WAREHOUSE % (path, input_type))
    assert _same_batches(jc, tc, path) == rows
  text = (WAREHOUSE % ('x', input_type)).replace(
      'train_input_path: "x"',
      'hive_train_input { host: "h" username: "u" table_name: "mytable" }')
  jc, tc = _both(text)
  hive = t_config.get_train_input_path(tc)
  assert hive.type_name == 'HiveConfig' and hive.port == 10000
  jp = j_ip.InputPipeline(jc.data_config, j_config.get_feature_configs(jc),
                          j_config.get_train_input_path(jc), mode='eval')
  tp = t_ip.InputPipeline(tc.data_config, t_config.get_feature_configs(tc),
                          hive, mode='eval')
  for jb, tb in zip(jp, tp):
    for k in jb:
      np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_warehouse_errors_name_the_table_and_pyarrow(tmp_path, monkeypatch):
  """No export: both packages raise the same NotImplementedError. A
  Parquet export goes to the Parquet reader, as in the JAX package (which
  reads it through pyarrow): a file of the magic alone raises a
  ValueError in both (pyarrow's ArrowInvalid is one), the port's naming
  the file."""
  monkeypatch.delenv('EASYREC_WAREHOUSE_EXPORT_DIR', raising=False)
  path = 'odps://proj/tables/nothing'
  jc, tc = _both(WAREHOUSE % (path, 'OdpsInputV2'))
  msgs = []
  for ip, c, cu in ((j_ip, jc, j_config), (t_ip, tc, t_config)):
    pipe = ip.InputPipeline(c.data_config, cu.get_feature_configs(c), path,
                            mode='eval')
    with pytest.raises(NotImplementedError) as e:
      next(iter(pipe))
    msgs.append(str(e.value))
  assert msgs[1] == msgs[0] and '<dir>/nothing/' in msgs[1]
  root = tmp_path / 'exports'
  (root / 'pq').mkdir(parents=True)
  (root / 'pq' / 'part-0.parquet').write_bytes(b'PAR1')
  monkeypatch.setenv('EASYREC_WAREHOUSE_EXPORT_DIR', str(root))
  pipe = t_ip.InputPipeline(tc.data_config, t_config.get_feature_configs(tc),
                            'odps://proj/tables/pq', mode='eval')
  with pytest.raises(ValueError, match='part-0.parquet is not a Parquet'):
    next(iter(pipe))
  pipe = j_ip.InputPipeline(jc.data_config, j_config.get_feature_configs(jc),
                            'odps://proj/tables/pq', mode='eval')
  with pytest.raises(ValueError):
    next(iter(pipe))


@pytest.mark.parametrize('which,kind', [
    ('kafka_train_input { server: "s:1" topic: "t" partitions: [1, 0] '
     'offset: [3, 4] }', 'KafkaServer'),
    ('datahub_eval_input { akId: "a" akSecret: "b" region: "r" project: "p" '
     'topic: "t" offset_info: "{}" }', 'DatahubServer'),
    ('hive_train_input { host: "h" username: "u" table_name: "t" '
     'fetch_size: 9 }', 'HiveConfig'),
])
def test_input_path_returns_the_sources_message(which, kind):
  """get_train_input_path / get_eval_input_path give the oneof's message
  with the proto's defaults, as the JAX config_util does."""
  jc, tc = _both(which + '\nmodel_config { model_class: "DeepFM" }')
  getter = 'get_eval_input_path' if 'eval' in which else \
      'get_train_input_path'
  jm, tm = getattr(j_config, getter)(jc), getattr(t_config, getter)(tc)
  assert tm.type_name == kind
  for spec in t_config.schema.MESSAGES[kind]:
    got = getattr(tm, spec.name)
    want = getattr(jm, spec.name)
    assert (list(got) if spec.repeated else got) == \
        (list(want) if spec.repeated else want), spec.name
  t_config.check_ported(tc)
