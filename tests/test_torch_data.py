"""The port's host data path against the JAX package: string hashing
(easyrec_torch/ops/hashing.py), the IdFeature/RawFeature transforms and the
CSV and Dummy readers under InputPipeline. Both sides must yield the same
batches, bit for bit."""

import numpy as np

from easyrec_torch.config import config_util as t_config
from easyrec_torch.data import input_pipeline as t_input
from easyrec_torch.ops import hashing as t_hashing
from easyrec_torch.utils import flagship as t_flagship
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.data import input_pipeline as j_input
from easyrec_tpu.ops import hashing as j_hashing
from easyrec_tpu.utils import flagship as j_flagship
from tests import fixtures


def test_hash_buckets_match_10k_strings():
  rng = np.random.default_rng(0)
  alphabet = list('abcXYZ019_|,;é中\t ')
  strs = [''.join(rng.choice(alphabet, rng.integers(0, 24)))
          for _ in range(10000)]
  strs[:4] = ['', 'a', '0', 'id12345678']
  values = np.array(strs, dtype=object)
  for buckets in (1, 7, 1000, 1000000, 1 << 31):
    np.testing.assert_array_equal(t_hashing.hash_strings(values, buckets),
                                  j_hashing.hash_strings(values, buckets))


def _assert_batches_equal(t_pipe, j_pipe, n_batches):
  t_it, j_it = iter(t_pipe), iter(j_pipe)
  for _ in range(n_batches):
    t_b, j_b = next(t_it, None), next(j_it, None)
    assert (t_b is None) == (j_b is None)
    if t_b is None:
      return
    assert sorted(t_b) == sorted(j_b)
    for k in j_b:
      assert t_b[k].dtype == j_b[k].dtype, k
      np.testing.assert_array_equal(t_b[k], j_b[k], err_msg=k)


def test_csv_pipeline_batches_match(tmp_path):
  # 4096 + 1024 rows at batch 256, shuffled: one reader chunk per file on
  # both sides, so the same permutation seeds give the same batches; the
  # eval file's last batch is padded with sample_weight 0
  path = fixtures.write_pipeline(tmp_path, n_eval=1000)
  t_cfg = t_config.get_configs_from_pipeline_file(path)
  j_cfg = j_config.get_configs_from_pipeline_file(path)
  for mode, n in (('train', 20), ('eval', 4)):
    t_path = t_config.get_train_input_path(t_cfg) if mode == 'train' \
        else t_config.get_eval_input_path(t_cfg)
    t_pipe = t_input.InputPipeline(
        t_cfg.data_config, t_config.get_feature_configs(t_cfg), t_path,
        mode=mode, batch_size=256)
    j_pipe = j_input.InputPipeline(
        j_cfg.data_config, j_config.get_feature_configs(j_cfg), t_path,
        mode=mode, batch_size=256)
    _assert_batches_equal(t_pipe, j_pipe, n)


def test_dummy_pipeline_batches_match():
  """The flagship's DummyInput at a small batch: 13 raw + 26 id
  features."""
  t_cfg = t_flagship.criteo_deepfm_config(batch_size=64)
  j_cfg = j_flagship.criteo_deepfm_config(batch_size=64, model_dir='')
  t_pipe = t_input.InputPipeline(
      t_cfg.data_config, t_config.get_feature_configs(t_cfg), 'synthetic')
  j_pipe = j_input.InputPipeline(
      j_cfg.data_config, j_config.get_feature_configs(j_cfg), 'synthetic')
  _assert_batches_equal(t_pipe, j_pipe, 3)


def test_header_and_defaults(tmp_path):
  """with_header selects columns by name; empty cells take default_val;
  the last short batch is zero-padded with sample_weight 0."""
  csv = tmp_path / 'h.csv'
  csv.write_text('c,label,d\nx,1,0.5\n,0,\ny,1,2\n')
  text = '''
train_input_path: "%s"
data_config {
  batch_size: 2 label_fields: "label" with_header: true shuffle: false
  num_epochs: 1
  input_fields { input_name: "label" input_type: FLOAT }
  input_fields { input_name: "d" input_type: FLOAT default_val: "7" }
  input_fields { input_name: "c" input_type: STRING default_val: "z" }
}
feature_configs { input_names: "c" feature_type: IdFeature
                  embedding_dim: 4 hash_bucket_size: 100 }
feature_configs { input_names: "d" feature_type: RawFeature }
''' % csv
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  t_b = list(t_input.InputPipeline(
      t_cfg.data_config, t_config.get_feature_configs(t_cfg), str(csv)))
  j_b = list(j_input.InputPipeline(
      j_cfg.data_config, j_config.get_feature_configs(j_cfg), str(csv)))
  assert len(t_b) == len(j_b) == 2
  for a, b in zip(t_b, j_b):
    assert sorted(a) == sorted(b)
    for k in b:
      np.testing.assert_array_equal(a[k], b[k], err_msg=k)
  np.testing.assert_array_equal(t_b[0]['feat.d.dense'][:, 0], [0.5, 7.0])
  np.testing.assert_array_equal(t_b[1]['sample_weight'], [1.0, 0.0])
