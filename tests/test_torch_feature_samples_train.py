"""Training of the six samples of the remaining feature types, fg.json
and incremental saves (combo_cross, expr_feature, lookup_feature,
taobao_fg, deepfm_incr_save, ev_incr_save) against the JAX package on
the CPU: three steps of the port's Trainer and
the JAX Trainer from one state on the same batches of the JAX pipeline;
the incremental samples publish an update after every step on both sides,
whose ids must be equal and values within 1e-5, and the EV sample's
updates carry the rows that EV admits after a first sighting."""

import os

import jax
import numpy as np
import pytest
import torch

from easyrec_torch.config import config_util as t_config
from easyrec_torch.ops import embedding as t_emb
from easyrec_torch.train import incremental as t_incr
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_torch.utils import fg_util as t_fg
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.train import incremental as j_incr
from easyrec_tpu.train.trainer import Trainer as JTrainer
from easyrec_tpu.utils import fg_util as j_fg
from tests.test_torch_match import cut_config, jax_batches, write_data
from tests.test_torch_match_train import _carry_state
from tests.test_torch_rank_extra import LR_SUM
from tests.test_torch_rank_extra_train import _check_tables
from tests.test_torch_rank_zoo_train import _check_params
from tests.test_torch_samples import _write_fg_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = ['combo_cross', 'expr_feature', 'lookup_feature', 'taobao_fg',
           'deepfm_incr_save', 'ev_incr_save']


def _configs(name, data_dir):
  """(port config, JAX config) of samples/<name>.config, the fg.json's
  fields and features loaded where it names one, cut as the match
  family's tests cut theirs (hash buckets at most 1,000, batch 32), on
  data of its columns."""
  path = os.path.join(REPO, 'samples', name + '.config')
  t_cfg = t_config.get_configs_from_pipeline_file(path)
  j_cfg = j_config.get_configs_from_pipeline_file(path)
  if t_cfg.fg_json_path:
    for cfg, fg in ((t_cfg, t_fg), (j_cfg, j_fg)):
      cfg.fg_json_path = os.path.join(REPO, cfg.fg_json_path)
      fg.load_fg_json_to_config(cfg)
  t_cfg, j_cfg = cut_config(t_cfg, data_dir), cut_config(j_cfg, data_dir)
  cols = [f.input_name for f in j_cfg.data_config.input_fields]
  if t_cfg.fg_json_path:
    _write_fg_csv(os.path.join(data_dir, 'train.csv'),
                  t_cfg.data_config.input_fields, 256, seed=11)
  else:
    write_data(data_dir, cols)
  return t_cfg, j_cfg


def _update(path_or_none):
  return t_incr.read_update(path_or_none) if path_or_none else None


@pytest.mark.parametrize('name', SAMPLES)
def test_three_steps_match_jax_trainer(name, tmp_path, monkeypatch):
  """The port's Trainer (K1 + K2 by their plain versions) against the JAX
  Trainer (packed compact tables, f32 gradient sums) from one state on
  three batches of the JAX pipeline: each loss term within 2e-5 relative,
  the dense parameters at tests/test_torch_rank_zoo_train.py's rule with
  BatchNorm, every table weight within 1e-5 and the bf16 moments within a
  bf16 ulp of their row's largest. With incr_save_config both sides'
  publishers take the initial state and publish after each step: the
  same sparse ids, values and dense deltas within 1e-5."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', '0')
  t_cfg, j_cfg = _configs(name, str(tmp_path))
  batches = jax_batches(j_cfg, 3)
  batches[1]['sample_weight'][-5:] = 0.0
  jt = JTrainer(j_cfg, devices=jax.devices('cpu')[:1])
  tt = TTrainer(t_cfg, device='cpu')
  state = jt.init_state(batches[0])
  _carry_state(jt, state, tt)
  incr = t_cfg.train_config.HasField('incr_save_config')
  if incr:
    j_pub = j_incr.IncrementalPublisher(
        j_cfg.train_config.incr_save_config, str(tmp_path / 'jax'),
        pack_metas=jt.pack_metas)
    t_pub = t_incr.IncrementalPublisher(
        t_cfg.train_config.incr_save_config, str(tmp_path / 'port'))
    assert j_pub.publish(state, 0) is None and t_pub.publish(tt, 0) is None
  touched, updates = [], []
  for step, b in enumerate(batches, 1):
    state, j_loss = jt.train_step(state, jt.rules.shard_batch(b))
    tb = to_device(b, torch.device('cpu'))
    t_loss = tt.train_step(tb)
    assert sorted(t_loss) == sorted(k for k in j_loss
                                    if not k.startswith('exchange_'))
    for k, v in t_loss.items():
      np.testing.assert_allclose(float(v), float(j_loss[k]), rtol=2e-5,
                                 atol=1e-7, err_msg=k)
    if incr:
      want = _update(j_pub.publish(state, step))
      got = _update(t_pub.publish(tt, step))
      assert sorted(k for k in got if k.startswith('sparse')) == \
          sorted(k for k in want if k.startswith('sparse'))
      for key in tt.metas:
        np.testing.assert_array_equal(got['sparse_ids/' + key],
                                      want['sparse_ids/' + key])
        np.testing.assert_allclose(got['sparse_vals/' + key],
                                   want['sparse_vals/' + key], rtol=0,
                                   atol=1e-5)
      j_dense = sorted(k for k in want if k.startswith('dense/'))
      assert sorted(k for k in got if k.startswith('dense/')) == j_dense
      updates.append(got)
      touched.append({key: np.unique(p.numpy()) for key, p in
                      t_emb.pack_ids(tt.layout, tb).items()})
  _check_params(tt, state, True, LR_SUM)
  _check_tables(jt, tt, state)
  if name == 'ev_incr_save':
    # a row EV keeps out at its first sighting does not change; admitted
    # at a later one, it trains and travels in that step's update
    late = 0
    for key in tt.metas:
      first = set(touched[0][key]) - set(updates[0]['sparse_ids/' + key])
      later = set(np.concatenate([u['sparse_ids/' + key]
                                  for u in updates[1:]]))
      late += len(first & later)
    assert late > 0
  if name == 'deepfm_incr_save':
    for u, t in zip(updates, touched):
      for key in tt.metas:
        np.testing.assert_array_equal(u['sparse_ids/' + key], t[key])
