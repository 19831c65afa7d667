"""Training of backbone models against the JAX package on the CPU: three
steps through both Trainers of dlrm_backbone (unfused and fused), of the
multi-task aitm_backbone and of contrastive_backbone, whose AuxiliaryLoss
adds `aux_loss` (its input dropout set to 0, the one random part); the
full-width backbone DLRM of flagship.py (its layout and widths, and three
steps at a narrow width); and a fine-tune restore of a JAX dlrm_backbone
state into the port by restore_filters names.

Tolerances: tests/test_torch_rank_zoo_train.py's with BatchNorm, as
tests/test_torch_criteo_dlrm.py holds the DLRM: each loss term (aux_loss
among them) relative 2e-5, a Dense bias before a BatchNorm within 2 lr a
step, the other dense parameters 1e-4, table weights 1e-4 and the bf16
moments 3% or 2e-7. AITM's `v` bias takes the BatchNorm allowance too: the
attention weights sum to one, so it adds one vector to every row of the
AITM output, which the cvr tower's Dense and BatchNorm cancel; its
gradient is rounding noise on both sides."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.config import text_format as t_text
from easyrec_torch.features import feature_spec as t_fs
from easyrec_torch.models import base as t_base
from easyrec_torch.train import checkpoints as t_ckpt
from easyrec_torch.train import restore as t_restore
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_torch.utils import flagship as t_flagship
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.train import restore as j_restore
from easyrec_tpu.train.trainer import Trainer as JTrainer
from easyrec_tpu.utils.synthetic import synthetic_batch
from tests.test_torch_rank_zoo_train import _check_params, _check_tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sample_text(name, **edits):
  with open(os.path.join(REPO, 'samples', name + '.config')) as f:
    text = f.read()
  for old, new in edits.items():
    assert old in text, old
    text = text.replace(old, new)
  return text


def _run_both(text, labels, n_steps=3, batch_size=64):
  """Both Trainers from the JAX one's initial state, on the same batches
  (a few padded rows in the second): every loss term of every step."""
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  jt = JTrainer(j_cfg, devices=jax.devices('cpu')[:1])
  assert jt.packed_mode and jt._packed_compact
  tt = TTrainer(t_cfg, device='cpu')
  batches = [synthetic_batch(jt.specs, labels, batch_size, seed=s)
             for s in range(n_steps)]
  batches[1]['sample_weight'][-5:] = 0.0
  state = jt.init_state(batches[0])
  tt.init_state()
  tt.model.load_state_dict(convert.flax_to_state_dict(
      state.params, state.batch_stats, root=tt.model.flax_root))
  for key, meta in jt.pack_metas.items():
    tt.tables[key].copy_(torch.from_numpy(convert.jax_packed_to_table(
        np.asarray(state.tables[key]), meta.dim, tt.metas[key].rows,
        meta.n_parts)))
  for s in range(n_steps):
    state, j_loss = jt.train_step(state, jt.rules.shard_batch(batches[s]))
    t_loss = tt.train_step(to_device(batches[s], torch.device('cpu')))
    assert sorted(t_loss) == sorted(k for k in j_loss
                                    if not k.startswith('exchange_'))
    for k, v in t_loss.items():
      np.testing.assert_allclose(float(v), float(j_loss[k]), rtol=2e-5,
                                 atol=1e-7, err_msg=k)
  return jt, tt, state, t_loss


def _lr_sum(tt, n=3):
  return sum(float(tt.dense_pair.schedule(torch.tensor(s)))
             for s in range(n))


@pytest.mark.parametrize('name,labels,fused,edits', [
    ('dlrm_backbone', ['label'], '0', {}),
    ('dlrm_backbone', ['label'], '1', {}),
    ('aitm_backbone', ['label', 'buy'], '0', {}),
    ('contrastive_backbone', ['label'], '0',
     {'input_layer { dropout_rate: 0.1 }': 'input_layer {}'}),
], ids=['dlrm_backbone', 'dlrm_backbone_fused', 'aitm_backbone',
        'contrastive_backbone'])
def test_three_steps_match_jax_trainer(name, labels, fused, edits,
                                       monkeypatch):
  """A backbone sample through both Trainers, K1 + K2 (or K3) by their
  plain versions, from one state and the same batches: every loss term
  (the contrastive sample's aux_loss, the InfoNCE of its two item-tower
  calls, among them), the dense parameters and the table rows."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', fused)
  jt, tt, state, loss = _run_both(_sample_text(name, **edits), labels)
  if name == 'contrastive_backbone':
    assert float(loss['aux_loss']) > 0.0
  _check_params(tt, state, True, _lr_sum(tt), cancelled=_aitm_v_bias)
  _check_tables(jt, tt, state, 1e-4)


def _aitm_v_bias(path):
  keys = [getattr(k, 'key', None) for k in path]
  return keys[-2:] == ['v', 'bias'] and str(keys[-3]).endswith('aitm_l0')


def test_criteo_dlrm_backbone_config_widths():
  """flagship.criteo_dlrm_backbone_config is samples/dlrm_backbone.config's
  backbone on criteo_dlrm_config's groups, schema and settings: at full
  width one table of 26,000,014 rows at dim 16 with 39 id slots an
  example, the bottom MLP over the 13 embedded raw features (208 wide),
  27 fields into the dot interaction (351 pairs) and top_mlp over the 416
  sparse columns and the pairs."""
  cfg = t_flagship.criteo_dlrm_backbone_config()
  dlrm = t_flagship.criteo_dlrm_config()
  sample = t_config.get_configs_from_pipeline_file(
      os.path.join(REPO, 'samples', 'dlrm_backbone.config'))
  assert t_text.to_text(cfg.model_config.backbone) == \
      t_text.to_text(sample.model_config.backbone)
  for part in ('data_config', 'train_config', 'feature_config'):
    assert t_text.to_text(getattr(cfg, part)) == \
        t_text.to_text(getattr(dlrm, part))
  assert t_text.to_text(cfg.model_config.feature_groups[0]) == \
      t_text.to_text(dlrm.model_config.feature_groups[0])
  specs = t_fs.build_feature_specs(t_config.get_feature_configs(cfg))
  ctx = t_base.build_context(cfg, specs)
  assert {k: (t.rows, t.dim, t.tot_k) for k, t in
          ctx.layout.tables.items()} == {'emb16': (26000014, 16, 39)}
  model = t_base.create_model(ctx)
  main = model.backbone.main
  assert main.bottom_mlp_l0.dense_0.in_features == 13 * 16
  assert model.backbone.top_mlp.dense_0.in_features == 26 * 16 + 27 * 26 // 2
  assert model.logits.in_features == 64


def test_small_criteo_dlrm_backbone_three_steps_match_jax_trainer(
    monkeypatch):
  """criteo_dlrm_backbone_config at a narrow width (3 raw and 6 id
  features of 1,000 buckets, batch 64; dim 16, the bottom MLP's output,
  which the dot interaction stacks with the features), written out by the
  port's text writer and read by the JAX package: three steps."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', '0')
  cfg = t_flagship.criteo_dlrm_backbone_config(
      batch_size=64, hash_bucket_size=1000, num_dense=3, num_cat=6)
  jt, tt, state, _ = _run_both(t_text.to_text(cfg), ['label'])
  _check_params(tt, state, True, _lr_sum(tt))
  _check_tables(jt, tt, state, 1e-4)


def test_fine_tune_restores_a_jax_dlrm_backbone_by_names(tmp_path,
                                                         monkeypatch):
  """A JAX dlrm_backbone state (its Trainer's initial state at seed 2025),
  held in a port checkpoint through convert.py, warm-starts a seed-99
  port Trainer with restore_filters on the backbone's names: flax_names
  gives every variable the JAX package's own name (restore._flatten's),
  the filtered ones (top_mlp, bottom_mlp's BatchNorms) stay fresh, and
  every other one, the logits and the table's weights take the JAX
  state's values."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '0')
  text = _sample_text('dlrm_backbone')
  jt = JTrainer(j_config.get_configs_from_pipeline_str(text),
                devices=jax.devices('cpu')[:1])
  batch = synthetic_batch(jt.specs, ['label'], 64, seed=0)
  src = jax.tree_util.tree_map(np.asarray, jt.init_state(batch))
  tt = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  tt.init_state()
  tt.model.load_state_dict(convert.flax_to_state_dict(src.params,
                                                      src.batch_stats))
  for key, table in tt.tables.items():
    table[:, :tt.metas[key].dim] = torch.from_numpy(
        np.array(src.tables[key][:table.shape[0]]))
  names = convert.flax_names(tt.model.state_dict())
  j_names = {('params', n) for n in j_restore._flatten(src.params)} | \
      {('batch_stats', n) for n in j_restore._flatten(src.batch_stats)}
  assert set(names.values()) == j_names
  ckpt = str(tmp_path / 'src')
  t_ckpt.CheckpointManager(ckpt, layout_stamp=tt.layout_stamp()).save(
      tt.state_dict(), 1)

  dst = TTrainer(t_config.get_configs_from_pipeline_str(
      text.replace('num_steps: 10000', 'num_steps: 10000 random_seed: 99')),
      device='cpu')
  dst.init_state()
  fresh = {k: v.clone() for k, v in dst.model.state_dict().items()}
  filters = ['^inner/backbone/top_mlp/', 'bottom_mlp_l0/bn_']
  counts = t_restore.fine_tune_restore(dst, ckpt, restore_filters=filters)
  got = dst.model.state_dict()
  kept = [k for k, (_, n) in names.items()
          if n.startswith('inner/backbone/top_mlp/') or
          'bottom_mlp_l0/bn_' in n]
  assert 'backbone.top_mlp.dense_2.weight' in kept
  assert 'backbone.main.bottom_mlp_l0.bn_1.running_var' in kept
  for k, (section, name) in names.items():
    tree = src.params if section == 'params' else src.batch_stats
    want = functools.reduce(lambda t, p: t[p], name.split('/'), tree)
    if k in kept:
      assert torch.equal(got[k], fresh[k]), k
    else:
      np.testing.assert_array_equal(
          _leaf(convert.state_dict_to_flax({k: got[k]}), section, name),
          np.asarray(want), err_msg=k)
  assert counts['params'] + counts['batch_stats'] == len(names) - len(kept)
  assert counts['tables'] == 1
  for key, table in dst.tables.items():
    np.testing.assert_array_equal(
        table[:, :dst.metas[key].dim].numpy(),
        np.asarray(src.tables[key])[:table.shape[0]])


def _leaf(trees, section, name):
  tree = trees[0] if section == 'params' else trees[1]
  return functools.reduce(lambda t, p: t[p], name.split('/'), tree)
