"""The multi-task family's training against the JAX package on the CPU:
the full-width Taobao MMoE's config and layout, three train steps and the
per-task evaluate of MMoE, ESMM and PLE against the JAX Trainer, and a
fine-tune restore by the multi-task models' names (the models' configs
are tests/test_torch_multi_task.py's)."""

import functools

import jax
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.features import feature_spec as t_fs
from easyrec_torch.models import base as t_base
from easyrec_torch.ops import embedding as t_emb
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.train import restore as t_restore
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_torch.utils import flagship as t_flagship
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.features import feature_spec as j_fs
from easyrec_tpu.models import base as j_base
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.train.trainer import Trainer as JTrainer
from easyrec_tpu.utils import flagship as j_flagship
from easyrec_tpu.utils.synthetic import synthetic_batch
from tests.test_torch_config import _assert_same
from tests.test_torch_multi_task import LABELS, _configs, _text, _torch


def test_taobao_mmoe_layout_and_width_match_jax():
  """The full-width Taobao MMoE: the port's copy of the JAX config, one
  [620,321, 16] logical table (the DIN's schema with final_gender_code in
  the group too), 116 id slots an example, and a 288-wide group input."""
  t_cfg = t_flagship.taobao_mmoe_config()
  j_cfg = j_flagship.taobao_mmoe_config(model_dir='')
  _assert_same(t_cfg, j_cfg, 'taobao_mmoe')
  t_specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  j_specs = j_fs.build_feature_specs(j_config.get_feature_configs(j_cfg))
  t_ctx = t_base.build_context(t_cfg, t_specs)
  j_ctx = j_base.build_context(j_cfg, j_specs)
  for key, j in j_ctx.layout.tables.items():
    t = t_ctx.layout.tables[key]
    assert (t.rows, t.dim, t.offsets) == (j.rows, j.dim, j.offsets)
  assert t_ctx.layout.tables['emb16'].rows == 620321
  assert t_ctx.layout.tables['emb16'].tot_k == 116
  model = t_base.create_model(t_ctx)
  assert tuple(model.mmoe.experts.w_0.shape) == (4, 288, 256)
  assert [t.tower_name for t in model.towers] == ['ctr', 'cvr']
  assert t_cfg.data_config.batch_size == 4096
  assert t_cfg.model_config.mmoe.l2_regularization == \
      j_cfg.model_config.mmoe.l2_regularization


# ------------------------------------------------ three train steps


LR_SUM = 0.01 + 0.01 + 0.005      # the schedule's rates of the 3 steps
MAX_APART_ROWS = 9                # rows whose bf16 moments part (PLE's)


@pytest.mark.parametrize('model,fused', [('mmoe', '0'), ('esmm', '1'),
                                         ('ple', '0')])
def test_three_steps_and_evaluate_match_jax_trainer(model, fused,
                                                    monkeypatch):
  """The port's Trainer, K1 + K2 (or K3) by their plain versions, against
  the JAX Trainer with packed compact tables and f32 gradient sums, from
  one state and the same batches, without BatchNorm; the tolerances of
  tests/test_torch_din.py::test_three_steps_match_jax_trainer, for the
  same reasons: losses relative 2e-5, dense parameters 5e-6, table rows
  1e-5 (w) and a bf16 ulp or 1e-9 (m, v), rows no batch pulled bit-equal.
  Where a stored bf16 moment rounds the other way on the two sides, that
  row's weights are held to LR_SUM * 2^-7 instead; at most
  MAX_APART_ROWS = 9 rows may (the count PLE shows; MMoE and ESMM 3).
  Then evaluate on 768 rows: loss relative 2e-5, the first task's `auc`
  and every `auc_<task>` (ESMM: its clicked-space cvr AUC and
  `auc_ctcvr`) within 1e-4 (a probability a hair from an edge of the
  8192-bin histogram may land one bin over)."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', fused)
  t_cfg, j_cfg = _configs(model, bn=False)
  jt = JTrainer(j_cfg, devices=jax.devices('cpu')[:1])
  assert jt.packed_mode and jt._packed_compact
  tt = TTrainer(t_cfg, device='cpu')
  batches = [synthetic_batch(jt.specs, LABELS, 64, seed=s)
             for s in range(3)]
  batches[1]['sample_weight'][-7:] = 0.0
  state = jt.init_state(batches[0])
  tt.init_state()
  tt.model.load_state_dict(convert.flax_to_state_dict(
      state.params, state.batch_stats, root=''))
  for key, meta in jt.pack_metas.items():
    tt.tables[key].copy_(torch.from_numpy(convert.jax_packed_to_table(
        np.asarray(state.tables[key]), meta.dim, tt.metas[key].rows,
        meta.n_parts)))
  cpu = torch.device('cpu')
  for s in range(3):
    state, j_loss = jt.train_step(state, jt.rules.shard_batch(batches[s]))
    t_loss = tt.train_step(to_device(batches[s], cpu))
    assert sorted(t_loss) == sorted(k for k in j_loss
                                    if not k.startswith('exchange_'))
    np.testing.assert_allclose(float(t_loss['total_loss']),
                               float(j_loss['total_loss']), rtol=2e-5)
  assert int(tt.step) == int(state.step) == 3

  params, _ = convert.state_dict_to_flax(tt.model.state_dict(), root='')
  j_params = jax.device_get(state.params)
  leaves = jax.tree_util.tree_leaves_with_path(params)
  assert len(leaves) == len(jax.tree_util.tree_leaves(j_params))
  for path, got in leaves:
    want = np.asarray(functools.reduce(lambda t, k: t[k.key], path,
                                       j_params))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6,
                               err_msg=jax.tree_util.keystr(path))
  for key, meta in jt.pack_metas.items():
    rows = tt.metas[key].rows
    seen = np.zeros(rows, bool)
    for b in batches:
      seen[t_emb.pack_ids(tt.layout, _torch(b))[key].numpy().ravel()] = True
    jw, (jm, jv) = jpt.unpack_host(np.asarray(state.tables[key]), meta,
                                   rows)
    tw, (tm, tv) = tpt.unpack_host(tt.tables[key].numpy(), tt.metas[key])
    for got, want in ((tm, jm), (tv, jv)):
      np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-9)
    # where a stored bf16 moment rounded the other way on one side, the
    # next step's lr * m / sqrt(v) differs by up to a bf16 ulp (2^-7) of
    # itself; every other weight within 1e-5. Such rows are few: 3 for
    # MMoE and ESMM, 9 for PLE, of about 2,000 (each one weight)
    apart = (tm != jm) | (tv != jv)
    assert apart.any(axis=1).sum() <= MAX_APART_ROWS
    np.testing.assert_allclose(tw[~apart], jw[~apart], rtol=0, atol=1e-5)
    assert np.abs(tw - jw)[apart].max(initial=0.0) <= LR_SUM * 2.0 ** -7
    assert 0 < (~seen).sum() < rows
    for got, want in ((tw, jw), (tm, jm), (tv, jv)):
      np.testing.assert_array_equal(got[~seen].view(np.uint32),
                                    want[~seen].view(np.uint32))

  evals = [synthetic_batch(jt.specs, LABELS, 256, seed=10 + s)
           for s in range(3)]
  j_eval = jt.evaluate(state, eval_iter=evals)
  j_eval.pop('exchange_overflow_rate')      # the JAX package's sharded pull
  t_eval = tt.evaluate(eval_iter=evals)
  tasks = ['auc_click', 'auc_conv', 'auc_ctcvr'] if model == 'esmm' else \
      ['auc_ctr', 'auc_cvr']
  assert sorted(t_eval) == sorted(j_eval) == sorted(['auc', 'loss'] + tasks)
  for k in ['auc'] + tasks:
    np.testing.assert_allclose(t_eval[k], j_eval[k], atol=1e-4, err_msg=k)
  np.testing.assert_allclose(t_eval['loss'], j_eval['loss'], rtol=2e-5)
  assert t_eval['auc'] == t_eval[tasks[0]]


def test_fine_tune_restore_by_multi_task_names(tmp_path):
  """An MMoE checkpoint warm-starts another seed's MMoE by the JAX
  package's names, which for a multi-task model have no 'inner' root:
  restore_filters on 'mmoe/gate_' and 'cvr_logits' keep those fresh,
  every other variable and the table's weights come from the checkpoint."""
  text = _text('mmoe', model_dir=str(tmp_path / 'src'))
  src = TTrainer(t_config.get_configs_from_pipeline_str(text), device='cpu')
  src.fit(num_steps=1, eval_at_end=False)
  dst = TTrainer(t_config.get_configs_from_pipeline_str(
      text.replace('num_steps: 3', 'num_steps: 3 random_seed: 99')),
      device='cpu')
  dst.init_state()
  fresh = {k: v.clone() for k, v in dst.model.state_dict().items()}
  counts = t_restore.fine_tune_restore(
      dst, str(tmp_path / 'src'), restore_filters=['^mmoe/gate_',
                                                   'cvr_logits'])
  names = convert.flax_names(fresh, '')
  assert names['mmoe.experts.w_0'] == ('params', 'mmoe/experts/w_0')
  kept = [k for k, (_, n) in names.items()
          if n.startswith('mmoe/gate_') or 'cvr_logits' in n]
  assert sorted(kept) == ['cvr_logits.bias', 'cvr_logits.weight',
                          'mmoe.gate_0.bias', 'mmoe.gate_0.weight',
                          'mmoe.gate_1.bias', 'mmoe.gate_1.weight']
  got = dst.model.state_dict()
  want = src.model.state_dict()
  for k in names:
    assert torch.equal(got[k], fresh[k] if k in kept else want[k]), k
  assert counts == {'params': len([n for n in names.values()
                                   if n[0] == 'params']) - len(kept),
                    'batch_stats': len([n for n in names.values()
                                        if n[0] == 'batch_stats']),
                    'tables': 1}
  for key, meta in dst.metas.items():
    assert torch.equal(dst.tables[key][:, :meta.dim],
                       src.tables[key][:, :meta.dim])
