"""Training of the match family against the JAX package on the CPU: three
steps of the JAX Trainer (packed compact tables, f32 gradient sums) and
the port's Trainer from one state, on the same batches of the JAX
pipeline with a sampler's views, unfused (K1 + K2 by their plain
versions) and fused (K3): the losses, the dense weights, every table row
and, above all, the rows that only a sampled view touched, which move by
the view's gradient summed into the same update as the base batch's;
the embedding regulariser counts a view's rows whole and the base
batch's padded rows not at all. MIND runs with routing_logits_stddev 0
and DropoutNet with its dropout rates 0 (torch cannot draw flax's
numbers). The samples' own features, hash buckets cut to 1,000, batch
32 (tests/test_torch_match.py's configs)."""

import jax
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.ops import embedding as t_emb
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import to_device
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.train.trainer import Trainer as JTrainer
from tests.test_torch_match import _no_preference_dropout, jax_batches
from tests.test_torch_match import sample_configs
from tests.test_torch_rank_zoo_train import _check_params

LR_SUM = 3 * 0.001           # the samples' constant Adam rate, 3 steps


def _with_emb_reg(text):
  return text.replace('  loss_type: SOFTMAX_CROSS_ENTROPY',
                      '  loss_type: SOFTMAX_CROSS_ENTROPY\n'
                      '  embedding_regularization: 1e-4')


def _mind_stddev_0(text):
  return text.replace('num_iters: 3 }',
                      'num_iters: 3 routing_logits_stddev: 0.0 }')


def _iid_ev(text):
  """EV admission on iid: an item is admitted after 2 occurrences in the
  base batches; sampled negatives count none, and their slots of items
  not admitted are masked in the `neg.` view too."""
  return text.replace(
      'input_names: "iid" feature_type: IdFeature\n'
      '             embedding_dim: 16 hash_bucket_size: 1000000 }',
      'input_names: "iid" feature_type: IdFeature\n'
      '             embedding_dim: 16 hash_bucket_size: 1000000\n'
      '             ev_params { filter_freq: 2 } }')


# case -> (sample, its edit)
SAMPLES = {
    'dssm_neg_sampler': ('dssm_neg_sampler', _with_emb_reg),
    'dssm_neg_sampler_ev': ('dssm_neg_sampler', _iid_ev),
    'dssm_hard_neg_sampler': ('dssm_hard_neg_sampler', None),
    'dat': ('dat', None),
    'mind_neg_sampler': ('mind_neg_sampler', _mind_stddev_0),
    'dropoutnet': ('dropoutnet', _no_preference_dropout),
}


def _carry_state(jt, state, tt):
  tt.init_state()
  tt.model.load_state_dict(convert.flax_to_state_dict(
      state.params, state.batch_stats, root=tt.model.flax_root))
  for key, meta in jt.pack_metas.items():
    tt.tables[key].copy_(torch.from_numpy(convert.jax_packed_to_table(
        np.asarray(state.tables[key]), meta.dim, tt.metas[key].rows,
        meta.n_parts)))


def _view_only_rows(tt, batches):
  """{table: rows that a sampled view's features touched and the base
  batch's did not}, over the batches; a view's filler columns (id 0 for a
  feature it does not carry) are left out: their gradient is zero."""
  base, views = {}, {}
  for b in batches:
    for key, table in tt.layout.tables.items():
      for use in table.uses:
        for pfx, into in (('', base), ('neg.', views), ('hard_neg.', views)):
          ids = b.get('%sfeat.%s.ids' % (pfx, use.feature))
          if ids is not None:
            into.setdefault(key, set()).update(
                (np.asarray(ids, np.int64) + use.offset).reshape(-1)
                .tolist())
  return {k: sorted(views.get(k, set()) - base.get(k, set()))
          for k in base}


@pytest.mark.parametrize('fused', ['0', '1'])
@pytest.mark.parametrize('name', sorted(SAMPLES))
def test_three_steps_match_jax_trainer(name, fused, tmp_path, monkeypatch):
  """Each loss term within 2e-5 relative each step, the rule of
  tests/test_torch_rank_zoo_train.py (dssm_neg_sampler, an inner product
  at temperature 0.1 over 1,024 negatives from random towers, starts at
  a loss of 87, and its third step reads 1.3e-5 apart); the dense weights
  at that file's rule with BatchNorm (1e-4, a Dense bias before a
  BatchNorm within 2 lr a step); every table weight within 1e-5, the rows
  only a sampled view touched among them, which must have moved; the
  bf16 moments within a bf16 ulp of their row's largest (a moment summed
  from terms of that scale that cancel keeps their rounding)."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', fused)
  t_cfg, j_cfg = sample_configs(*SAMPLES[name][:1], str(tmp_path),
                                SAMPLES[name][1])
  batches = jax_batches(j_cfg, 3)
  batches[1]['sample_weight'][-5:] = 0.0        # padded rows
  jt = JTrainer(j_cfg, devices=jax.devices('cpu')[:1])
  assert jt.packed_mode and jt._packed_compact
  tt = TTrainer(t_cfg, device='cpu')
  state = jt.init_state(batches[0])
  _carry_state(jt, state, tt)
  before = {k: v.clone() for k, v in tt.tables.items()}
  # the eval of the shared state on two of the batches (after training,
  # a Dense bias before a BatchNorm has moved by Adam's noise on its zero
  # gradient, which shifts the running means eval subtracts): auc and
  # recall@5 (dssm_hard_neg_sampler's) within 1e-3, the loss 2e-5
  # relative
  j_eval = jt.evaluate(state, eval_iter=batches[:2])
  j_eval.pop('exchange_overflow_rate', None)
  t_eval = tt.evaluate(eval_iter=batches[:2])
  assert sorted(t_eval) == sorted(j_eval)
  for k, v in j_eval.items():
    np.testing.assert_allclose(t_eval[k], v, rtol=2e-5 if k == 'loss'
                               else 0, atol=0 if k == 'loss' else 1e-3,
                               err_msg=k)
  for b in batches:
    state, j_loss = jt.train_step(state, jt.rules.shard_batch(b))
    t_loss = tt.train_step(to_device(b, torch.device('cpu')))
    assert sorted(t_loss) == sorted(k for k in j_loss
                                    if not k.startswith('exchange_'))
    for k, v in t_loss.items():
      np.testing.assert_allclose(float(v), float(j_loss[k]), rtol=2e-5,
                                 atol=1e-7, err_msg=k)
  _check_params(tt, state, True, LR_SUM)
  only_views = _view_only_rows(tt, batches)
  moved = 0
  for key, meta in jt.pack_metas.items():
    rows = tt.metas[key].rows
    jw, (jm, jv) = jpt.unpack_host(np.asarray(state.tables[key]), meta,
                                   rows)
    tw, (tm, tv) = tpt.unpack_host(tt.tables[key].numpy(), tt.metas[key])
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-5, err_msg=key)
    for got, want in ((tm, jm), (tv, jv)):
      scale = np.abs(want).max(axis=1, keepdims=True)
      assert (np.abs(got - want) <= 2.0 ** -7 * scale + 1e-9).all(), key
    idx = only_views[key]
    if idx:
      step = np.abs(tw[idx] - before[key][idx, :meta.dim].numpy()).max(1)
      if name == 'mind_neg_sampler':
        # the JAX MIND reads no sampled view: its rows take a zero
        # gradient, and Adam from zero moments leaves them where they were
        assert not step.any(), key
      elif name == 'dssm_neg_sampler_ev':
        # an item only sampled is never admitted (the base batches alone
        # count): its slots are masked and its row keeps its weights
        assert not step.any(), key
      else:
        assert (step > 0).all(), key
        moved += len(idx)
  if name in ('dssm_neg_sampler', 'dssm_hard_neg_sampler'):
    assert moved > 0
  if name == 'dssm_neg_sampler_ev':
    assert int(tt.ev_masked) > 0


@pytest.mark.parametrize('name', ['dssm_neg_sampler', 'mind', 'dssm_reg',
                                  'metric_learning_i2i'])
def test_export_serves_the_trainers_forward(name, tmp_path):
  """A match model trained 2 steps on the CPU and exported: the Predictor
  answers raw rows with its serving outputs (user_emb and item_emb;
  DSSM_reg's y, MIND's user_interests, CML's float_emb), equal to the
  Trainer's eval forward on the same rows bit for bit (MIND's eval
  routing draw is the fixed seed's on either side, of the request's
  [rows, K, L] shape), the sampler's views absent from both."""
  from easyrec_torch.export import predictor as t_predictor
  from easyrec_torch.export.saved_model import export_saved_model
  from easyrec_torch.features import transforms as t_tr
  t_cfg, _ = sample_configs(name, str(tmp_path))
  tt = TTrainer(t_cfg, device='cpu')
  tt.init_state()
  for _, b in zip(range(2), tt.train_input()):
    tt.train_step(to_device(b, torch.device('cpu')))
  # one chunk: MIND's eval draw has the request's shape
  pred = t_predictor.Predictor(export_saved_model(tt, str(tmp_path / 'exp')),
                               batch_size=64, device='cpu')
  names = [f.input_name for f in t_cfg.data_config.input_fields]
  with open(str(tmp_path / 'train.csv')) as f:
    lines = [line.rstrip('\n').split(',') for line in f][:24]
  rows = [dict(zip(names, parts)) for parts in lines]
  got = pred.predict(rows)
  columns = {n: np.array([r[n] for r in rows], dtype=object)
             for n in pred.input_names}
  batch = t_tr.apply_transforms(t_tr.build_transforms(tt.specs), columns)
  batch['sample_weight'] = np.ones(len(rows), np.float32)
  tb = to_device(batch, torch.device('cpu'))
  with torch.no_grad():
    pulled = t_emb.pull_embeddings(
        tt.tables, t_emb.pack_all_views(tt.layout, tb), tt.metas)
    want = tt.model.export_outputs(tt.eval_forward(tb, pulled))
  keys = {'dssm_neg_sampler': ['item_emb', 'user_emb'],
          'mind': ['item_emb', 'user_emb', 'user_interests'],
          'dssm_reg': ['item_emb', 'user_emb', 'y'],
          'metric_learning_i2i': ['float_emb']}[name]
  assert sorted(want) == sorted(got[0]) == keys
  for k in keys:
    np.testing.assert_array_equal(np.stack([r[k] for r in got]),
                                  want[k].numpy(), err_msg=k)

