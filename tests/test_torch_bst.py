"""The BST slice of the port against the JAX package: PackedMHA under each
EASYREC_ATTN_IMPL, TransformerBlock (post-LN and pre-LN), BSTEncoder for
each target position, MultiHeadSelfAttention and LayerNorm against flax
with the flax parameters carried across by convert.py; the MultiTowerBST
forward; three train steps of a small MultiTowerBST against the JAX
Trainer with the fused update (K3) and without it (K1 + K2); the Taobao
BST config; and a flax_names round trip of every new leaf."""

import functools

import jax
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.features import feature_spec as t_fs
from easyrec_torch.layers import attention as t_att
from easyrec_torch.models import base as t_base
from easyrec_torch.models import rank as t_rank  # noqa: F401 (registers)
from easyrec_torch.ops import embedding as t_emb
from easyrec_torch.ops import kernels
from easyrec_torch.ops import packed_table as tpt
from easyrec_torch.train.trainer import Trainer as TTrainer
from easyrec_torch.train.trainer import l2_of_kernels, to_device
from easyrec_torch.utils import flagship as t_flagship
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.features import feature_spec as j_fs
from easyrec_tpu.layers import attention as j_att
from easyrec_tpu.models import base as j_base
from easyrec_tpu.models import zoo  # noqa: F401 (registers)
from easyrec_tpu.ops import embedding as j_emb
from easyrec_tpu.ops import packed_table as jpt
from easyrec_tpu.train import restore as j_restore
from easyrec_tpu.train.trainer import Trainer as JTrainer
from easyrec_tpu.train.trainer import _l2_of_kernels
from easyrec_tpu.utils import flagship as j_flagship
from easyrec_tpu.utils.synthetic import synthetic_batch
from tests.test_torch_config import _assert_same

# f32 on both sides; matmul, softmax and reduction orders differ (XLA vs
# ATen): a few ulp of relative error per layer
TOL = dict(rtol=1e-5, atol=1e-5)
# vpu_bf16 rounds q, k, the probabilities and v to bf16 on both sides,
# from f32 values that differ in their last bits: where one side's value
# sits at a bf16 rounding boundary the two round a bf16 ulp (2^-8
# relative) apart, so outputs are held within 1% of their scale
BF16_TOL = 1e-2


def _perturbed(variables, seed, scale=0.3):
  """flax variables with every leaf moved by a seeded normal: the default
  initialisers leave biases, LayerNorms and outputs too close to 0 and 1
  to show a mistake."""
  rng = np.random.default_rng(seed)
  return jax.tree_util.tree_map(
      lambda a: np.asarray(a) + scale * rng.standard_normal(
          np.shape(a)).astype(np.float32), variables)


def _mask(rng, b, l):
  mask = (rng.random((b, l)) < 0.7).astype(np.float32)
  mask[0] = 0.0             # an all-padding row
  mask[1] = 1.0
  return mask


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def _load(t_mod, variables):
  t_mod.load_state_dict(convert.flax_to_state_dict(variables['params'],
                                                   root=None))
  return t_mod


# --------------------------------------------------------------- layers


@pytest.mark.parametrize('impl', ['stock', 'vpu', 'vpu_bf16'])
def test_packed_mha_matches_flax(impl, monkeypatch):
  """PackedMHA under each EASYREC_ATTN_IMPL, set on both sides: [B, L, D]
  query and key/value inputs of other lengths, a mask with an all-padding
  row; query/key/value kernels [D, H, Dh] and out [H, Dh, D] carried by
  the kernel transpose."""
  monkeypatch.setenv('EASYREC_ATTN_IMPL', impl)
  rng = np.random.default_rng(1)
  b, l, m, d, h = 6, 5, 7, 16, 4
  x_q = rng.standard_normal((b, l, d)).astype(np.float32)
  x_kv = rng.standard_normal((b, m, d)).astype(np.float32)
  mask = _mask(rng, b, m)
  j_mod = j_att.PackedMHA(num_heads=h, qkv_features=d, out_features=d)
  variables = _perturbed(j_mod.init(jax.random.PRNGKey(0), x_q, x_kv,
                                    mask), 2)
  want = np.asarray(j_mod.apply(variables, x_q, x_kv, mask))
  t_mod = _load(t_att.PackedMHA(d, h, d, d), variables)
  assert t_mod.query.weight.shape == (4, 4, 16)
  assert t_mod.out.weight.shape == (16, 4, 4)
  got = t_mod(_t(x_q), _t(x_kv), _t(mask)).detach().numpy()
  if impl == 'vpu_bf16':
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL * scale)
    # the bf16 payloads move the answer: it is not the f32 one
    monkeypatch.setenv('EASYREC_ATTN_IMPL', 'stock')
    f32 = t_mod(_t(x_q), _t(x_kv), _t(mask)).detach().numpy()
    assert np.abs(f32 - got).max() > 1e-5
  else:
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('pre_ln', [False, True])
def test_transformer_block_matches_flax(pre_ln, monkeypatch):
  """A post-LN block (the reference's) and a pre-LN one in eval mode:
  attention, LayerNorm (flax's epsilon 1e-6 and fast variance), the tanh
  gelu FFN and the residuals."""
  monkeypatch.setenv('EASYREC_ATTN_IMPL', 'stock')
  rng = np.random.default_rng(3)
  b, l, d = 5, 6, 16
  x = rng.standard_normal((b, l, d)).astype(np.float32)
  mask = _mask(rng, b, l)
  j_mod = j_att.TransformerBlock(hidden_size=d, num_heads=4,
                                 intermediate_size=32, pre_ln=pre_ln)
  variables = _perturbed(j_mod.init(jax.random.PRNGKey(0), x, mask), 4)
  want = np.asarray(j_mod.apply(variables, x, mask, False))
  t_mod = _load(t_att.TransformerBlock(d, 4, 32, pre_ln=pre_ln), variables)
  t_mod.eval()
  got = t_mod(_t(x), _t(mask)).detach().numpy()
  np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('position,target,reserve,all_tokens', [
    ('head', True, True, False),
    ('tail', True, True, False),
    ('', True, True, True),
    ('head', False, True, False),
    ('head', False, False, True),
])
def test_bst_encoder_matches_flax(position, target, reserve, all_tokens,
                                  monkeypatch):
  """BSTEncoder: the target token at the head or the tail, or left out
  (''); without a target, its reserved head position or none; two pre-LN
  blocks with the final LayerNorm; the target's token or every token."""
  monkeypatch.setenv('EASYREC_ATTN_IMPL', 'stock')
  rng = np.random.default_rng(5)
  b, l, d_in, d_t, hidden = 6, 7, 12, 10, 16
  seq = rng.standard_normal((b, l, d_in)).astype(np.float32)
  tgt = rng.standard_normal((b, d_t)).astype(np.float32) if target \
      else None
  mask = _mask(rng, b, l)
  kw = dict(hidden_size=hidden, num_layers=2, num_heads=4,
            intermediate_size=24, max_position=l,
            output_all_tokens=all_tokens, target_item_position=position,
            reserve_target_position=reserve, pre_ln=not reserve)
  j_mod = j_att.BSTEncoder(hidden_dropout=0.0, attention_dropout=0.0, **kw)
  variables = _perturbed(j_mod.init(jax.random.PRNGKey(0), seq, mask,
                                    target=tgt), 6)
  want = np.asarray(j_mod.apply(variables, seq, mask, target=tgt))
  t_mod = _load(t_att.BSTEncoder(d_in, l, target_features=d_t if target
                                 else 0, **kw), variables)
  rows = variables['params']['position_emb'].shape[0]
  assert tuple(t_mod.position_emb.shape) == (rows, hidden)
  t_mod.eval()
  got = t_mod(_t(seq), _t(mask),
              target=None if tgt is None else _t(tgt)).detach().numpy()
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('heads,head_size', [(4, 4), (2, 3)])
def test_multi_head_self_attention_matches_flax(heads, head_size):
  """AutoInt's interacting layer, with the identity residual (H * E = D)
  and with the bias-free `res` projection (H * E != D)."""
  rng = np.random.default_rng(7)
  b, f, d = 5, 6, 16
  x = rng.standard_normal((b, f, d)).astype(np.float32)
  mask = _mask(rng, b, f)
  j_mod = j_att.MultiHeadSelfAttention(num_heads=heads, head_size=head_size)
  variables = _perturbed(j_mod.init(jax.random.PRNGKey(0), x, mask), 8)
  want = np.asarray(j_mod.apply(variables, x, mask))
  t_mod = _load(t_att.MultiHeadSelfAttention(d, heads, head_size),
                variables)
  assert hasattr(t_mod, 'res') == (heads * head_size != d)
  got = t_mod(_t(x), _t(mask)).detach().numpy()
  np.testing.assert_allclose(got, want, **TOL)


def test_layer_norm_matches_flax():
  """flax's LayerNorm: epsilon 1e-6 and E[x^2] - E[x]^2, on rows of small
  spread (variance ~1e-4), where torch's epsilon of 1e-5 parts from it by
  about 5%."""
  import flax.linen as nn
  rng = np.random.default_rng(9)
  x = (0.01 * rng.standard_normal((8, 16))).astype(np.float32)
  variables = _perturbed(nn.LayerNorm().init(jax.random.PRNGKey(0), x), 10)
  want = np.asarray(nn.LayerNorm().apply(variables, x))
  t_mod = _load(t_att.LayerNorm(16), variables)
  got = t_mod(_t(x)).detach().numpy()
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
  ln = torch.nn.LayerNorm(16)
  ln.load_state_dict(t_mod.state_dict())
  assert np.abs(ln(_t(x)).detach().numpy() - want).max() > 1e-2


# --------------------------------------------------------------- model

CONFIG = '''
train_input_path: "synthetic"
eval_input_path: "synthetic"
train_config {
  optimizer_config { adam_optimizer { learning_rate {
    exponential_decay_learning_rate { initial_learning_rate: 0.01
      decay_steps: 2 decay_factor: 0.5 min_learning_rate: 0.004 } } } }
  num_steps: 3
  log_step_count_steps: 1
}
eval_config { metrics_set { auc {} } }
data_config {
  batch_size: 64 label_fields: "clk" input_type: DummyInput
  input_fields { input_name: "clk" input_type: FLOAT }
  input_fields { input_name: "user_id" input_type: STRING }
  input_fields { input_name: "brand" input_type: STRING }
  input_fields { input_name: "cate_id" input_type: STRING }
  input_fields { input_name: "tag_brand_list" input_type: STRING }
  input_fields { input_name: "tag_category_list" input_type: STRING }
}
feature_config {
  features { input_names: "user_id" feature_type: IdFeature
             embedding_dim: 8 hash_bucket_size: 300 }
  features { input_names: "brand" feature_type: IdFeature
             embedding_dim: 8 hash_bucket_size: 300 }
  features { input_names: "cate_id" feature_type: IdFeature
             embedding_dim: 8 hash_bucket_size: 200 }
  features { input_names: "tag_brand_list" feature_type: SequenceFeature
             separator: "|" embedding_dim: 8 hash_bucket_size: 300
             max_seq_len: 8 }
  features { input_names: "tag_category_list"
             feature_type: SequenceFeature separator: "|"
             embedding_dim: 8 hash_bucket_size: 200 max_seq_len: 8 }
}
model_config {
  model_class: "MultiTowerBST"
  feature_groups { group_name: "user" feature_names: "user_id"
                   wide_deep: DEEP }
  feature_groups { group_name: "item"
                   feature_names: ["brand", "cate_id"] wide_deep: DEEP }
  seq_att_groups {
    group_name: "bst"
    seq_att_map { key: "brand" hist_seq: "tag_brand_list" }
    seq_att_map { key: "cate_id" hist_seq: "tag_category_list" }
  }
  multi_tower {
    towers { input: "user" dnn { hidden_units: [16, 8] use_bn: false } }
    towers { input: "item" dnn { hidden_units: [16, 8] use_bn: false } }
    bst_towers { input: "bst" seq_len: 8 multi_head_size: 4 %(pre_ln)s }
    final_dnn { hidden_units: [8] use_bn: false }
    l2_regularization: 1e-3
  }
  embedding_regularization: 1e-4
}
'''


def _configs(pre_ln=False):
  text = CONFIG % {'pre_ln': 'pre_ln: true' if pre_ln else ''}
  return (t_config.get_configs_from_pipeline_str(text),
          j_config.get_configs_from_pipeline_str(text))


def _models(pre_ln=False):
  t_cfg, j_cfg = _configs(pre_ln)
  j_specs = j_fs.build_feature_specs(j_config.get_feature_configs(j_cfg))
  t_specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  j_ctx = j_base.build_context(j_cfg, j_specs)
  t_ctx = t_base.build_context(t_cfg, t_specs)
  return (j_specs, j_ctx, j_base.create_model(j_ctx).make_module(),
          t_ctx, t_base.create_model(t_ctx))


def _forward_inputs(j_specs, j_ctx, t_ctx, seed):
  rng = np.random.default_rng(seed)
  batch = synthetic_batch(j_specs, ['clk'], 32, seed=seed)
  for f in ('tag_brand_list', 'tag_category_list'):
    batch['feat.%s.mask' % f][2] = 0.0           # all padding
    batch['feat.%s.ids' % f][2] = 0
  batch['feat.tag_category_list.mask'][4, :] = 0.0   # mask = max of both
  packs = j_emb.pack_ids(j_ctx.layout, batch)
  pulled = {k: rng.standard_normal(
      tuple(p.shape) + (t_ctx.layout.tables[k].dim,)).astype(np.float32)
            for k, p in packs.items()}
  return batch, pulled


@pytest.mark.parametrize('impl,pre_ln', [('stock', False), ('stock', True),
                                         ('vpu_bf16', False)])
def test_multi_tower_bst_forward_matches_flax(impl, pre_ln, monkeypatch):
  """The whole MultiTowerBST forward with its input layer: two DNN towers,
  the BST tower over the two histories concatenated (hidden 16, 4 heads
  of 4, the target [brand, cate_id] at the head of 9 tokens), final_dnn
  and the logit; train and eval mode, an all-padding history row; under
  stock within f32 rounding, under vpu_bf16 within BF16_TOL of the
  logits' scale."""
  monkeypatch.setenv('EASYREC_ATTN_IMPL', impl)
  j_specs, j_ctx, module, t_ctx, t_model = _models(pre_ln)
  batch, pulled = _forward_inputs(j_specs, j_ctx, t_ctx, 11)
  variables = module.init({'params': jax.random.PRNGKey(0),
                           'dropout': jax.random.PRNGKey(0)},
                          batch, pulled, False)
  variables = _perturbed(variables, 12, scale=0.1)
  sd = convert.flax_to_state_dict(variables['params'])
  assert sd['bst_bst.position_emb'].shape == (9, 16)
  assert sd['bst_bst.block_0.mha.query.weight'].shape == (4, 4, 16)
  assert sd['bst_bst.block_0.mha.query.bias'].shape == (4, 4)
  assert sd['bst_bst.target_proj.weight'].shape == (16, 16)
  t_model.load_state_dict(sd)
  tb = {k: _t(v) for k, v in batch.items()}
  tp = {k: _t(v) for k, v in pulled.items()}
  for training in (True, False):
    want = np.asarray(module.apply(variables, batch, pulled, training,
                                   rngs={'dropout': jax.random.PRNGKey(1)},
                                   mutable=['losses'])[0]['logits'])
    t_model.train(training)
    got = t_model(tb, tp)['logits'].detach().numpy()
    if impl == 'vpu_bf16':
      np.testing.assert_allclose(got, want, rtol=0,
                                 atol=BF16_TOL * np.abs(want).max())
    else:
      np.testing.assert_allclose(got, want, **TOL)


def test_l2_of_kernels_matches_jax():
  """The l2 regulariser counts every kernel (Dense, the 3-D DenseGeneral
  ones) and no LayerNorm scale or position table, as the JAX trainer's
  _l2_of_kernels does."""
  j_specs, j_ctx, module, t_ctx, t_model = _models(pre_ln=True)
  batch, pulled = _forward_inputs(j_specs, j_ctx, t_ctx, 13)
  variables = _perturbed(module.init(
      {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(0)},
      batch, pulled, False), 14)
  t_model.load_state_dict(convert.flax_to_state_dict(variables['params']))
  np.testing.assert_allclose(float(l2_of_kernels(t_model).detach()),
                             float(_l2_of_kernels(variables['params'])),
                             rtol=1e-6)


def test_flax_names_round_trip_every_new_leaf():
  """Every leaf of the BST tower (3-D DenseGeneral kernels, their [H, Dh]
  biases, LayerNorm scales, position_emb) through flax_to_state_dict,
  flax_names and state_dict_to_flax: names as the JAX restore's _flatten
  gives them, values bit for bit both ways."""
  j_specs, j_ctx, module, t_ctx, t_model = _models(pre_ln=True)
  batch, pulled = _forward_inputs(j_specs, j_ctx, t_ctx, 15)
  variables = _perturbed(module.init(
      {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(0)},
      batch, pulled, False), 16)
  params = jax.device_get(variables['params'])
  sd = convert.flax_to_state_dict(params)
  t_model.load_state_dict(sd)
  names = convert.flax_names(t_model.state_dict())
  want = set(j_restore._flatten({'params': params}))
  assert {'%s/%s' % v for v in names.values()} == want
  for leaf in ('block_0/mha/query/kernel', 'block_0/mha/out/bias',
               'block_0/ln1/scale', 'final_ln/scale', 'position_emb'):
    assert 'params/inner/bst_bst/' + leaf in want, leaf
  back, _ = convert.state_dict_to_flax(t_model.state_dict())
  flat_back = j_restore._flatten({'params': back})
  flat_want = j_restore._flatten({'params': params})
  assert sorted(flat_back) == sorted(flat_want)
  for k, v in flat_want.items():
    assert flat_back[k].shape == np.shape(v), k
    np.testing.assert_array_equal(flat_back[k].view(np.uint32),
                                  np.asarray(v).view(np.uint32), err_msg=k)


def test_taobao_bst_config_matches():
  """taobao_bst_config against the JAX package's: every field, the
  specs, and the BST tower at full width: hidden 32 (two dim-16
  histories), 4 heads of 8, FFN 128, 51 tokens and position rows."""
  t_cfg = t_flagship.taobao_bst_config(batch_size=64)
  j_cfg = j_flagship.taobao_bst_config(batch_size=64, model_dir='')
  _assert_same(t_cfg, j_cfg, 'config')
  t_config.check_ported(t_cfg)
  specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  model = t_base.create_model(t_base.build_context(t_cfg, specs))
  bst = model.bst_bst
  assert tuple(bst.position_emb.shape) == (51, 32)
  assert tuple(bst.block_0.mha.query.weight.shape) == (8, 4, 32)
  assert tuple(bst.block_0.ffn1.weight.shape) == (128, 32)
  assert not hasattr(model, 'bst_bst.block_1')


# --------------------------------------------------- three train steps


LR_SUM = 0.01 + 0.01 + 0.005      # the schedule's rates of the 3 steps


def _batches(specs):
  batches = [synthetic_batch(specs, ['clk'], 64, seed=s) for s in range(5)]
  # DummyInput's shape of sequence in one batch: one token, the rest
  # padding, so each sequence's padding id collects 64 * 7 slots
  for f in ('tag_brand_list', 'tag_category_list'):
    batches[1]['feat.%s.mask' % f][:, 1:] = 0.0
    batches[1]['feat.%s.ids' % f][:, 1:] = 0
  return batches


@pytest.mark.parametrize('fused', ['0', '1'])
def test_three_steps_match_jax_trainer(fused, monkeypatch):
  """The port's Trainer, fused (K3's plain version) or not (K1 + K2), and
  the JAX Trainer with packed combined tables and f32 gradient sums, from
  the same state and batches, under EASYREC_ATTN_IMPL=stock (under
  vpu_bf16 the JAX backward rounds the products' cotangents to bf16 as
  well; only its forward is held, above).

  Tolerances, with their reasons. Losses: f32 in another order, relative
  2e-5. Dense parameters within 2e-5 and table weights within 2e-5: Adam
  steps of lr on gradients that differ in their last bits, where a
  gradient near Adam's eps of 1e-8 keeps its relative f32 error in the
  step (the DIN slice's reason for 1e-5; the encoder's LayerNorms and
  softmaxes add their rounding); m and v within one bf16 ulp or 1e-9.
  Rows no batch pulled are bit-equal. The attention's key bias adds q.b
  to every score of a query, which its softmax removes: its gradient is
  zero up to rounding, and Adam turns that noise into steps of +-lr either
  way, so it is held only to that bound (as the DIN slice holds a Dense
  bias before BatchNorm)."""
  monkeypatch.setenv('EASYREC_PACKED_TABLES', '1')
  monkeypatch.setenv('EASYREC_GG_BF16', '0')
  monkeypatch.setenv('EASYREC_PACKED_FUSED', fused)
  monkeypatch.setenv('EASYREC_ATTN_IMPL', 'stock')
  t_cfg, j_cfg = _configs()
  jt = JTrainer(j_cfg, devices=jax.devices('cpu')[:1])
  assert jt.packed_mode and jt._packed_compact
  tt = TTrainer(t_cfg, device='cpu')
  batches = _batches(jt.specs)
  state = jt.init_state(batches[0])
  tt.init_state()
  tt.model.load_state_dict(convert.flax_to_state_dict(state.params,
                                                      state.batch_stats))
  for key, meta in jt.pack_metas.items():
    tt.tables[key].copy_(torch.from_numpy(convert.jax_packed_to_table(
        np.asarray(state.tables[key]), meta.dim, tt.metas[key].rows,
        meta.n_parts)))
  cpu = torch.device('cpu')
  calls = []
  real = tpt.rmw_fused
  monkeypatch.setattr(tpt, 'rmw_fused',
                      lambda *a: calls.append(1) or real(*a))
  kernels.reset_launches()
  for s in range(3):
    state, j_loss = jt.train_step(state, jt.rules.shard_batch(batches[s]))
    t_loss = tt.train_step(to_device(batches[s], cpu))
    np.testing.assert_allclose(float(t_loss['total_loss']),
                               float(j_loss['total_loss']), rtol=2e-5)
  assert int(tt.step) == int(state.step) == 3
  assert len(calls) == (3 if fused == '1' else 0)
  assert set(kernels.launch_counts().values()) == {0}     # CPU: plain

  params, _ = convert.state_dict_to_flax(tt.model.state_dict())
  j_params = jax.device_get(state.params)
  n_bst = 0
  for path, got in jax.tree_util.tree_leaves_with_path(params):
    want = np.asarray(functools.reduce(lambda t, k: t[k.key], path,
                                       j_params))
    n_bst += path[1].key == 'bst_bst'
    if [k.key for k in path[-2:]] == ['key', 'bias']:
      assert np.abs(got - want).max() <= 2 * LR_SUM
      continue
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5,
                               err_msg=jax.tree_util.keystr(path))
  assert n_bst == 23
  for key, meta in jt.pack_metas.items():
    rows = tt.metas[key].rows
    seen = np.zeros(rows, bool)
    for b in batches[:3]:
      seen[t_emb.pack_ids(tt.layout, _torch(b))[key].numpy().ravel()] = True
    jw, (jm, jv) = jpt.unpack_host(np.asarray(state.tables[key]), meta,
                                   rows)
    tw, (tm, tv) = tpt.unpack_host(tt.tables[key].numpy(), tt.metas[key])
    np.testing.assert_allclose(tw, jw, rtol=0, atol=2e-5)
    for got, want in ((tm, jm), (tv, jv)):
      np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-9)
    assert 0 < (~seen).sum() < rows
    for got, want in ((tw, jw), (tm, jm), (tv, jv)):
      np.testing.assert_array_equal(got[~seen].view(np.uint32),
                                    want[~seen].view(np.uint32))
  j_eval = jt.evaluate(state, eval_iter=batches[3:])
  t_eval = tt.evaluate(eval_iter=batches[3:])
  # AUC from 8192-bin histograms: a probability a hair from a bin edge
  # may land one bin over
  np.testing.assert_allclose(t_eval['auc'], j_eval['auc'], atol=1e-3)
  np.testing.assert_allclose(t_eval['loss'], j_eval['loss'], rtol=2e-5)


def _torch(batch):
  return {k: _t(v) for k, v in batch.items()}
