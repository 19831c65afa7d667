"""The backbone DSL of the port (easyrec_torch/models/backbone.py,
backbone_model.py) against the JAX package on the CPU: the `tf` shim of
the config lambdas, the DSL's semantics on configs that exercise them
(list merges and list outputs, shared and chained packages, package
input, recurrent and repeat with its quirks, layer lists, extra_input_fn,
ignore_input, raw_input, embedding_layer, the input layer's norms and
variational dropout, Struct params, multi-task relation towers), every
backbone sample and the three variational_dropout samples in eval mode,
and the random forms by what does not depend on the draw.

Tolerance: outputs within 1e-5 of their scale (the largest |logit|), f32
on both sides with matmul and reduction orders that differ, as
tests/test_torch_rank_zoo.py; attention under EASYREC_ATTN_IMPL=stock
there, and within 1% of the scale under the default vpu_bf16, whose
payload rounding the two packages apply to differently ordered sums
(tests/test_torch_bst.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.config import text_format as t_text
from easyrec_torch.features import feature_spec as t_fs
from easyrec_torch.layers import dnn as t_dnn
from easyrec_torch.models import backbone as t_bb
from easyrec_torch.models import backbone_model  # noqa: F401 (registers)
from easyrec_torch.models import base as t_base
from easyrec_torch.models import multi_task, rank  # noqa: F401 (registers)
from easyrec_torch.ops import embedding as t_emb
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.features import feature_spec as j_fs
from easyrec_tpu.models import backbone as j_bb
from easyrec_tpu.models import base as j_base
from easyrec_tpu.models import zoo  # noqa: F401 (registers)
from easyrec_tpu.utils.synthetic import synthetic_batch
from tests.test_torch_rank_zoo import SCHEMA
from tests.test_torch_samples import BACKBONE, VARIATIONAL_DROPOUT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
BF16_REL = 1e-2


def _torch(batch):
  return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          batch.items()}


# ------------------------------------------------------------- lambdas

LAMBDAS = [
    'lambda x: tf.concat(x, axis=1)',
    'lambda x: tf.concat(x, -1)',
    'lambda x: tf.stack(x, axis=1)',
    'lambda x: tf.reduce_sum(x[0], axis=1, keepdims=True)',
    'lambda x: tf.reduce_mean(x[0])',
    'lambda x: tf.reduce_max(x[1], axis=-1)',
    'lambda x: tf.add_n(x)',
    'lambda x: tf.unstack(tf.reshape(x[0], [-1, 2, 3]), axis=1)',
    'lambda x: tf.split(x[0], 2, axis=-1)',
    'lambda x: tf.gather(x[0], np.array([2, 0]), axis=1)',
    'lambda x: tf.norm(x[0], axis=-1)',
    'lambda x: tf.nn.softmax(x[0])',
    'lambda x: tf.nn.relu(x[0]) + tf.nn.sigmoid(x[1])',
    'lambda x: tf.transpose(tf.expand_dims(x[0], 2), [0, 2, 1])',
    'lambda x: tf.squeeze(tf.expand_dims(x[0], 1), 1)',
    'lambda x: tf.sigmoid(x[0]) * tf.tanh(x[1])',
    'lambda x: tf.multiply(tf.square(x[0]), tf.sqrt(tf.abs(x[1])))',
    'lambda x: tf.divide(tf.exp(x[0]), tf.ones_like(x[1]) + 1)',
    'lambda x: tf.math.log(tf.abs(x[0]) + 1)',
    'lambda x: tf.stop_gradient(x[0]) - tf.zeros_like(x[0])',
    'lambda x: jnp.concatenate([x[0], x[1]], axis=-1)',
    'lambda x: concatenate(x, axis=0)',
    'lambda x: [v * 2 for v in list(x)[::-1]]',
    'lambda x: x[0][:, :len(x) + 1]',
    'lambda x: sum(x) / max(len(x), 1)',
]


@pytest.mark.parametrize('expr', LAMBDAS)
def test_lambda_matches_jax(expr):
  """A config lambda through the port's tf shim (torch, axis= as dim=)
  and the JAX package's (jnp) gives the same values."""
  rng = np.random.default_rng(0)
  xs = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(2)]
  want = j_bb.eval_lambda(expr)([jnp.asarray(v) for v in xs])
  got = t_bb.eval_lambda(expr)([torch.from_numpy(v) for v in xs])
  want_l = want if isinstance(want, list) else [want]
  got_l = got if isinstance(got, list) else [got]
  assert len(got_l) == len(want_l)
  for a, b in zip(got_l, want_l):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                               atol=1e-6)


def test_lambdas_keep_the_restricted_builtins():
  with pytest.raises(NameError):
    t_bb.eval_lambda('lambda x: open("f")')(None)
  with pytest.raises(NameError):
    t_bb.eval_lambda('lambda x: __import__("os")')(None)


def test_slices_merges_and_flatten():
  a, b = torch.ones(2, 3), torch.zeros(2, 2)
  assert t_bb._apply_slice([a, b], '[1]') is b
  assert t_bb._apply_slice(a, '') is a
  assert torch.equal(t_bb._merge([a, b], -1), torch.cat([a, b], -1))
  # a list among the inputs merges into one flat list, not a concat
  merged = t_bb._merge([[a], b], -1)
  assert isinstance(merged, list) and len(merged) == 2
  assert t_bb._flatten([[a, b], a]) == [a, b, a]


# ------------------------------------------------------------- models


def _contexts(t_cfg, j_cfg):
  t_specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  j_specs = j_fs.build_feature_specs(j_config.get_feature_configs(j_cfg))
  return (t_base.build_context(t_cfg, t_specs),
          j_base.build_context(j_cfg, j_specs), j_specs)


def _forward_both(t_cfg, j_cfg, seed=2, batch_size=32):
  """The JAX module and the port's model from one set of perturbed flax
  variables; returns (run, variables, state_dict keys agree) where run(
  training) gives (port outputs, JAX outputs, JAX sown losses)."""
  t_ctx, j_ctx, j_specs = _contexts(t_cfg, j_cfg)
  module = j_base.create_model(j_ctx).make_module()
  t_model = t_base.create_model(t_ctx,
                                generator=torch.Generator().manual_seed(0))
  rng = np.random.default_rng(seed)
  labels = list(j_cfg.data_config.label_fields)
  batch = synthetic_batch(j_specs, labels, batch_size, seed=3)
  pulled = {k: rng.standard_normal(
      tuple(p.shape) + (t_ctx.layout.tables[k].dim,)).astype(np.float32)
            for k, p in t_emb.pack_ids(t_ctx.layout, _torch(batch)).items()}
  rngs = {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(0),
          'augment': jax.random.PRNGKey(0)}
  variables = module.init(rngs, batch, pulled, False)
  variables = {k: jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * rng.random(np.shape(a)).astype(
          np.float32), v) for k, v in variables.items()
      if k in ('params', 'batch_stats')}
  sd = convert.flax_to_state_dict(variables['params'],
                                  variables.get('batch_stats'),
                                  root=t_model.flax_root)
  assert sorted(sd) == sorted(t_model.state_dict()), sorted(
      set(sd) ^ set(t_model.state_dict()))
  # flax_names gives every key its flax path, key for key
  j_names = set()
  for section, tree in variables.items():
    for path, _ in jax.tree_util.tree_leaves_with_path(tree):
      j_names.add((section, '/'.join(str(p.key) for p in path)))
  assert set(convert.flax_names(t_model.state_dict(),
                                t_model.flax_root).values()) == j_names
  t_model.load_state_dict(sd)
  t_dnn.set_generator(t_model, torch.Generator().manual_seed(7))

  def run(training=False):
    want, mutated = module.apply(variables, batch, pulled, training,
                                 rngs=rngs, mutable=['batch_stats',
                                                     'losses'])
    t_model.train(training)
    got = t_model(_torch(batch), _torch(pulled))
    return got, want, jax.tree_util.tree_leaves(mutated.get('losses', {}))
  return run, t_model


def _check_outputs(got, want, rel):
  keys = sorted(k for k in want if k.startswith(('logits', 'probs')))
  assert keys and keys == sorted(k for k in got
                                 if k.startswith(('logits', 'probs')))
  for k in keys:
    w = np.asarray(want[k])
    np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                               atol=rel * max(np.abs(w).max(), 1.0),
                               err_msg=k)


def _sample(name):
  path = os.path.join(REPO, 'samples', name + '.config')
  return (t_config.get_configs_from_pipeline_file(path),
          j_config.get_configs_from_pipeline_file(path))


@pytest.mark.parametrize('name', BACKBONE + VARIATIONAL_DROPOUT)
def test_sample_forward_matches_jax(name, monkeypatch):
  """Each backbone sample's model, and the three variational_dropout
  samples' (whose MultiTower, DBMTL and ESMM ignore it, as the JAX
  package's do), in eval mode from one set of flax variables: the state
  dicts' keys are the flax tree's, every logit and probability agrees,
  and the losses the layers sow (AuxiliaryLoss) agree with the port's
  aux_losses."""
  monkeypatch.setenv('EASYREC_ATTN_IMPL', 'stock')
  run, _ = _forward_both(*_sample(name))
  got, want, sown = run(False)
  _check_outputs(got, want, REL)
  aux = got.get('aux_losses', [])
  assert len(aux) == len(sown)
  for a, b in zip(aux, sown):
    np.testing.assert_allclose(float(a.detach()), float(b), rtol=REL)


@pytest.mark.parametrize('name', ['bst_backbone', 'cl4srec_backbone'])
def test_attention_samples_under_vpu_bf16(name, monkeypatch):
  """The BST samples under the default attention payloads (vpu_bf16):
  within 1% of the logits' scale."""
  monkeypatch.setenv('EASYREC_ATTN_IMPL', 'vpu_bf16')
  run, _ = _forward_both(*_sample(name))
  got, want, _ = run(False)
  _check_outputs(got, want, BF16_REL)


DSL_RANK = '''  model_class: "RankModel"
  feature_groups { group_name: "dense" feature_names: ["F1", "F2"]
                   wide_deep: DEEP }
  feature_groups { group_name: "ids"
                   feature_names: ["C1", "C2", "C3", "C4", "T1"]
                   wide_deep: DEEP }
  feature_groups { group_name: "seq" feature_names: ["C1", "S1", "F2"]
                   wide_deep: DEEP }
  backbone {
    packages {
      name: "enc"
      blocks {
        name: "h"
        inputs { use_package_input: true }
        layers { lambda { expression: "lambda x: x * 2.0" } }
        layers { keras_layer { class_name: "MLP"
                               mlp { hidden_units: [8] use_bias: true } } }
      }
    }
    packages {
      name: "src"
      blocks {
        name: "ids3d"
        inputs { feature_group_name: "ids" }
        input_layer { only_output_3d_tensor: true do_batch_norm: true }
      }
      blocks {
        name: "flat"
        inputs { block_name: "ids3d" }
        keras_layer { class_name: "Flatten" }
      }
    }
    blocks {
      name: "ids"
      inputs { feature_group_name: "ids" }
      input_layer { do_layer_norm: true do_batch_norm: true }
    }
    blocks { name: "raw" inputs { feature_group_name: "dense" } raw_input {} }
    blocks {
      name: "emb"
      inputs { block_name: "raw" input_fn: "lambda x: tf.abs(x) * 10" }
      embedding_layer { embedding_dim: 4 vocab_size: 50 }
    }
    blocks {
      name: "chain"
      inputs { package_name: "enc" package_input: "src" }
    }
    blocks {
      name: "rep"
      inputs { block_name: "ids" }
      inputs { block_name: "emb" }
      extra_input_fn: "lambda x: [x, x * 0.5]"
      repeat {
        num_repeat: 2
        input_slice: "[i]"
        input_fn: "lambda x, i: x * (i + 1)"
        output_concat_axis: -1
        keras_layer { class_name: "Dense" %(dense)s }
      }
    }
    blocks {
      name: "seq_in"
      inputs { feature_group_name: "seq" }
      input_layer { output_seq_and_normal_feature: true }
    }
    blocks {
      name: "din"
      inputs { block_name: "seq_in" }
      keras_layer { class_name: "DIN"
                    din { attention_dnn { hidden_units: [4] } } }
    }
    blocks {
      name: "cross"
      inputs { block_name: "rep" }
      inputs { block_name: "chain" ignore_input: true }
      recurrent { num_steps: 2 keras_layer { class_name: "Cross" } }
    }
    blocks {
      name: "fields"
      inputs { feature_group_name: "ids" }
      input_layer { only_output_feature_list: true }
    }
    blocks {
      name: "dot"
      inputs { block_name: "fields" }
      inputs { block_name: "din" input_fn: "lambda x: [x[:, :8]]" }
      keras_layer { class_name: "DotInteraction" }
    }
    concat_blocks: ["cross", "chain", "dot", "fields"]
    top_mlp { hidden_units: [8] use_bn_after_activation: true }
  }
  variational_dropout { regularization_lambda: 0.05
                        embedding_wise_variational_dropout: %(ew)s }'''

DENSE_STRUCT = ('st_params { fields { key: "units" value: { number_value: 3 '
                '} } fields { key: "activation" value: { string_value: '
                '"tanh" } } }')


def _dsl_configs(ew='true'):
  text = SCHEMA % {'model': DSL_RANK % {'dense': DENSE_STRUCT, 'ew': ew}}
  return (t_config.get_configs_from_pipeline_str(text),
          j_config.get_configs_from_pipeline_str(text))


@pytest.mark.parametrize('ew', ['true', 'false'])
def test_dsl_semantics_match_jax(ew, monkeypatch):
  """One backbone that exercises the DSL (see DSL_RANK): a package fed by
  another package (package_input), a package's use_package_input and its
  list of layers, repeat's 'i'-replacing input_slice and 'lambda x, i'
  input_fn with output_concat_axis, extra_input_fn, a recurrent Cross on
  a single tensor, ignore_input, raw_input and embedding_layer, a block
  named after its feature group, the input layer's BatchNorm and
  LayerNorm (2-D and 3-D), its feature list and [seq, mask, normal]
  forms, a list merged into DotInteraction, a list-valued block among the
  concat blocks, keras Dense from Struct params, top_mlp with its
  post-activation BatchNorm, and variational dropout (per feature and per
  dimension) on every input layer: outputs in eval and in train mode (its
  batch statistics), and the variational dropout losses sown."""
  monkeypatch.setenv('EASYREC_ATTN_IMPL', 'stock')
  t_cfg, j_cfg = _dsl_configs(ew)
  run, t_model = _forward_both(t_cfg, j_cfg)
  names = sorted(t_model.state_dict())
  for want in ('backbone.main.ids_bn.running_mean', 'backbone.main.ids_ln.'
               'weight', 'backbone.main.emb_embed.embedding',
               'backbone.main.rep_l0_r1.Dense_0.weight',
               'backbone.main.cross_l0.CrossNetV2_0.w_0.weight',
               'backbone.pkg_src.ids3d_bn.running_var',
               'backbone.pkg_enc.h_l1.dense_0.weight',
               'backbone.main.fields_variational_dropout.logit_p',
               'backbone.top_mlp.bn_0.weight'):
    assert want in names, want
  for training in (False, True):
    got, want, sown = run(training)
    if training:
      # the variational dropout's noise is not flax's: eval-mode parts
      # only; the forward ran, and the losses do not depend on the draw
      assert torch.isfinite(got['logits']).all()
    else:
      _check_outputs(got, want, REL)
    aux = got['aux_losses']
    assert len(aux) == len(sown) == 3     # ids, ids3d (pkg_src), fields
    for a, b in zip(aux, sown):
      np.testing.assert_allclose(float(a.detach()), float(b), rtol=REL)


DSL_MULTI_TASK = '''  model_class: "MultiTaskModel"
  feature_groups { group_name: "all"
                   feature_names: ["F1", "F2", "C1", "C2", "C3", "T1"]
                   wide_deep: DEEP }
  backbone {
    blocks {
      name: "bottom"
      inputs { feature_group_name: "all" }
      keras_layer { class_name: "MLP" mlp { hidden_units: [16] } }
    }
    blocks {
      name: "experts"
      inputs { block_name: "bottom" }
      keras_layer { class_name: "MMoE"
                    mmoe { num_task: 2 num_expert: 3
                           expert_mlp { hidden_units: [8] } } }
    }
    blocks { name: "t0" inputs { block_name: "experts" input_slice: "[0]" } }
    blocks {
      name: "t1"
      inputs { block_name: "experts" input_slice: "[1]" }
      keras_layer { class_name: "Dice" }
    }
    output_blocks: ["t0", "t1"]
  }
  model_params {
    task_towers { tower_name: "ctr" label_name: "label"
                  dnn { hidden_units: [8] } }
    task_towers { tower_name: "cvr" label_name: "label"
                  dnn { hidden_units: [6] }
                  relation_tower_names: "ctr"
                  relation_dnn { hidden_units: [4] } }
  }'''


def test_multi_task_relation_towers_match_jax(monkeypatch):
  """A MultiTaskModel whose backbone gives one output per tower (MMoE's
  list sliced, a Dice in the package scope), tower DNNs, then cvr's
  relation chain on ctr with its relation_dnn: every output in eval and
  train mode."""
  text = SCHEMA % {'model': DSL_MULTI_TASK}
  run, t_model = _forward_both(t_config.get_configs_from_pipeline_str(text),
                               j_config.get_configs_from_pipeline_str(text))
  assert 'cvr_relation_dnn.dense_0.weight' in t_model.state_dict()
  assert 'backbone.main.Dice_0.alpha' in t_model.state_dict()
  for training in (False, True):
    got, want, _ = run(training)
    _check_outputs(got, want, REL)


def test_struct_params_round_trip_through_the_text_writer():
  """A pipeline.config the port writes (to_text) with st_params Structs
  reads back alike in both packages."""
  for name in ('cl4srec_backbone', 'contrastive_backbone'):
    t_cfg, j_cfg = _sample(name)
    text = t_text.to_text(t_cfg)
    assert 'st_params {' in text and 'string_value: ' in text
    again = t_config.get_configs_from_pipeline_str(text)
    assert t_text.canonical(again) == t_text.canonical(t_cfg)
    j_again = j_config.get_configs_from_pipeline_str(text)
    assert j_again.model_config == j_cfg.model_config


def test_modules_are_made_only_by_the_build_pass():
  """After the build pass, a forward that would make a module (here a
  batch whose dense feature is wider than the model was built for)
  raises instead of making it."""
  t_cfg, _ = _sample('dlrm_backbone')
  specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  ctx = t_base.build_context(t_cfg, specs)
  model = t_base.create_model(ctx)
  state = model.state
  assert not state.building and state.generator is None
  with pytest.raises(RuntimeError, match='build pass'):
    t_bb.lazy_child(model.backbone.main, state, 'new_block_l0',
                    lambda: torch.nn.Linear(1, 1))


# ------------------------------------------------------------- randomness


def test_variational_dropout_keeps_its_expected_share():
  """The training keep factor 1 - sigmoid((logit_p + noise) / 0.1), the
  noise logistic from the layer's generator: its mean over 10^5 draws
  within 4 sigma of its expectation (a numpy quadrature over the logistic
  density), which lies within 0.01 of the eval factor 1 - sigmoid(logit_p);
  eval is that factor exactly, and the loss does not depend on the draw."""
  from easyrec_torch.layers.variational_dropout import VariationalDropout
  sink = []
  vd = VariationalDropout([1], sink, 'p', regularization_lambda=0.5)
  with torch.no_grad():
    vd.logit_p.fill_(-1.0)
  feat = torch.ones(100000, 1)
  t_dnn.set_generator(vd, torch.Generator().manual_seed(0))
  keep = vd([feat])[0].detach().numpy()
  u = (np.arange(200000) + 0.5) / 200000
  noise = np.log(u) - np.log1p(-u)
  expect = np.mean(1.0 - 1.0 / (1.0 + np.exp(-(-1.0 + noise) / 0.1)))
  sigma = keep.std() / np.sqrt(keep.size)
  assert abs(keep.mean() - expect) < 4 * sigma
  eval_keep = 1.0 - 1.0 / (1.0 + np.exp(1.0))
  assert abs(expect - eval_keep) < 0.01
  vd.eval()
  np.testing.assert_allclose(vd([feat])[0].detach().numpy(), eval_keep,
                             rtol=1e-6)
  assert [float(v) for _, v in sink] == pytest.approx(
      [0.5 * (1.0 - 1.0 / (1.0 + np.exp(1.0)))] * 2)


def test_seq_augment_rows_are_one_of_the_three_forms():
  """SeqAugment in training: each row of the output is its input masked
  (every step kept or zero, the zeroed share within 4 sigma of
  mask_rate), cropped (equal inside one window of int(L * 0.8) steps,
  zero outside) or reordered (the steps permuted by one permutation of
  the whole batch), each branch within 4 sigma of a third of the rows;
  the mask and extras pass."""
  from easyrec_torch.layers.blocks import SeqAugment
  b, length, d = 3000, 10, 4
  seq = torch.randn(b, length, d, generator=torch.Generator().manual_seed(1))
  mask = torch.ones(b, length)
  aug = SeqAugment(mask_rate=0.6, crop_rate=0.2)
  t_dnn.set_generator(aug, torch.Generator().manual_seed(2))
  out, m, extra = aug([seq, mask, seq[:, 0]])
  assert m is mask and extra is not None
  win = int(length * 0.8)
  counts = {'mask': 0, 'crop': 0, 'reorder': 0}
  zeroed, perm = [], None
  for r in range(b):
    o, s = out[r], seq[r]
    same = (o == s).all(dim=1)
    zero = (o == 0).all(dim=1)
    idx = torch.nonzero(same).flatten()
    if bool((same | zero).all()) and not (
        len(idx) == win and int(idx[-1] - idx[0]) == win - 1):
      counts['mask'] += 1
      zeroed.append(float(zero.float().mean()))
    elif bool((same | zero).all()):
      counts['crop'] += 1
    else:
      p = [int(torch.nonzero((s == o[t]).all(dim=1)).flatten()[0])
           for t in range(length)]
      assert sorted(p) == list(range(length))
      assert perm is None or p == perm
      perm = p
      counts['reorder'] += 1
  assert sum(counts.values()) == b
  for c in counts.values():
    assert abs(c / b - 1 / 3) < 4 * np.sqrt((1 / 3) * (2 / 3) / b)
  n = counts['mask'] * length
  assert abs(np.mean(zeroed) - 0.6) < 4 * np.sqrt(0.6 * 0.4 / n)
  aug.eval()
  assert aug([seq, mask])[0] is seq


INPUT_DROPOUT = '''  model_class: "RankModel"
  feature_groups { group_name: "ids" feature_names: ["C1", "C2", "C3", "C4"]
                   wide_deep: DEEP }
  backbone {
    blocks {
      name: "ids"
      inputs { feature_group_name: "ids" }
      input_layer { %s }
    }
  }'''


@pytest.mark.parametrize('knob,rate', [('dropout_rate', 0.25),
                                       ('feature_dropout_rate', 0.5)])
def test_input_layer_dropout_draws_from_the_generator(knob, rate):
  """The input layer's dropout (per element) and feature dropout (per
  feature, the same features for the whole batch) in training: the
  dropped share within 4 sigma of the rate over its draws, the kept
  values scaled by 1 / (1 - rate); eval leaves the features as they are."""
  text = SCHEMA % {'model': INPUT_DROPOUT % ('%s: %s' % (knob, rate))}
  cfg = t_config.get_configs_from_pipeline_str(text)
  specs = t_fs.build_feature_specs(t_config.get_feature_configs(cfg))
  ctx = t_base.build_context(cfg, specs)
  model = t_base.create_model(ctx)
  t_dnn.set_generator(model, torch.Generator().manual_seed(4))
  from easyrec_torch.utils.synthetic import synthetic_batch as t_synth
  batch = _torch(t_synth(specs, ['label'], 512, seed=1))
  pulled = {k: torch.ones(tuple(p.shape) + (ctx.layout.tables[k].dim,))
            for k, p in t_emb.pack_ids(ctx.layout, batch).items()}
  model.eval()
  base = model.backbone(batch, pulled)
  model.train()
  draws = []
  for _ in range(200 if knob == 'feature_dropout_rate' else 1):
    out = model.backbone(batch, pulled)
    kept = out != 0
    np.testing.assert_allclose(out[kept].numpy(),
                               (base[kept] / (1 - rate)).numpy(), rtol=1e-6)
    if knob == 'feature_dropout_rate':
      # whole features: each 8-wide slot dropped for every row alike
      cols = kept.all(dim=0).reshape(4, -1)
      assert bool((cols.all(dim=1) | ~cols.any(dim=1)).all())
      draws.extend((~cols.all(dim=1)).float().tolist())
    else:
      draws.extend((~kept).float().flatten().tolist())
  share = np.mean(draws)
  assert abs(share - rate) < 4 * np.sqrt(rate * (1 - rate) / len(draws))
