"""A rank model's loss terms in the port (easyrec_torch/models/base.py
RankModel.build_loss, models/rank.py RocketLaunching.build_loss) and
max-F1 (metrics/metrics.py) against the JAX package on the CPU: the
model-level `losses` with fixed and Uncertainty weights (values and the
gradients of the logits and of `loss_uncertainty`), RocketLaunching's four
terms with the gradient of every parameter and its three stopped
gradients, max_f1 from the AUC histogram, check_ported's refusals of
the loss parts that are not ported, and loss_weight_strategy Random: its
loss with the JAX draw handed to the port, its own draws, and a model with
it passing check_ported and training."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.metrics import metrics as t_metrics
from easyrec_torch.models import base as t_base
from easyrec_torch.ops import embedding as t_emb
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.metrics import metrics as j_metrics
from easyrec_tpu.models import base as j_base
from easyrec_tpu.utils.synthetic import synthetic_batch
from tests.test_torch_rank_zoo import SCHEMA, _configs, _contexts, _torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEEPFM = '''  model_class: "DeepFM"
  feature_groups { group_name: "deep" feature_names: ["F1", "C1", "C2"]
                   wide_deep: DEEP }
  feature_groups { group_name: "wide" feature_names: ["C1", "C2"]
                   wide_deep: WIDE }
  deepfm { dnn { hidden_units: [8] } }
%s'''

TERMS = '''  losses { loss_type: CLASSIFICATION weight: 1.0 }
  losses { loss_type: BINARY_FOCAL_LOSS weight: 0.5 loss_name: "focal"
           %s binary_focal_loss { gamma: 1.5 alpha: 0.8 } }
  losses { loss_type: F1_REWEIGHTED_LOSS weight: 0.3
           f1_reweighted_loss { f1_beta_square: 2.0 label_smoothing: 0.1 } }
  losses { loss_type: L2_LOSS weight: 0.2 %s }
'''

# name -> the loss part of the model config
LOSSES = {
    'fixed': TERMS % ('', ''),
    'uncertainty': TERMS % ('', '') + '  loss_weight_strategy: Uncertainty',
    'uncertainty_learn_two': TERMS % ('learn_loss_weight: true',
                                      'learn_loss_weight: true') +
                             '  loss_weight_strategy: Uncertainty',
    'focal_ohem': '''  losses { loss_type: BINARY_FOCAL_LOSS
           binary_focal_loss { gamma: 2.0 ohem_ratio: 0.5
                               label_smoothing: 0.05 } }''',
    'cross_entropy_types': '''
  losses { loss_type: CROSS_ENTROPY_LOSS weight: 0.7 }
  losses { loss_type: BINARY_CROSS_ENTROPY_LOSS weight: 0.4 }''',
    'one_term_uncertainty': '''  losses { loss_type: BINARY_FOCAL_LOSS }
  loss_weight_strategy: Uncertainty''',
}


def _model_pair(losses):
  text = SCHEMA % {'model': DEEPFM % losses}
  t_cfg = t_config.get_configs_from_pipeline_str(text)
  j_cfg = j_config.get_configs_from_pipeline_str(text)
  t_ctx, j_ctx, j_specs = _contexts(t_cfg, j_cfg)
  return t_base.create_model(t_ctx), j_base.create_model(j_ctx), j_specs


@pytest.mark.parametrize('name', sorted(LOSSES))
def test_model_losses_match_jax(name):
  """Each term and the total from the same logits, labels and sample
  weights (some 0), and the gradients of the total by the logits and by
  loss_uncertainty, within 1e-6 relative (f32 sums in another order).
  Uncertainty holds one weight per term, and with learn_loss_weight on
  some terms only those are learned."""
  t_model, j_model, j_specs = _model_pair(LOSSES[name])
  n_terms = max(len(t_model.config.losses), 1)
  learned = name.startswith('uncertainty')
  assert hasattr(t_model, 'loss_uncertainty') == learned
  rng = np.random.default_rng(4)
  batch = synthetic_batch(j_specs, ['label'], 64, seed=5)
  batch['sample_weight'][-9:] = 0.0
  logits = (rng.standard_normal(64) * 2).astype(np.float32)
  u = (rng.standard_normal(n_terms) * 0.5).astype(np.float32)

  def j_total(lg, uu):
    out = {'logits': lg, 'probs': jax.nn.sigmoid(lg)}
    if learned:
      out['uncertainty_w'] = uu
    total, terms = j_model.build_loss(out, batch)
    return total, terms

  (j_tot, j_terms), (j_dlg, j_du) = jax.value_and_grad(
      j_total, argnums=(0, 1), has_aux=True)(jnp.asarray(logits),
                                             jnp.asarray(u))
  lg = torch.tensor(logits, requires_grad=True)
  uu = torch.tensor(u, requires_grad=True)
  out = {'logits': lg, 'probs': torch.sigmoid(lg)}
  if learned:
    out['uncertainty_w'] = uu
  t_tot, t_terms = t_model.build_loss(out, _torch(batch))
  t_tot.backward()
  assert sorted(t_terms) == sorted(j_terms)
  for k in j_terms:
    np.testing.assert_allclose(t_terms[k].item(), float(j_terms[k]),
                               rtol=1e-6, err_msg=k)
  np.testing.assert_allclose(t_tot.item(), float(j_tot), rtol=1e-6)
  np.testing.assert_allclose(lg.grad.numpy(), np.asarray(j_dlg), rtol=1e-5,
                             atol=1e-9)
  if learned:
    np.testing.assert_allclose(uu.grad.numpy(), np.asarray(j_du), rtol=1e-5,
                               atol=1e-9)
    if name == 'uncertainty_learn_two':
      # only the two learners get a gradient
      assert np.count_nonzero(uu.grad.numpy()) == 2


def test_loss_uncertainty_is_beside_inner():
  """flax keeps `loss_uncertainty` beside `inner`: convert.py carries it
  to the model's parameter of that name and back, and fine-tune restore
  names it so (no inner/ prefix)."""
  t_model, j_model, j_specs = _model_pair(LOSSES['uncertainty'])
  module = j_model.make_module()
  batch = synthetic_batch(j_specs, ['label'], 8, seed=1)
  t_packs = t_emb.pack_ids(t_model.ctx.layout, _torch(batch))
  pulled = {k: np.zeros(tuple(p.shape) + (t_model.ctx.layout.tables[k].dim,),
                        np.float32) for k, p in t_packs.items()}
  variables = module.init({'params': jax.random.PRNGKey(0),
                           'dropout': jax.random.PRNGKey(0)},
                          batch, pulled, False)
  params = jax.tree_util.tree_map(np.asarray, dict(variables['params']))
  assert sorted(params) == ['inner', 'loss_uncertainty']
  params['loss_uncertainty'] = np.float32([0.1, -0.2, 0.3, 0.4])
  sd = convert.flax_to_state_dict(params, variables['batch_stats'])
  t_model.load_state_dict(sd)
  np.testing.assert_array_equal(t_model.loss_uncertainty.detach().numpy(),
                                params['loss_uncertainty'])
  names = convert.flax_names(t_model.state_dict())
  assert names['loss_uncertainty'] == ('params', 'loss_uncertainty')
  back, _ = convert.state_dict_to_flax(t_model.state_dict())
  np.testing.assert_array_equal(back['loss_uncertainty'],
                                params['loss_uncertainty'])
  out = t_model(_torch(batch), _torch(pulled))
  assert out['uncertainty_w'] is t_model.loss_uncertainty
  assert sorted(t_model.export_outputs(out)) == ['logits', 'probs']


# ------------------------------------------------------- RocketLaunching


def _rocket(model):
  """The small Rocket's JAX module and port model from one set of
  perturbed flax weights, with a batch and pulled rows."""
  t_cfg, j_cfg = _configs(model, bn=False)
  t_ctx, j_ctx, j_specs = _contexts(t_cfg, j_cfg)
  j_model = j_base.create_model(j_ctx)
  module = j_model.make_module()
  t_model = t_base.create_model(t_ctx)
  rng = np.random.default_rng(6)
  batch = synthetic_batch(j_specs, ['label'], 32, seed=7)
  batch['sample_weight'][-4:] = 0.0
  pulled = {k: rng.standard_normal(
      tuple(p.shape) + (t_ctx.layout.tables[k].dim,)).astype(np.float32)
            for k, p in t_emb.pack_ids(t_ctx.layout, _torch(batch)).items()}
  variables = module.init({'params': jax.random.PRNGKey(0),
                           'dropout': jax.random.PRNGKey(0)},
                          batch, pulled, False)
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))
      .astype(np.float32), dict(variables['params']))
  t_model.load_state_dict(convert.flax_to_state_dict(params))
  t_model.train()
  return t_model, j_model, module, params, batch, pulled


@pytest.mark.parametrize('model', ['rocket_launching', 'rocket_euclid'])
def test_rocket_loss_and_gradients_match_jax(model):
  """light_ce, booster_ce, hint_loss and feature_distill (cosine, or
  euclidean) from the same weights and batch within 1e-5 relative, and
  the gradient of the total by every parameter within 1e-5: the stopped
  gradients (the light tower's input, the hint's booster target, the
  distilled booster hiddens) must stop in the same places."""
  t_model, j_model, module, params, batch, pulled = _rocket(model)

  def j_loss(p):
    out = module.apply({'params': p}, batch, pulled, True)
    return j_model.build_loss(out, batch)

  (j_tot, j_terms), j_grad = jax.value_and_grad(j_loss, has_aux=True)(
      params)
  out = t_model(_torch(batch), _torch(pulled))
  t_tot, t_terms = t_model.build_loss(out, _torch(batch))
  assert sorted(t_terms) == sorted(j_terms) == [
      'booster_ce', 'feature_distill', 'hint_loss', 'light_ce']
  for k in j_terms:
    np.testing.assert_allclose(t_terms[k].item(), float(j_terms[k]),
                               rtol=1e-5, err_msg=k)
  np.testing.assert_allclose(t_tot.item(), float(j_tot), rtol=1e-5)
  t_tot.backward()
  grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
           for k, p in t_model.named_parameters()}
  t_grad, _ = convert.state_dict_to_flax(grads)
  for path, want in jax.tree_util.tree_leaves_with_path(j_grad):
    got = t_grad
    for k in path:
      got = got[k.key]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7,
                               err_msg=jax.tree_util.keystr(path))


def test_rocket_stopped_gradients():
  """Term by term on the port: the light cross entropy moves neither the
  shared DNN nor the booster; the hint moves only the light tower; the
  feature distillation moves only the light tower; the booster's cross
  entropy moves the shared DNN and the booster, not the light tower."""
  t_model, _, _, _, batch, pulled = _rocket('rocket_launching')
  out = t_model(_torch(batch), _torch(pulled))
  _, terms = t_model.build_loss(out, _torch(batch))

  def moved(term):
    t_model.zero_grad(set_to_none=True)
    terms[term].backward(retain_graph=True)
    return {n.split('.')[0].rsplit('_', 1)[0] if '_dense_' in n
            else n.split('.')[0]
            for n, p in t_model.named_parameters()
            if p.grad is not None and bool(p.grad.abs().sum() > 0)}

  light = {'light_dense', 'light_logits'}
  assert moved('light_ce') == light
  assert moved('hint_loss') == light
  assert moved('feature_distill') == {'light_dense'}
  assert moved('booster_ce') == {'share_dnn', 'booster_dense',
                                 'booster_logits'}


def test_rocket_cosine_distill_at_a_dead_light_row():
  """Where every relu of a light hidden row is off, the row is zero and
  its norm has no gradient: the JAX package's jnp.linalg.norm gives NaN
  there, which its step writes into the light tower (a fault of the
  reference, ROADMAP); torch.linalg.norm's is 0, so the port's row gets
  the finite gradient of the row over its clamped norm (1e-9). The loss
  values agree, and so do the other rows' gradients."""
  t_model, j_model, _, _, batch, _ = _rocket('rocket_launching')
  rng = np.random.default_rng(8)
  light = [np.abs(rng.standard_normal((32, 16))).astype(np.float32),
           np.abs(rng.standard_normal((32, 8))).astype(np.float32)]
  light[1][3] = 0.0
  booster = [rng.standard_normal((32, n)).astype(np.float32)
             for n in (16, 8, 8)]
  logits = rng.standard_normal(32).astype(np.float32)

  def j_fd(lh):
    out = {'logits': logits, 'booster_logits': logits[:, None],
           'light_hidden': lh, 'booster_hidden': booster}
    return j_model.build_loss(out, batch)[1]['feature_distill']

  j_val, j_g = jax.value_and_grad(j_fd)(light)
  assert np.isnan(np.asarray(j_g[1])[3]).all()
  lh = [torch.tensor(x, requires_grad=True) for x in light]
  out = {'logits': torch.tensor(logits),
         'booster_logits': torch.tensor(logits[:, None]),
         'light_hidden': lh,
         'booster_hidden': [torch.tensor(b) for b in booster]}
  t_val = t_model.build_loss(out, _torch(batch))[1]['feature_distill']
  t_val.backward()
  np.testing.assert_allclose(t_val.item(), float(j_val), rtol=1e-6)
  assert torch.isfinite(lh[1].grad).all()
  np.testing.assert_allclose(np.delete(lh[1].grad.numpy(), 3, axis=0),
                             np.delete(np.asarray(j_g[1]), 3, axis=0),
                             rtol=1e-5, atol=1e-8)


def test_rocket_exports_booster_probs():
  t_model, j_model, module, params, batch, pulled = _rocket(
      'rocket_launching')
  t_model.eval()
  out = t_model(_torch(batch), _torch(pulled))
  want = j_model.export_outputs(module.apply({'params': params}, batch,
                                             pulled, False))
  got = t_model.export_outputs(out)
  assert sorted(got) == sorted(want) == ['booster_probs', 'logits', 'probs']
  for k in want:
    np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                               rtol=1e-5, atol=1e-6, err_msg=k)


# ----------------------------------------------------------------- max_f1


@pytest.mark.parametrize('case', ['random', 'skewed', 'no_positive'])
def test_max_f1_matches_jax(case):
  """max_f1 from the AUC histogram (the best F1 over the bins' lower
  edges) and AUC, from the same streamed batches, against the JAX
  package's; exact up to float64 summation (1e-12)."""
  rng = np.random.default_rng({'random': 0, 'skewed': 1,
                               'no_positive': 2}[case])
  t_state = t_metrics.init_auc_state('cpu')
  j_state = j_metrics.init_metric_state('max_f1')
  for _ in range(3):
    n = 500
    probs = rng.random(n).astype(np.float32)
    if case == 'skewed':
      probs = probs ** 4
    labels = (rng.random(n) < (0.0 if case == 'no_positive' else probs)
              ).astype(np.float32)
    weights = (rng.random(n) < 0.9).astype(np.float32)
    t_metrics.update_auc(t_state, torch.from_numpy(labels),
                         torch.from_numpy(probs), torch.from_numpy(weights))
    j_state = j_metrics.update_auc(j_state, labels, probs, weights)
  np.testing.assert_allclose(t_metrics.max_f1_result(t_state),
                             j_metrics.max_f1_result(j_state), rtol=1e-12)
  np.testing.assert_allclose(t_metrics.auc_result(t_state),
                             j_metrics.auc_result(j_state), rtol=1e-12)
  if case == 'no_positive':
    assert t_metrics.max_f1_result(t_state) == 0.0


def test_metrics_collection_reports_auc_and_max_f1():
  """The metrics_set of samples/dcn_max_f1.config: one histogram, `auc`
  and `max_f1` as the JAX MetricsCollection reports them."""
  cfg = t_config.get_configs_from_pipeline_file(
      os.path.join(REPO, 'samples', 'dcn_max_f1.config'))
  j_cfg = j_config.get_configs_from_pipeline_file(
      os.path.join(REPO, 'samples', 'dcn_max_f1.config'))
  t_mc = t_metrics.MetricsCollection(cfg.eval_config.metrics_set)
  j_mc = j_metrics.MetricsCollection(j_cfg.eval_config.metrics_set)
  rng = np.random.default_rng(3)
  probs = rng.random(256).astype(np.float32)
  labels = (rng.random(256) < probs).astype(np.float32)
  weights = np.ones(256, np.float32)
  t_states = t_mc.update_states(t_mc.init_states('cpu'),
                                torch.from_numpy(labels),
                                torch.from_numpy(probs),
                                torch.from_numpy(weights))
  assert list(t_states) == ['auc_hist']
  j_states = j_mc.update_states(j_mc.init_states(), labels, probs, probs,
                                weights)
  got, want = t_mc.results(t_states), j_mc.results(j_states)
  assert sorted(got) == sorted(want) == ['auc', 'max_f1']
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


# ------------------------------------------------------------ refusals

REFUSED = {
    # a pairwise or listwise term on a model of several classes
    'pairwise': ('  num_class: 2\n  losses { loss_type: PAIR_WISE_LOSS }',
                 'PAIR_WISE_LOSS of model_config.losses'),
    'listwise': ('  num_class: 3\n  losses { loss_type: CLASSIFICATION }\n'
                 '  losses { loss_type: LISTWISE_RANK_LOSS }',
                 r'LISTWISE_RANK_LOSS of model_config.losses\[1\]'),
    # JRC and ZILN terms read 2 and 3 logits, which a model of one logit
    # does not make
    'jrc_params': ('  losses { loss_type: JRC_LOSS jrc_loss {} }',
                   'JRC_LOSS of model_config.losses'),
    'ziln': ('  losses { loss_type: ZILN_LOSS }', 'ZILN_LOSS'),
    'sigmoid_l2': ('  losses { loss_type: SIGMOID_L2_LOSS }',
                   'SIGMOID_L2_LOSS'),
    # a term beside ZILN's 3 logits
    'ziln_terms': ('  loss_type: ZILN_LOSS\n'
                   '  losses { loss_type: CLASSIFICATION }',
                   'CLASSIFICATION of model_config.losses'),
    'loss_type': ('  loss_type: PAIRWISE_HINGE_LOSS num_class: 2',
                  'loss_type PAIRWISE_HINGE_LOSS with num_class 2'),
}


@pytest.mark.parametrize('name', sorted(REFUSED))
def test_unported_loss_parts_are_refused_by_name(name):
  part, match = REFUSED[name]
  cfg = t_config.get_configs_from_pipeline_str(
      SCHEMA % {'model': DEEPFM % part})
  with pytest.raises(NotImplementedError, match=match):
    t_config.check_ported(cfg)


# ----------------------------------------------------- Random loss weights

RANDOM = TERMS % ('', '') + '  loss_weight_strategy: Random'


def _random_loss(t_model, j_model, batch, logits, j_w):
  """Both totals and terms from the same logits and the JAX weights."""
  lg = torch.tensor(logits, requires_grad=True)
  out = {'logits': lg, 'probs': torch.sigmoid(lg),
         'random_loss_w': torch.from_numpy(np.array(j_w))}
  t_tot, t_terms = t_model.build_loss(out, _torch(batch))
  t_tot.backward()

  def j_total(x):
    return j_model.build_loss({'logits': x, 'probs': jax.nn.sigmoid(x),
                               'random_loss_w': j_w}, batch)

  (j_tot, j_terms), j_grad = jax.value_and_grad(j_total, has_aux=True)(
      jnp.asarray(logits))
  return (t_tot, t_terms, lg.grad), (j_tot, j_terms, j_grad)


@pytest.mark.parametrize('case', ['random_loss', 'random_trains'])
def test_random_loss_weights(case):
  """loss_weight_strategy Random weights the terms by softmax(normal(n)) *
  n (JAX models/rank.py:435-438). The draws differ (ROADMAP's known
  divergences): 'random_loss' hands the port the JAX eval draw of
  PRNGKey(0) and holds total, terms and the logits' gradient within 1e-6;
  the port's own draws sum to n, are the same on every eval forward and
  new on every training one. 'random_trains': the config passes
  check_ported, and a Trainer trains 3 steps to finite losses with
  predictions that do not depend on the draw."""
  t_model, j_model, j_specs = _model_pair(RANDOM)
  n = len(t_model.config.losses)
  batch = synthetic_batch(j_specs, ['label'], 64, seed=5)
  if case == 'random_loss':
    j_w = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(0),
                                           (n,))) * n
    logits = (np.random.default_rng(4).standard_normal(64) * 2).astype(
        np.float32)
    (t_tot, t_terms, t_grad), (j_tot, j_terms, j_grad) = _random_loss(
        t_model, j_model, batch, logits, j_w)
    for k in j_terms:
      np.testing.assert_allclose(t_terms[k].item(), float(j_terms[k]),
                                 rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(t_tot.item(), float(j_tot), rtol=1e-6)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad),
                               rtol=1e-5, atol=1e-9)
    draw = t_model.random_loss_weights
    draw.eval()
    w0, w1 = draw('cpu'), draw('cpu')
    assert torch.equal(w0, w1) and w0.shape == (n,)
    np.testing.assert_allclose(float(w0.sum()), n, rtol=1e-6)
    draw.train()
    draw.generator = torch.Generator().manual_seed(1)
    assert not torch.equal(draw('cpu'), draw('cpu'))
    return
  from easyrec_torch.train.trainer import Trainer, to_device
  t_cfg = t_config.get_configs_from_pipeline_str(
      SCHEMA % {'model': DEEPFM % RANDOM})
  t_config.check_ported(t_cfg)
  trainer = Trainer(t_cfg, device='cpu')
  trainer.init_state()
  dev = to_device(batch, torch.device('cpu'))
  pulled = trainer.pull(t_emb.pack_all_views(trainer.layout, dev))
  before = trainer.eval_forward(dev, pulled)
  losses = [float(trainer.train_step(dev)['total_loss']) for _ in range(3)]
  assert np.all(np.isfinite(losses)) and len(set(losses)) == 3
  trainer.model.train()
  again = trainer.model(dev, pulled)
  trainer.model.eval()
  # training draws new weights; the probabilities do not read them
  assert not torch.equal(again['random_loss_w'], before['random_loss_w'])
  assert torch.equal(trainer.eval_forward(dev, pulled)['random_loss_w'],
                     before['random_loss_w'])
