"""The rest of the rank zoo against the JAX package on the CPU: CMBF and
Uniter (models/rank_extra.py) and DBMTL's bottom_cmbf and bottom_uniter,
the ranking losses (pairwise, JRC, ZILN, listwise) with their dispatch
and predictions, the metrics accuracy, precision, recall, gauc and
session_auc, the bf16 compute_dtype, freeze_gradient and the schedules.
The samples run with their own features, hash buckets cut to 1,000 and
batch 32 (tests/test_torch_match.py's cut), the attention under
EASYREC_ATTN_IMPL=stock and Uniter's dropouts at 0 (torch cannot draw
flax's masks). Inputs are made from a seed with numpy."""


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
from easyrec_torch.losses import losses as t_losses
from easyrec_torch.metrics import metrics as t_metrics
from easyrec_torch.models import base as t_base
from easyrec_torch.ops import embedding as t_emb
from easyrec_torch.optim.schedules import build_schedule as t_schedule
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.features import feature_spec as j_fs
from easyrec_tpu.losses import losses as j_losses
from easyrec_tpu.metrics import metrics as j_metrics
from easyrec_tpu.models import base as j_base
from easyrec_tpu.models import zoo  # noqa: F401 (registers)
from tests.test_torch_match import jax_batches, sample_configs

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULP = 2.0 ** -7
LR_SUM = 3 * 0.001           # the samples' constant Adam rate, 3 steps

FUSION = ['cmbf', 'cmbf_image_only', 'cmbf_multi_loss', 'cmbf_text_only',
          'uniter', 'uniter_image_only', 'uniter_text_only', 'dbmtl_cmbf',
          'dbmtl_uniter']
RANK = ['losses_pairwise', 'deepfm_ziln', 'deepfm_multi_cls',
        'gauc_session_metrics', 'multi_optimizer_freeze', 'deepfm_bf16']


def no_dropout(text):
  """Uniter's towers at dropout 0 (UniterTower's defaults are 0.1)."""
  zero = 'hidden_dropout_prob: 0.0 attention_probs_dropout_prob: 0.0'
  return text.replace('uniter {\n    config {',
                      'uniter {\n    config {\n      ' + zero) \
      .replace('bottom_uniter {', 'bottom_uniter {\n      ' + zero)


def _torch(batch):
  return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          batch.items()}


def _np(x):
  return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
      else np.asarray(x).astype(np.float32)


def _close(got, want, what):
  np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **TOL)


# ---------------------------------------------------------------------------
# the models' forward from one set of flax variables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('name', FUSION + RANK)
def test_forward_matches_jax(name, tmp_path, monkeypatch):
  """The sample's model on both sides (the trainers' compute dtype) from
  the same perturbed flax variables, convert.flax_names equal to the flax
  tree key for key: every output, loss term and shared metric input in
  train mode, BatchNorm's statistics, every output in eval mode, the
  serving outputs' names, within 1e-5. deepfm_bf16 too: on these inputs
  no f32 sum of the two sides straddles a bf16 rounding boundary, so
  they agree to f32 rounding (its control, the port at f32, fails here:
  tests/test_torch_rank_extra_train.py)."""
  forward_against_jax(name, tmp_path, monkeypatch)


def forward_against_jax(name, tmp_path, monkeypatch, port_dtype=None):
  """test_forward_matches_jax's checks, the port's model in `port_dtype`
  where given, else in its trainer's compute dtype."""
  monkeypatch.setenv('EASYREC_ATTN_IMPL', 'stock')
  t_cfg, j_cfg = sample_configs(name, str(tmp_path), no_dropout)
  bf16 = t_cfg.train_config.compute_dtype == 'bfloat16'
  t_specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  j_specs = j_fs.build_feature_specs(j_config.get_feature_configs(j_cfg))
  t_ctx = t_base.build_context(
      t_cfg, t_specs, port_dtype or t_base.compute_dtype(t_cfg.train_config))
  j_ctx = j_base.build_context(
      j_cfg, j_specs, compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
  j_model = j_base.create_model(j_ctx)
  module = j_model.make_module()
  t_model = t_base.create_model(t_ctx, generator=torch.Generator()
                                .manual_seed(0))
  t_dnn.set_generator(t_model, torch.Generator().manual_seed(0))
  batch = jax_batches(j_cfg, 1)[0]
  packs = t_emb.pack_all_views(t_ctx.layout, _torch(batch))
  rng = np.random.default_rng(2)
  pulled = {k: rng.standard_normal(
      tuple(p.shape) + (t_ctx.layout.tables[k].dim,)).astype(np.float32)
            for k, p in packs.items()}
  key = jax.random.PRNGKey(0)
  variables = module.init({'params': key, 'dropout': key}, batch, pulled,
                          False)
  variables = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * rng.random(np.shape(a)).astype(
          np.float32), variables)
  root = t_model.flax_root
  sd = convert.flax_to_state_dict(variables['params'],
                                  variables.get('batch_stats'), root=root)
  assert sorted(sd) == sorted(t_model.state_dict()), (
      sorted(set(sd) ^ set(t_model.state_dict())))
  t_model.load_state_dict(sd)
  names = {path for _, path in convert.flax_names(
      t_model.state_dict(), root).values()}
  flat = {'/'.join(str(k.key) for k in path) for section in
          ('params', 'batch_stats') for path, _ in
          jax.tree_util.tree_leaves_with_path(variables.get(section, {}))}
  assert names == flat
  want, mutated = module.apply(variables, batch, pulled, True,
                               mutable=['batch_stats'],
                               rngs={'dropout': key})
  t_model.train()
  tb, tp = _torch(batch), _torch(pulled)
  got = t_model(tb, tp)
  assert sorted(got) == sorted(want)
  for k in want:
    _close(got[k], want[k], k)
  j_total, j_terms = j_model.build_loss(want, batch)
  t_total, t_terms = t_model.build_loss(got, tb)
  assert sorted(t_terms) == sorted(j_terms)
  for k in j_terms:
    _close(t_terms[k], j_terms[k], k)
  _close(t_total, j_total, 'total')
  j_mi = j_model.metric_inputs(want, batch)
  t_mi = t_model.metric_inputs(got, tb)
  for k in t_mi:
    if t_mi[k] is not None:
      _close(t_mi[k], j_mi[k], 'metric input ' + k)
  variables = dict(variables)
  if 'batch_stats' in mutated:
    variables['batch_stats'] = mutated['batch_stats']
  want_eval = module.apply(variables, batch, pulled, False)
  t_model.eval()
  got_eval = t_model(tb, tp)
  for k in want_eval:
    _close(got_eval[k], want_eval[k], 'eval ' + k)
  assert sorted(t_model.export_outputs(got_eval)) == \
      sorted(j_model.export_outputs(want_eval))


# ---------------------------------------------------------------------------
# the ranking losses, their dispatch and the predictions
# ---------------------------------------------------------------------------


def _loss_inputs(seed, n=24):
  rng = np.random.default_rng(seed)
  return (rng.integers(0, 3, n).astype(np.float32),
          rng.standard_normal(n).astype(np.float32),
          np.where(rng.random(n) < 0.2, 0.0, rng.random(n) + 0.5)
          .astype(np.float32),
          rng.integers(0, 4, n).astype(np.int64))


# name -> (loss, its keyword arguments, whether it takes session ids)
PAIRWISE_CASES = {
    'pair': ('pairwise_loss', dict(margin=0.3, temperature=0.7)),
    'pair_ohem': ('pairwise_loss', dict(ohem_ratio=0.5)),
    'logistic': ('pairwise_logistic_loss', dict(temperature=2.0)),
    'logistic_hinge': ('pairwise_logistic_loss',
                       dict(hinge_margin=0.5, ohem_ratio=0.6)),
    'focal': ('pairwise_focal_loss', dict(gamma=1.5, alpha=0.3,
                                          hinge_margin=0.8)),
    'focal_ohem': ('pairwise_focal_loss', dict(ohem_ratio=0.4)),
    'hinge': ('pairwise_hinge_loss', dict(temperature=0.5)),
    'hinge_margin_exp': ('pairwise_hinge_loss',
                         dict(use_label_margin=False, use_exponent=True,
                              margin=0.7, label_is_logits=False)),
}


@pytest.mark.parametrize('sessions', [False, True])
@pytest.mark.parametrize('case', sorted(PAIRWISE_CASES))
def test_pairwise_losses_match_jax(case, sessions):
  """Each pairwise loss and its gradient in the logits, with and without
  session ids, within 2e-5."""
  fn, kw = PAIRWISE_CASES[case]
  labels, logits, weights, sess = _loss_inputs(1)
  kw = dict(kw, session_ids=sess if sessions else None)
  want = getattr(j_losses, fn)(labels, logits, weights, **kw)
  j_grad = jax.grad(lambda x: getattr(j_losses, fn)(labels, x, weights,
                                                    **kw))(logits)
  x = torch.from_numpy(logits).requires_grad_()
  t_kw = dict(kw, session_ids=torch.from_numpy(sess) if sessions else None)
  got = getattr(t_losses, fn)(torch.from_numpy(labels), x,
                              torch.from_numpy(weights), **t_kw)
  got.backward()
  np.testing.assert_allclose(float(got.detach()), float(want), rtol=2e-5,
                             atol=1e-7)
  np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), rtol=2e-5,
                             atol=1e-7)


LIST_CASES = {
    'jrc': ('jrc_loss', dict(alpha=0.3)),
    'jrc_no_same_label': ('jrc_loss', dict(same_label_loss=False)),
    'ziln': ('ziln_loss', dict(mu_regularization=0.01,
                               sigma_regularization=0.02, max_sigma=3.0)),
    'ziln_weights': ('ziln_loss', dict(classification_weight=0.5,
                                       regression_weight=2.0)),
    'listwise': ('listwise_rank_loss', dict(temperature=0.5)),
    'listwise_logits': ('listwise_rank_loss', dict(label_is_logits=True)),
    'listwise_transform': ('listwise_rank_loss',
                           dict(transform_fn='tf.math.log1p')),
    'distill': ('listwise_distill_loss', dict(label_clip_max_value=64.0)),
    'distill_transform': ('listwise_distill_loss',
                          dict(transform_fn='numpy.sqrt', temperature=2.0)),
}


@pytest.mark.parametrize('case', sorted(LIST_CASES))
def test_list_losses_match_jax(case):
  """JRC (logits [B, 2], sessions), ZILN (logits [B, 3], positive labels
  some of them zero) and the listwise losses (positions for the distill
  loss), each and its gradient within 2e-5."""
  fn, kw = LIST_CASES[case]
  labels, logits, weights, sess = _loss_inputs(2)
  rng = np.random.default_rng(3)
  if fn == 'jrc_loss':
    labels = (labels > 0).astype(np.float32)
    logits = rng.standard_normal((len(labels), 2)).astype(np.float32)
  elif fn == 'ziln_loss':
    labels = labels * rng.random(len(labels)).astype(np.float32) * 20.0
    logits = rng.standard_normal((len(labels), 3)).astype(np.float32)
  elif fn == 'listwise_distill_loss':
    labels = rng.integers(1, 100, len(labels)).astype(np.float32)
  session = fn in ('jrc_loss', 'listwise_rank_loss',
                   'listwise_distill_loss')

  def j_fn(x):
    args = (labels, x, sess, weights) if session else (labels, x, weights)
    return getattr(j_losses, fn)(*args, **kw)

  x = torch.from_numpy(logits).requires_grad_()
  t_args = (torch.from_numpy(labels), x, torch.from_numpy(sess),
            torch.from_numpy(weights)) if session else \
      (torch.from_numpy(labels), x, torch.from_numpy(weights))
  got = getattr(t_losses, fn)(*t_args, **kw)
  got.backward()
  np.testing.assert_allclose(float(got.detach()), float(j_fn(logits)),
                             rtol=2e-5,
                             atol=1e-7)
  np.testing.assert_allclose(x.grad.numpy(), np.asarray(jax.grad(j_fn)(
      logits)), rtol=2e-5, atol=1e-7)


RANK_MODEL = '''
model_config {
  model_class: "DeepFM"
  feature_groups { group_name: "deep" feature_names: "a" wide_deep: DEEP }
  %s
}
'''

# loss block -> the batch's extra fields
DISPATCH = {
    'L2_LOSS': ('loss_type: L2_LOSS', {}),
    'SIGMOID_L2_LOSS': ('loss_type: SIGMOID_L2_LOSS', {}),
    'multi_class': ('num_class: 3', {}),
    'JRC_LOSS': ('loss_type: JRC_LOSS losses { loss_type: JRC_LOSS '
                 'jrc_loss { session_name: "s" alpha: 0.4 } }', {'s'}),
    'ZILN_LOSS': ('loss_type: ZILN_LOSS num_class: 3', {}),
    'ZILN_params': ('loss_type: ZILN_LOSS losses { loss_type: ZILN_LOSS '
                    'ziln_loss { max_sigma: 2.0 } }', {}),
    'pairwise_terms': (
        'losses { loss_type: PAIR_WISE_LOSS pairwise_loss { margin: 0.2 } } '
        'losses { loss_type: PAIRWISE_FOCAL_LOSS weight: 0.5 '
        'pairwise_focal_loss { session_name: "s" alpha: 0.25 } } '
        'losses { loss_type: PAIRWISE_HINGE_LOSS pairwise_hinge_loss { '
        'session_name: "s" } } losses { loss_type: PAIRWISE_LOGISTIC_LOSS '
        'pairwise_logistic_loss { hinge_margin: 1.5 } } '
        'loss_weight_strategy: Uncertainty', {'s'}),
    'listwise_terms': (
        'losses { loss_type: LISTWISE_RANK_LOSS listwise_rank_loss { '
        'session_name: "s" temperature: 0.5 } } losses { loss_type: '
        'LISTWISE_DISTILL_LOSS listwise_distill_loss { session_name: "s" } '
        '}', {'s'}),
    'kd_listwise_distill': (
        'kd { loss_name: "ld" soft_label_name: "t" pred_is_logits: true '
        'label_is_logits: false loss_type: LISTWISE_DISTILL_LOSS '
        'temperature: 2.0 listwise_distill_loss { session_name: "s" } } '
        'kd { soft_label_name: "t" label_is_logits: false loss_type: '
        'LISTWISE_DISTILL_LOSS }', {'s', 't'}),
}


class _Ctx:
  label_fields = ['label']


def _bare(cls, module, config):
  model = cls.__new__(cls)
  if module:
    torch.nn.Module.__init__(model)
  model.config = config
  model.ctx = _Ctx
  return model


@pytest.mark.parametrize('case', sorted(DISPATCH))
def test_rank_loss_dispatch_and_prediction_match_jax(case):
  """RankModel's prediction of each loss type (sigmoid, softmax and its
  argmax, JRC's softmax, ZILN's probability and expected value, the L2
  types' y) and build_loss over the terms, with session ids from the
  batch's fields, Uncertainty weights and kd's listwise distill term
  (its session field, and one session for the batch where it names
  none), against the JAX RankModel within 2e-5; check_ported accepts
  each."""
  block, fields = DISPATCH[case]
  text = RANK_MODEL % block
  t_mc = t_text.parse(text, 'EasyRecConfig').model_config
  j_mc = j_config.get_configs_from_pipeline_str(text).model_config
  t_model = _bare(t_base.RankModel, True, t_mc)
  j_model = _bare(j_base.RankModel, False, j_mc)
  n = 24
  labels, _, weights, sess = _loss_inputs(4, n)
  rng = np.random.default_rng(5)
  if 'ZILN' in case:
    labels = labels * rng.random(n).astype(np.float32) * 5.0
  if case == 'multi_class':
    labels = rng.integers(0, 3, n).astype(np.float32)
  if case == 'JRC_LOSS':
    labels = (labels > 0).astype(np.float32)
  logits = rng.standard_normal((n, j_model.logits_dim())).astype(np.float32)
  assert t_model.logits_dim() == j_model.logits_dim()
  batch = {'label.label': labels, 'sample_weight': weights}
  if 's' in fields:
    batch['field.s'] = sess
  if 't' in fields:
    batch['field.t'] = rng.random(n).astype(np.float32)
  want = j_model._prediction(jnp.asarray(logits))
  got = t_model.prediction(torch.from_numpy(logits))
  assert sorted(got) == sorted(want)
  for k in want:
    _close(got[k], want[k], k)
  n_terms = max(len(j_mc.losses), 1) + len(j_mc.kd)
  if j_mc.loss_weight_strategy == 1:            # Uncertainty
    u = rng.standard_normal(n_terms).astype(np.float32)
    want['uncertainty_w'], got['uncertainty_w'] = u, torch.from_numpy(u)
  j_total, j_terms = j_model.build_loss(want, batch)
  t_total, t_terms = t_model.build_loss(got, _torch(batch))
  assert list(t_terms) == list(j_terms)
  for k in j_terms:
    np.testing.assert_allclose(float(t_terms[k]), float(j_terms[k]),
                               rtol=2e-5, atol=1e-7, err_msg=k)
  np.testing.assert_allclose(float(t_total), float(j_total), rtol=2e-5)


def test_check_ported_refuses_shapes_the_reference_fails_on():
  """A ZILN or JRC term under a model of one logit, a binary term under
  num_class > 1, and a pairwise model of several classes are refused by
  name; SIGMOID_L2_LOSS as a term stays refused."""
  base = '''
train_input_path: "x"
data_config { input_fields { input_name: "label" input_type: FLOAT }
              label_fields: "label" }
''' + RANK_MODEL
  for block, part in (
      ('losses { loss_type: ZILN_LOSS }', 'ZILN_LOSS of model_config'),
      ('losses { loss_type: JRC_LOSS }', 'JRC_LOSS of model_config'),
      ('num_class: 3 losses { loss_type: BINARY_FOCAL_LOSS }',
       'BINARY_FOCAL_LOSS of model_config'),
      ('num_class: 2 loss_type: PAIR_WISE_LOSS',
       'PAIR_WISE_LOSS with num_class 2'),
      ('losses { loss_type: SIGMOID_L2_LOSS }', 'SIGMOID_L2_LOSS'),
      ('loss_type: ZILN_LOSS losses { loss_type: CLASSIFICATION }',
       'CLASSIFICATION of model_config')):
    with pytest.raises(NotImplementedError, match=part):
      t_config.check_ported(t_config.get_configs_from_pipeline_str(
          base % block))
  for block in ('num_class: 4', 'loss_type: ZILN_LOSS num_class: 3',
                'loss_type: LISTWISE_RANK_LOSS', 'loss_type: L2_LOSS'):
    t_config.check_ported(t_config.get_configs_from_pipeline_str(
        base % block))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


METRICS = '''
eval_config {
  metrics_set { auc {} } metrics_set { accuracy {} }
  metrics_set { precision {} } metrics_set { recall {} }
  metrics_set { gauc { uid_field: "u" } }
  metrics_set { gauc { uid_field: "u" reduction: "mean_by_sample_num" } }
  metrics_set { session_auc { session_id_field: "s"
                              reduction: "mean_by_positive_num" } }
}
'''


@pytest.mark.parametrize('multi_class', [False, True])
def test_metrics_match_jax(multi_class):
  """accuracy (a probability at 0.5, or a class id), precision and recall
  at 0.5, gauc and session_auc with each reduction, over three batches
  with zero-weight rows, against the JAX MetricsCollection (its device
  states and GroupedMetricBuffer) within 1e-6."""
  t_ec = t_text.parse(METRICS, 'EasyRecConfig').eval_config
  j_ec = j_config.get_configs_from_pipeline_str(METRICS).eval_config
  t_col = t_metrics.MetricsCollection(t_ec.metrics_set)
  j_col = j_metrics.MetricsCollection(j_ec.metrics_set)
  assert t_col.host_fields == sorted(j_col.host_fields) == ['s', 'u']
  rng = np.random.default_rng(7)
  t_states = t_col.init_states(torch.device('cpu'))
  j_states = j_col.init_states()
  t_bufs, j_bufs = t_col.init_host_buffers(), {
      f: j_metrics.GroupedMetricBuffer() for f in j_col.host_fields}
  for _ in range(3):
    n = 64
    labels = rng.integers(0, 2, n).astype(np.float32)
    probs = np.clip(labels * 0.3 + rng.random(n) * 0.7, 0, 1).astype(
        np.float32)
    preds = rng.integers(0, 2, n).astype(np.int64) if multi_class \
        else probs
    weights = np.where(rng.random(n) < 0.1, 0.0, 1.0).astype(np.float32)
    ids = {'u': rng.integers(0, 6, n), 's': rng.integers(0, 4, n)}
    j_states = j_col.update_states(j_states, labels, probs, preds, weights)
    t_col.update_states(t_states, torch.from_numpy(labels),
                        torch.from_numpy(probs), torch.from_numpy(weights),
                        preds=torch.from_numpy(preds))
    w = weights > 0
    for f in ('u', 's'):
      j_bufs[f].add(ids[f][w], labels[w], probs[w])
      t_bufs[f].add(ids[f][w], labels[w], probs[w])
  want = j_col.results(j_states, j_bufs)
  got = t_col.results(t_states, t_bufs)
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
  assert t_col.results(t_states) == {k: v for k, v in got.items()
                                     if k not in ('gauc', 'session_auc')}


def test_grouped_buffer_compacts_like_jax():
  """Past its row bound the buffer turns into per-group histograms, as
  the JAX buffer does, and both report the same bucketized AUC."""
  rng = np.random.default_rng(9)
  t_buf = t_metrics.GroupedMetricBuffer(max_rows=100, bins=32)
  j_buf = j_metrics.GroupedMetricBuffer(max_rows=100, bins=32)
  for _ in range(4):
    uids = rng.integers(0, 5, 40)
    labels = rng.integers(0, 2, 40)
    probs = rng.random(40)
    t_buf.add(uids, labels, probs)
    j_buf.add(uids, labels, probs)
  assert t_buf.histogram_mode and j_buf.histogram_mode
  for reduction in ('mean', 'mean_by_sample_num', 'mean_by_positive_num'):
    assert t_buf.result(reduction) == j_buf.result(reduction)
  assert t_metrics.grouped_auc(uids, labels, probs) == \
      j_metrics.grouped_auc(uids, labels, probs)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


SCHEDULES = {
    'cosine': 'cosine_decay_learning_rate { learning_rate_base: 0.01 '
              'total_steps: 1000 warmup_learning_rate: 0.001 '
              'warmup_steps: 100 hold_base_rate_steps: 50 }',
    'cosine_defaults': 'cosine_decay_learning_rate { total_steps: 300 '
                       'warmup_steps: 0 }',
    'manual_step': 'manual_step_learning_rate { initial_learning_rate: 0.01 '
                   'schedule { step: 100 learning_rate: 0.005 } '
                   'schedule { step: 300 learning_rate: 0.001 } }',
    'manual_step_warmup': 'manual_step_learning_rate { '
                          'initial_learning_rate: 0.0 schedule { step: 150 '
                          'learning_rate: 0.004 } warmup: true }',
    'poly': 'poly_decay_learning_rate { learning_rate_base: 0.01 '
            'total_steps: 500 power: 2.0 end_learning_rate: 0.0001 }',
    'transformer': 'transformer_learning_rate { learning_rate_base: 2.0 '
                   'hidden_size: 64 warmup_steps: 100 '
                   'step_scaling_rate: 0.5 }',
}


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedules_match_jax(name):
  """Each schedule on the device's step tensor within 1e-7 of the JAX
  schedule, at steps across its warmup, hold, boundaries and end."""
  from google.protobuf import text_format
  from easyrec_tpu.optim.schedules import build_schedule as j_schedule
  from easyrec_tpu.protos import train_pb2
  text = SCHEDULES[name]
  t_fn = t_schedule(t_text.parse(text, 'LearningRate'))
  j_fn = j_schedule(text_format.Parse(text, train_pb2.LearningRate()))
  for step in (0, 1, 49, 50, 99, 100, 101, 149, 150, 151, 299, 300, 301,
               499, 500, 999, 1000, 5000):
    got = float(t_fn(torch.tensor(step, dtype=torch.int32)))
    want = float(j_fn(jnp.asarray(step, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7,
                               err_msg='step %d' % step)
