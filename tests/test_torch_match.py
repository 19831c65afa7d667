"""The match family of the port (easyrec_torch/models/match.py,
match_extra.py, the backbone MatchModel, layers/capsule.py, the match
losses and metrics, and the kd terms) against the JAX package on the CPU:
each sample model's forward in train and eval mode, its loss terms and
metric inputs from one set of flax weights carried across by convert.py,
on a batch of the JAX pipeline (a sampler's views in it) and random
pulled rows; MIND with the JAX routing draw handed in, DropoutNet's
preference dropout at rate 0 in train mode (torch cannot draw flax's
numbers). The samples' own features, hash buckets cut to 1,000, batch 32.
tests/test_torch_match_train.py trains them."""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyrec_torch import convert
from easyrec_torch.config import config_util as t_config
from easyrec_torch.features import feature_spec as t_fs
from easyrec_torch.layers import capsule as t_capsule
from easyrec_torch.layers import dnn as t_dnn
from easyrec_torch.losses import losses as t_losses
from easyrec_torch.metrics import metrics as t_metrics
from easyrec_torch.models import base as t_base
from easyrec_torch.models import (  # noqa: F401 (registers)
    backbone_model, match, match_extra, rank)
from easyrec_torch.ops import embedding as t_emb
from easyrec_tpu.config import config_util as j_config
from easyrec_tpu.data import input_pipeline as j_input
from easyrec_tpu.features import feature_spec as j_fs
from easyrec_tpu.layers import capsule as j_capsule
from easyrec_tpu.losses import losses as j_losses
from easyrec_tpu.metrics import metrics as j_metrics
from easyrec_tpu.models import base as j_base
from easyrec_tpu.models import zoo  # noqa: F401 (registers)
from easyrec_tpu.ops import embedding as j_emb
from tests.test_samples import _write_csv, _write_edges, _write_items

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides; matmul and reduction orders differ (XLA vs ATen)
TOL = dict(rtol=1e-5, atol=1e-5)

MATCH_SAMPLES = ['dat', 'dat_inner_simi', 'dropoutnet',
                 'dropoutnet_neg_sampler_v2', 'dssm_hard_neg_sampler',
                 'dssm_kd', 'dssm_neg_sampler', 'dssm_reg', 'dssm_senet',
                 'metric_learning_i2i', 'metric_learning_ms', 'mind',
                 'mind_neg_sampler', 'mind_time_id', 'multi_tower_recall',
                 'parallel_dssm_backbone', 'pdn', 'pdn_neg_sampler']


def _torch(batch):
  return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          batch.items()}


def cut_config(cfg, data_dir, batch_size=32, buckets=1000):
  """A sample config (either package's) cut for the CPU: hash buckets at
  most `buckets`, the batch size, the data paths under data_dir (CSV,
  items.txt, edges.txt), model_dir cleared."""
  fcs = cfg.feature_config.features if len(cfg.feature_config.features) \
      else cfg.feature_configs
  for fc in fcs:
    if fc.hash_bucket_size > buckets:
      fc.hash_bucket_size = buckets
  cfg.data_config.batch_size = batch_size
  cfg.train_input_path = cfg.eval_input_path = os.path.join(data_dir,
                                                            'train.csv')
  cfg.model_dir = ''
  which = cfg.data_config.WhichOneof('sampler')
  if which:
    s = getattr(cfg.data_config, which)
    for field in ('input_path', 'user_input_path', 'item_input_path',
                  'pos_edge_input_path', 'hard_neg_edge_input_path'):
      try:
        if getattr(s, field):
          setattr(s, field, os.path.join(
              data_dir, 'edges.txt' if 'edge' in field else 'items.txt'))
      except AttributeError:
        pass
  return cfg


def write_data(data_dir, cols, rows=256, seed=11, long_seq=False):
  """The samples' items, edges and CSV (tests/test_samples.py's writers);
  with long_seq, each seq_cate holds 40-50 categories instead of 1-5."""
  _write_items(os.path.join(data_dir, 'items.txt'))
  _write_edges(os.path.join(data_dir, 'edges.txt'))
  path = os.path.join(data_dir, 'train.csv')
  _write_csv(path, cols, rows, seed=seed)
  if long_seq and 'seq_cate' in cols:
    rng = np.random.default_rng(seed)
    j = cols.index('seq_cate')
    with open(path) as f:
      lines = [line.rstrip('\n').split(',') for line in f]
    for parts in lines:
      parts[j] = '|'.join('c%d' % c for c in rng.integers(
          0, 8, rng.integers(40, 51)))
    with open(path, 'w') as f:
      f.write(''.join(','.join(parts) + '\n' for parts in lines))


def sample_configs(name, data_dir, text_edit=None, long_seq=False, **cut):
  """(port config, JAX config) of samples/<name>.config cut as above,
  its data written."""
  with open(os.path.join(REPO, 'samples', name + '.config')) as f:
    text = f.read()
  if text_edit is not None:
    text = text_edit(text)
  t_cfg = cut_config(t_config.get_configs_from_pipeline_str(text), data_dir,
                     **cut)
  j_cfg = cut_config(j_config.get_configs_from_pipeline_str(text), data_dir,
                     **cut)
  write_data(data_dir, [f.input_name for f in j_cfg.data_config.input_fields],
             long_seq=long_seq)
  return t_cfg, j_cfg


def jax_batches(j_cfg, n, mode='train'):
  pipe = j_input.InputPipeline(
      j_cfg.data_config, j_config.get_feature_configs(j_cfg),
      j_config.get_train_input_path(j_cfg), mode=mode,
      extra_fields=j_config.collect_extra_fields(j_cfg))
  out = []
  for b in pipe:
    out.append(b)
    if len(out) == n:
      return out
  raise AssertionError('the input ended after %d batches' % len(out))


def contexts(t_cfg, j_cfg):
  t_specs = t_fs.build_feature_specs(t_config.get_feature_configs(t_cfg))
  j_specs = j_fs.build_feature_specs(j_config.get_feature_configs(j_cfg))
  return (t_base.build_context(t_cfg, t_specs),
          j_base.build_context(j_cfg, j_specs))


@contextlib.contextmanager
def capture_normal():
  """Records every jax.random.normal draw (MIND's routing logits)."""
  draws = []
  orig = jax.random.normal

  def rec(*args, **kwargs):
    out = orig(*args, **kwargs)
    draws.append(np.asarray(out))
    return out

  jax.random.normal = rec
  try:
    yield draws
  finally:
    jax.random.normal = orig


def _routing(t_model, draws):
  """Hand MIND the JAX draw (stddev x normal, in f32 as flax does)."""
  if isinstance(t_model, match.MIND):
    assert len(draws) == 1
    stddev = np.float32(t_model.capsule.routing_logits_stddev)
    t_model.routing_logits = torch.from_numpy(stddev * draws[0])
  else:
    assert not draws


def _log(x):
  return np.log(np.asarray(x))


def _exp(x):
  return np.exp(np.asarray(x))


def _close(got, want, what):
  if isinstance(got, torch.Tensor):
    got = got.detach().numpy()
  np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **TOL)


def check_forward(name, tmp_path, text_edit=None, held=None,
                  long_seq=False):
  """The sample's model on both sides from the same perturbed flax
  variables: every output, loss term and metric input in train mode,
  then every output in eval mode and the serving outputs' names.
  Returns (port model, JAX outputs, port outputs, batch) of the train
  forward."""
  t_cfg, j_cfg = sample_configs(name, str(tmp_path), text_edit, long_seq)
  t_ctx, j_ctx = contexts(t_cfg, j_cfg)
  j_model = j_base.create_model(j_ctx)
  module = j_model.make_module()
  t_model = t_base.create_model(t_ctx, generator=torch.Generator()
                                .manual_seed(0))
  t_dnn.set_generator(t_model, torch.Generator().manual_seed(0))
  batch = jax_batches(j_cfg, 1)[0]
  t_packs = t_emb.pack_all_views(t_ctx.layout, _torch(batch))
  j_packs = j_emb.pack_all_views(j_ctx.layout, batch)
  assert sorted(t_packs) == sorted(j_packs)
  for k in j_packs:
    np.testing.assert_array_equal(t_packs[k].numpy(), np.asarray(j_packs[k]))
  rng = np.random.default_rng(2)
  pulled = {k: rng.standard_normal(
      tuple(p.shape) + (t_ctx.layout.tables[t_emb.view_table(k)].dim,))
            .astype(np.float32) for k, p in t_packs.items()}
  key = jax.random.PRNGKey(0)
  variables = module.init({'params': key, 'dropout': key, 'routing': key},
                          batch, pulled, False)
  variables = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.1 * rng.random(np.shape(a)).astype(
          np.float32), variables)
  root = t_model.flax_root
  sd = convert.flax_to_state_dict(variables['params'],
                                  variables.get('batch_stats'), root=root)
  assert sorted(sd) == sorted(t_model.state_dict()), (
      sorted(set(sd) ^ set(t_model.state_dict())))
  t_model.load_state_dict(sd)
  with capture_normal() as draws:
    want, mutated = module.apply(variables, batch, pulled, True,
                                 mutable=['batch_stats', 'losses'],
                                 rngs={'dropout': key, 'routing': key})
  _routing(t_model, draws)
  t_model.train()
  tb, tp = _torch(batch), _torch(pulled)
  got = t_model(tb, tp)
  got.pop('aux_losses', None)
  assert sorted(got) == sorted(want)
  held = held or {}
  for k in want:
    if k in held:
      f = held[k]
      _close(f(got[k].detach()), f(jnp.asarray(want[k])), k)
    else:
      _close(got[k], want[k], k)
  j_total, j_losses_ = j_model.build_loss(want, batch)
  t_total, t_losses_ = t_model.build_loss(got, tb)
  kd = {}
  if t_cfg.model_config.kd and root == '':
    # the JAX match models leave kd out of their loss: the port adds the
    # JAX RankModel's terms
    kd = j_base.RankModel._kd_losses(j_model, want, batch,
                                     batch['sample_weight'])
  assert sorted(t_losses_) == sorted(list(j_losses_) + list(kd))
  for k, v in j_losses_.items():
    _close(t_losses_[k], v, k)
  for k, (v, _) in kd.items():
    _close(t_losses_[k], v, k)
  _close(t_total, j_total + sum(w * v for v, w in kd.values()), 'total')
  j_mi = j_model.metric_inputs(want, batch)
  t_mi = t_model.metric_inputs(got, tb)
  assert sorted(t_mi) == sorted(j_mi)
  for k in j_mi:
    _close(t_mi[k], j_mi[k], k)
  # eval mode, on the statistics the train forward left
  variables = dict(variables)
  if 'batch_stats' in mutated:
    variables['batch_stats'] = mutated['batch_stats']
    _, stats = convert.state_dict_to_flax(t_model.state_dict(), root)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **TOL),
        stats, dict(mutated['batch_stats']))
  with capture_normal() as draws:
    want_eval = module.apply(variables, batch, pulled, False)
  _routing(t_model, draws)
  t_model.eval()
  got_eval = t_model(tb, tp)
  got_eval.pop('aux_losses', None)
  for k in want_eval:
    if k in held:
      _close(held[k](got_eval[k].detach()), held[k](
          jnp.asarray(want_eval[k])), 'eval ' + k)
    else:
      _close(got_eval[k], want_eval[k], 'eval ' + k)
  assert sorted(t_model.export_outputs(got_eval)) == \
      sorted(j_model.export_outputs(want_eval))
  return t_model, want, got, batch


def _no_preference_dropout(text):
  return text.replace('user_dropout_rate: 0.1', 'user_dropout_rate: 0.0') \
      .replace('item_dropout_rate: 0.5', 'item_dropout_rate: 0.0')


@pytest.mark.parametrize('name', MATCH_SAMPLES)
def test_forward_matches_jax(name, tmp_path):
  edit = _no_preference_dropout if name.startswith('dropoutnet') else None
  # PDN's path scores are exponentials of its nets' outputs over every
  # step of the behaviour sequence: they are held by their logs (the
  # nets' outputs) and its logits, the log of 1 - exp(-score) whose
  # relative error grows without bound near probability 1, by the
  # probabilities; and its sequences are long (a sequence of 1-5 of 50
  # steps makes nine in ten of BatchNorm's rows one padding value, whose
  # E[x^2] - E[x]^2 variance cancels to rounding noise)
  pdn = name.startswith('pdn')
  t_model, want, got, batch = check_forward(
      name, tmp_path, edit, long_seq=pdn,
      held={'trigger_out': _log, 'sim_out': _log,
            'logits': _exp} if pdn else None)
  if name in ('dssm_neg_sampler', 'pdn_neg_sampler', 'mind_neg_sampler'):
    assert 'neg.feat.iid.ids' in batch
  if name == 'dssm_neg_sampler':
    # [B, B + N]: in-batch items, then the sampler's 1,024 negatives
    assert tuple(t_model.full_logits(got, _torch(batch)).shape) == \
        (32, 32 + 1024)
  if name == 'dssm_hard_neg_sampler':
    assert tuple(got['hard_neg_item_tower_emb'].shape) == (32 * 4, 16)
    assert float(batch['hard_neg_mask'].sum()) > 0
  if name == 'dssm_reg':
    assert sorted(t_model.export_outputs(got)) == ['item_emb', 'user_emb',
                                                   'y']
  if name == 'mind':
    assert 'capsule.bilinear' in dict(t_model.named_parameters())


def test_dropoutnet_preference_dropout_draws(tmp_path):
  """At the sample's rates the preference vectors are dropped whole, about
  a rate's share of the rows, from the model's generator: two train
  forwards from one generator seed agree (the eval forward, which drops
  nothing, is test_forward_matches_jax's)."""
  t_cfg, j_cfg = sample_configs('dropoutnet', str(tmp_path))
  t_ctx, _ = contexts(t_cfg, j_cfg)
  model = t_base.create_model(t_ctx, generator=torch.Generator()
                              .manual_seed(0))
  batch = _torch(jax_batches(j_cfg, 1)[0])
  packs = t_emb.pack_all_views(t_ctx.layout, batch)
  pulled = {k: torch.randn(tuple(p.shape) + (16,)) for k, p in packs.items()}
  outs = []
  for _ in range(2):
    t_dnn.set_generator(model, torch.Generator().manual_seed(5))
    model.train()
    outs.append(model(batch, pulled)['user_tower_emb'])
  assert torch.equal(outs[0], outs[1])
  drop = model.item_preference_drop
  assert drop.rate == 0.5
  keep = drop(torch.ones(4096, 3))
  assert 0.45 < float(keep[:, 0].mean()) < 0.55
  assert torch.equal(keep[:, 0], keep[:, 1])


def test_mind_eval_routing_is_a_fixed_draw(tmp_path):
  """In eval the capsule draws from a fresh generator seeded 11 on the
  input's device: two eval forwards agree bit for bit; with stddev 0 the
  logits start at zero in either mode."""
  t_cfg, j_cfg = sample_configs('mind', str(tmp_path))
  t_ctx, _ = contexts(t_cfg, j_cfg)
  model = t_base.create_model(t_ctx, generator=torch.Generator()
                              .manual_seed(0))
  model.eval()
  batch = _torch(jax_batches(j_cfg, 1)[0])
  packs = t_emb.pack_all_views(t_ctx.layout, batch)
  pulled = {k: torch.randn(tuple(p.shape) + (16,)) for k, p in packs.items()}
  a = model(batch, pulled)['user_tower_emb']
  b = model(batch, pulled)['user_tower_emb']
  assert torch.equal(a, b)
  want = torch.randn((3, 5, 7), generator=torch.Generator().manual_seed(11))
  assert torch.equal(model.capsule.draw_logits(3, 7, torch.device('cpu')),
                     want)


# ------------------------------------------------------------- layers


def test_capsule_layer_matches_flax():
  """Routing from the same initial logits, train and eval, with
  log2-many and constant capsule counts and a squash power."""
  rng = np.random.default_rng(0)
  seq = rng.standard_normal((8, 10, 6)).astype(np.float32)
  lens = rng.integers(1, 11, 8)
  mask = (np.arange(10)[None] < lens[:, None]).astype(np.float32)
  for const, pw in ((False, 1.0), (True, 2.0)):
    j_mod = j_capsule.CapsuleLayer(max_k=4, high_dim=5, num_iters=3,
                                   routing_logits_stddev=1.0,
                                   squash_pow=pw, const_caps_num=const)
    key = jax.random.PRNGKey(1)
    params = j_mod.init({'params': key, 'routing': key}, seq, mask)
    with capture_normal() as draws:
      want, want_mask = j_mod.apply(params, seq, mask, True,
                                    rngs={'routing': key})
    t_mod = t_capsule.CapsuleLayer(6, max_k=4, high_dim=5, num_iters=3,
                                   squash_pow=pw, const_caps_num=const)
    t_mod.load_state_dict(convert.flax_to_state_dict(params['params'],
                                                     root=None))
    got, got_mask = t_mod(torch.from_numpy(seq), torch.from_numpy(mask),
                          init_logits=torch.from_numpy(np.array(draws[0])))
    _close(got, want, 'interests')
    _close(got_mask, want_mask, 'mask')


def test_squash_matches_flax():
  x = np.random.default_rng(1).standard_normal((5, 7)).astype(np.float32)
  for pw in (1.0, 0.5):
    _close(t_capsule.squash(torch.from_numpy(x), pw),
           j_capsule.squash(x, pw), 'squash')


# ------------------------------------------------------------- losses


def test_match_losses_match_jax():
  """circle_loss, multi_similarity_loss and the negative-mining softmax,
  values and gradients, with a zero-weight row."""
  rng = np.random.default_rng(4)
  emb = rng.standard_normal((16, 8)).astype(np.float32)
  item = rng.standard_normal((16, 8)).astype(np.float32)
  labels = rng.integers(0, 4, 16).astype(np.int64)
  labels[3] = 99           # a row without a positive pair
  w = np.ones(16, np.float32)
  w[5] = 0.0
  lbl = (rng.random(16) < 0.7).astype(np.float32)
  cases = [
      (lambda e, i: t_losses.circle_loss(e, torch.from_numpy(labels),
                                         torch.from_numpy(w), 0.25, 32.0),
       lambda e, i: j_losses.circle_loss(e, labels, w, 0.25, 32.0)),
      (lambda e, i: t_losses.multi_similarity_loss(
          e, torch.from_numpy(labels), torch.from_numpy(w), 2.0, 50.0, 1.0),
       lambda e, i: j_losses.multi_similarity_loss(e, labels, w, 2.0, 50.0,
                                                   1.0)),
      (lambda e, i: t_losses.softmax_loss_with_negative_mining(
          e, i, torch.from_numpy(lbl), torch.from_numpy(w), 8, 0.1, 2.0,
          0.5),
       lambda e, i: j_losses.softmax_loss_with_negative_mining(
           e, i, lbl, w, 8, 0.1, 2.0, 0.5)),
  ]
  for t_fn, j_fn in cases:
    te = torch.from_numpy(emb).requires_grad_()
    ti = torch.from_numpy(item).requires_grad_()
    got = t_fn(te, ti)
    got.backward()
    want, (ge, gi) = jax.value_and_grad(j_fn, argnums=(0, 1))(
        jnp.asarray(emb), jnp.asarray(item))
    _close(got, want, 'loss')
    _close(te.grad, ge, 'grad emb')
    _close(ti.grad if ti.grad is not None else torch.zeros_like(ti), gi,
           'grad item')


# ------------------------------------------------------------- metrics

METRICS = '''
eval_config {
  metrics_set { recall_at_topk { topk: 5 } }
  metrics_set { recall_at_topk { topk: 1 } }
  metrics_set { precision_at_topk { topk: 5 } }
  metrics_set { mean_absolute_error {} }
  metrics_set { mean_squared_error {} }
  metrics_set { root_mean_squared_error {} }
  metrics_set { auc {} }
}
'''


@pytest.mark.parametrize('cand', ['in_batch_logits', 'neg_sam_logits'])
def test_topk_and_error_metrics_match_jax(cand):
  """recall@k and precision@k over in-batch or sampled candidates (ties
  counted as in the JAX package: only strictly higher columns rank
  above), and the three errors, over two batches."""
  t_mc = t_metrics.MetricsCollection(
      t_config.get_configs_from_pipeline_str(METRICS).eval_config
      .metrics_set)
  j_mc = j_metrics.MetricsCollection(
      j_config.get_configs_from_pipeline_str(METRICS).eval_config
      .metrics_set)
  t_states, j_states = t_mc.init_states('cpu'), j_mc.init_states()
  rng = np.random.default_rng(6)
  for _ in range(2):
    logits = rng.standard_normal((32, 40)).astype(np.float32)
    logits = np.round(logits, 1)          # ties
    if cand == 'in_batch_logits':
      logits = logits[:, :32]
    labels = (rng.random(32) < 0.8).astype(np.float32)
    probs = rng.random(32).astype(np.float32)
    preds = rng.standard_normal(32).astype(np.float32)
    w = np.ones(32, np.float32)
    w[-3:] = 0.0
    extra = {cand: logits}
    t_mc.update_states(t_states, torch.from_numpy(labels),
                       torch.from_numpy(probs), torch.from_numpy(w),
                       preds=torch.from_numpy(preds),
                       extra={cand: torch.from_numpy(logits)})
    j_states = j_mc.update_states(j_states, labels, probs, preds, w,
                                  extra=extra)
  got, want = t_mc.results(t_states), j_mc.results(j_states)
  assert sorted(got) == sorted(want) == sorted(t_mc.result_names())
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
  assert 0 < got['recall@1'] < got['recall@5'] < 1


# ------------------------------------------------------------- kd

KD = '''
train_input_path: "x"
data_config { label_fields: "label" }
model_config {
  model_class: "DSSM"
  kd { loss_name: "kl" soft_label_name: "t1" pred_name: "probs"
       pred_is_logits: false label_is_logits: false
       loss_type: KL_DIVERGENCE_LOSS temperature: 2.0 loss_weight: 0.5 }
  kd { soft_label_name: "t2" loss_type: L2_LOSS }
  kd { loss_name: "ce" soft_label_name: "label" loss_type: CROSS_ENTROPY_LOSS
       temperature: 3.0 task_space_indicator_name: "ind"
       task_space_indicator_value: "0.5" in_task_space_weight: 2.0
       out_task_space_weight: 0.25 }
}
'''


def test_kd_terms_match_jax():
  """The KL, L2 and cross-entropy kd terms, with probabilities turned to
  logits, temperatures, a soft label read from label.<name> and a
  task-space indicator field."""
  t_cfg = t_config.get_configs_from_pipeline_str(KD)
  j_cfg = j_config.get_configs_from_pipeline_str(KD)

  class Ctx:
    label_fields = ['label']

  t_model = t_base.BaseModel.__new__(t_base.BaseModel)
  torch.nn.Module.__init__(t_model)
  t_model.config = t_cfg.model_config

  class JModel:
    config = j_cfg.model_config
    ctx = Ctx

  rng = np.random.default_rng(8)
  logits = rng.standard_normal(16).astype(np.float32)
  batch = {'field.t1': rng.random(16).astype(np.float32),
           'field.t2': rng.standard_normal(16).astype(np.float32),
           'label.label': rng.random(16).astype(np.float32),
           'field.ind': rng.random(16).astype(np.float32),
           'sample_weight': np.ones(16, np.float32)}
  outputs = {'logits': logits, 'probs': 1 / (1 + np.exp(-logits))}
  want = j_base.RankModel._kd_losses(JModel, outputs, batch,
                                     batch['sample_weight'])
  got = t_model.kd_losses(_torch(outputs), _torch(batch))
  assert list(got) == list(want) == ['kl', 'kd_loss_1', 'ce']
  for k in want:
    _close(got[k][0], want[k][0], k)
    assert got[k][1] == want[k][1]


def test_kd_backbone_cross_entropy_matches_jax(tmp_path):
  """kd_backbone, a backbone RankModel: its kd CE term (the teacher
  column as field.teacher) beside the classification loss, as the JAX
  RankModel computes both."""
  _, want, got, batch = check_forward('kd_backbone', tmp_path)
  assert 'field.teacher' in batch


def test_dssm_kd_kl_term(tmp_path):
  """dssm_kd's KL term at temperature 2 (the port adds it to the DSSM's
  loss; JAX RankModel._kd_losses on the DSSM's outputs computes it)."""
  t_model, want, got, batch = check_forward('dssm_kd', tmp_path)
  terms = t_model.kd_losses(got, _torch(batch))
  assert list(terms) == ['kd_teacher_kl']
  assert terms['kd_teacher_kl'][1] == 0.5
  assert float(terms['kd_teacher_kl'][0].detach()) > 0
