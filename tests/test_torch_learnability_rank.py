"""The JAX package's rank learnability gates, run on the port.

`tests/test_learnability.py`'s 8 rank gates and its bf16 gate, at the JAX
gates' sizes, seeds, steps, learning rate and bars: each model trains on
the structured `lint` label, Bern(sigmoid(2.8 * s_i[iid] * s_c[cate])),
learnable only through an interaction of id embeddings, and its eval AUC
must clear the Bayes AUC less 0.03. Beside them, the DeepFM at the gates'
size (which the JAX package does not gate) and a bf16 gate on it that
fails a port which ignores compute_dtype. The data, bars and configs are
`tests/test_torch_learnability_data.py`'s JAX-free copy; the Trainer runs
on the CPU, one torch thread.
"""

import pytest
import torch

from tests import test_torch_learnability_data as d

BAR = d.BAYES['lint'] - d.MARGIN['rank']


one_thread = pytest.fixture(autouse=True, scope='module')(d.one_thread)


@pytest.fixture(scope='module')
def deepfm_f32(tmp_path_factory):
  """The DeepFM gate's run at f32, shared by its gate and the bf16 one."""
  return d.run_gate(d.gate_config(tmp_path_factory.mktemp('deepfm'),
                                  d.DEEPFM_BODY, ['lint']))[0]


@pytest.mark.parametrize('name', sorted(d.RANK_BODIES),
                         ids=sorted(d.RANK_BODIES))
def test_rank_interaction_learned(name, tmp_path):
  m = d.run_gate(d.gate_config(tmp_path, d.RANK_BODIES[name], ['lint']))[0]
  assert m['auc'] > BAR, \
      '%s interaction gate: auc=%.4f < bayes %.4f - %.2f' % (
          name, m['auc'], d.BAYES['lint'], d.MARGIN['rank'])


def test_bfloat16_compute_quality_fm(tmp_path):
  """The JAX gate's own form: FM under compute_dtype bfloat16 clears the
  interaction bar. FM has no DNN, and compute_dtype reaches only the
  DNNs, in the port as in the JAX package: this gate exercises no bf16
  (its AUC and loss equal the f32 run's). `test_bfloat16_deepfm` is the
  gate of the mixed-precision path."""
  path = d.gate_config(tmp_path, d.RANK_BODIES['FM'], ['lint'], bf16=True)
  m, trainer, _, _ = d.run_gate(path)
  assert trainer.train_config.compute_dtype == 'bfloat16'
  assert m['auc'] > BAR, 'bf16 interaction gate: auc=%.4f < %.4f' % (
      m['auc'], BAR)


def test_deepfm_interaction_learned(deepfm_f32):
  assert deepfm_f32['auc'] > BAR, \
      'DeepFM interaction gate: auc=%.4f < bayes %.4f - %.2f' % (
          deepfm_f32['auc'], d.BAYES['lint'], d.MARGIN['rank'])


def test_bfloat16_deepfm(deepfm_f32, tmp_path):
  """The DeepFM under compute_dtype bfloat16 (its DNN and final DNN in
  bf16, parameters and optimizer in f32) clears the same bar, and its eval
  loss is not the f32 run's: a port that ignored compute_dtype would read
  the f32 loss to the last bit."""
  path = d.gate_config(tmp_path, d.DEEPFM_BODY, ['lint'], bf16=True)
  m, trainer, _, _ = d.run_gate(path)
  assert trainer.ctx.compute_dtype == torch.bfloat16
  assert m['auc'] > BAR, 'bf16 DeepFM gate: auc=%.4f < %.4f' % (
      m['auc'], BAR)
  assert m['loss'] != deepfm_f32['loss'], \
      'bf16 DeepFM read the f32 eval loss %r: compute_dtype ignored' % (
          m['loss'],)
