"""The JAX package's two-tower and metric-learning learnability gates, run
on the port.

From `tests/test_learnability_extra.py`, at its sizes, seeds, steps,
learning rates and bars: the two-tower label ltwr = Bern(sigmoid(2.8 *
s_u[uid] * s_i[iid])), learnable only through a user x item interaction,
for DSSM (pointwise), MultiTowerRecall, DropoutNet and RocketLaunching's
light net, and as session pairs for CoMetricLearningI2I; the regression
target yreg for DSSM's L2 loss; DAT's in-batch recall@5 on a preference
generator against its ceiling. The file's attention gates are in
`test_torch_learnability_extra_attention.py`. Data and configs:
`tests/test_torch_learnability_data.py`; the Trainer on the CPU, one torch
thread.
"""

import pytest

from tests import test_torch_learnability_data as d

GATES = ('dssm_pointwise', 'multi_tower_recall', 'dropoutnet',
         'rocket_launching', 'cml_i2i')


one_thread = pytest.fixture(autouse=True, scope='module')(d.one_thread)


@pytest.mark.parametrize('name', GATES)
def test_auc_gate(name, tmp_path):
  d.check_extra_auc_gate(tmp_path, name)


def test_dssm_l2_regression_learned(tmp_path):
  # the mean predictor's mse is about 4.1, the Bayes mse 0.09 (the noise)
  m = d.run_gate(d.extra_config(
      tmp_path, d.DSSM_REG, 'yreg',
      metrics='metrics_set { mean_squared_error {} }'))[0]
  assert m['mean_squared_error'] < 1.0, \
      'DSSM L2 gate: mse=%.3f (mean-predictor ~4.1, bayes 0.09)' % \
      m['mean_squared_error']


def test_dat_recall_learned(tmp_path):
  """DAT's in-batch softmax recall@5 within 0.06 of the true scorer's
  recall under the same metric (random floor 5/128)."""
  m = d.run_gate(d.dat_config(tmp_path))[0]
  ceiling = d.bayes_inbatch_recall()
  assert m['recall@5'] > ceiling - 0.06, \
      'DAT recall gate: %.4f < ceiling %.4f - 0.06' % (m['recall@5'],
                                                       ceiling)
