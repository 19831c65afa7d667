"""The JAX package's multi-task learnability gates, run on the port.

From `tests/test_learnability.py`, at its sizes, seeds, steps, learning
rate and bars: MMoE, PLE, SimpleMultiTask and DBMTL each learn two
independent per-task signals, lctr = Bern(sigmoid(2.2 * s_u[uid])) and
lcvr = Bern(sigmoid(2.2 * s_k[cate])), every tower's AUC within 0.03 of
its Bayes AUC; ESMM's cvr tower, supervised through pCTR * pCVR, within
0.08. Data and configs: `tests/test_torch_learnability_data.py`; the
Trainer on the CPU, one torch thread.
"""

import pytest

from tests import test_torch_learnability_data as d


one_thread = pytest.fixture(autouse=True, scope='module')(d.one_thread)


@pytest.mark.parametrize('name', sorted(d.MT_BODIES), ids=sorted(d.MT_BODIES))
def test_multitask_per_task_learned(name, tmp_path):
  m = d.run_gate(d.gate_config(tmp_path, d.MT_BODIES[name],
                               ['lctr', 'lcvr']))[0]
  assert m['auc_ctr'] > d.BAYES['lctr'] - d.MARGIN['mt'], \
      '%s ctr gate: auc=%.4f < bayes %.4f - %.2f' % (
          name, m['auc_ctr'], d.BAYES['lctr'], d.MARGIN['mt'])
  assert m['auc_cvr'] > d.BAYES['lcvr'] - d.MARGIN['mt'], \
      '%s cvr gate: auc=%.4f < bayes %.4f - %.2f' % (
          name, m['auc_cvr'], d.BAYES['lcvr'], d.MARGIN['mt'])


def test_esmm_per_task_learned(tmp_path):
  m = d.run_gate(d.gate_config(tmp_path, d.ESMM_BODY, ['lctr', 'lcvr']))[0]
  assert m['auc_ctr'] > d.BAYES['lctr'] - d.MARGIN['mt'], \
      'esmm ctr gate: auc=%.4f' % m['auc_ctr']
  # the cvr tower is supervised through pCTR*pCVR (a biased objective)
  # and cannot reach the plain-cvr Bayes bound: a wider margin
  assert m['auc_cvr'] > d.BAYES['lcvr'] - d.MARGIN['esmm_cvr'], \
      'esmm cvr gate: auc=%.4f' % m['auc_cvr']
