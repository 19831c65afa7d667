"""The JAX-free copy of the learnability gates' data is the JAX gates' own.

`tests/test_torch_learnability_data.py` copies the generators, Bayes bars,
margins and configs of `tests/test_learnability.py` and
`tests/test_learnability_extra.py`, because `chip_smoke.py` runs the gates
on a machine without JAX. Each generator here writes files byte-equal to
the original's at the gates' seeds and sizes, and each Bayes number equals
the original's to the last bit. The DeepFM gate, which only the port's
tests add, is held on the JAX Trainer too.
"""

import filecmp

import pytest

from tests import test_learnability as jl
from tests import test_learnability_extra as jx
from tests import test_torch_learnability_data as d

# (copy, original, (rows, seed) of every file the gates write)
GENERATORS = {
    'make_csv': (d.make_csv, jl.make_csv, ((16384, 5), (4096, 6))),
    'make_mind_csv': (d.make_mind_csv, jl.make_mind_csv,
                      ((16384, 21), (2048, 22))),
    'make_extra_csv': (d.make_extra_csv, jx.make_csv,
                       ((16384, 11), (4096, 12))),
    'make_pref_csv': (d.make_pref_csv, jx.make_pref_csv,
                      ((16384, 31), (2048, 32))),
}


@pytest.mark.parametrize('name', sorted(GENERATORS))
def test_generator_writes_the_original_bytes(name, tmp_path):
  copy, original, files = GENERATORS[name]
  for n, seed in files:
    ours, theirs = tmp_path / ('ours_%d.csv' % seed), \
        tmp_path / ('theirs_%d.csv' % seed)
    copy(str(ours), n, seed)
    original(str(theirs), n, seed)
    assert filecmp.cmp(ours, theirs, shallow=False), (name, n, seed)
    assert ours.stat().st_size > 0


def test_bayes_numbers_equal_the_original(tmp_path):
  assert d.BAYES == jl.BAYES
  assert d.bayes_aucs() == jl.bayes_aucs()
  assert d.X_BAYES == jx.BAYES
  assert d.x_bayes() == jx.bayes()
  assert d.bayes_inbatch_recall() == jx.bayes_inbatch_recall()
  evalp = str(tmp_path / 'mind_eval.csv')
  jl.make_mind_csv(evalp, 2048, seed=22)
  assert d._mind_bayes_recall5(evalp) == jl._mind_bayes_recall5(evalp)


def test_margins_and_configs_equal_the_original():
  assert d.MARGIN == jl.MARGIN
  assert d.X_MARGIN == jx.MARGIN
  for name in ('CONFIG', 'AUC_METRIC', 'RANK_GROUPS', 'RANK_BODIES',
               'SEQ_BODIES', 'MT_GROUPS', 'MT_TOWERS', 'MT_BODIES',
               'ESMM_BODY', 'MIND_CONFIG'):
    assert getattr(d, name) == getattr(jl, name), name
  for ours, theirs in (('EXTRA_CONFIG', 'CONFIG'), ('UI_GROUPS',) * 2,
                       ('MM_GROUPS',) * 2, ('DSSM_POINTWISE',) * 2,
                       ('DSSM_REG',) * 2, ('MULTI_TOWER_RECALL',) * 2,
                       ('DROPOUTNET',) * 2, ('PDN_BODY',) * 2,
                       ('ROCKET',) * 2, ('CMBF_BODY',) * 2,
                       ('UNITER_BODY',) * 2, ('CML_BODY',) * 2,
                       ('DAT_CONFIG',) * 2, ('GROUP_SEQ_MMOE',) * 2):
    assert getattr(d, ours) == getattr(jx, theirs), ours


def test_deepfm_gate_on_the_jax_package(tmp_path):
  """The DeepFM gate, which the JAX package does not have, held on the
  JAX Trainer to the bar the port's test_deepfm_interaction_learned
  holds, on the same files and config."""
  from easyrec_tpu.config import get_configs_from_pipeline_file
  from easyrec_tpu.train.trainer import Trainer
  cfg = get_configs_from_pipeline_file(
      d.gate_config(tmp_path, d.DEEPFM_BODY, ['lint']))
  m = Trainer(cfg).fit(checkpoint=False)['eval_metrics']
  bar = d.BAYES['lint'] - d.MARGIN['rank']
  assert m['auc'] > bar, 'JAX DeepFM gate: auc=%.4f < %.4f' % (m['auc'], bar)
