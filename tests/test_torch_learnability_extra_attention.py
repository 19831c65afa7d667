"""The JAX package's extra learnability gates that need attention, run on
the port.

From `tests/test_learnability_extra.py`, at its sizes, seeds, steps,
learning rates and bars: PDN's trigger path and an MMoE's group-level
sequence attention on the label lpdn = Bern(0.85 if cate in seq_cate else
0.15); CMBF and Uniter on the cross-modal label limg, visible only by
fusing the image vector with the text's cate (a single-modality model
reads 0.5). Split from `test_torch_learnability_extra.py` to keep each
file near a minute on one worker. Data and configs:
`tests/test_torch_learnability_data.py`; the Trainer on the CPU, one torch
thread.
"""

import pytest

from tests import test_torch_learnability_data as d

GATES = ('pdn', 'group_seq_attention', 'cmbf', 'uniter')


one_thread = pytest.fixture(autouse=True, scope='module')(d.one_thread)


@pytest.mark.parametrize('name', GATES)
def test_auc_gate(name, tmp_path):
  d.check_extra_auc_gate(tmp_path, name)
