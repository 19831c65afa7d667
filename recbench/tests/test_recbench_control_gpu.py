"""The control of `correct`, on the card: at a size a test run holds
(tables of at most 100,000 rows, batch 4,096), the port's own readings
stay within the cell's limits on three seeds, and the control (the port's
towers in bfloat16, the precision below the configuration's float32) and
a step over half of the batch fail at least one of them. The limits
themselves come from `python3 -m recbench.calibrate` at the cells' own
size (PERF.md). Run on a machine with the card:

    python -m pytest -m gpu recbench/tests/test_recbench_control_gpu.py
"""

import pytest
import torch

from recbench import calibrate, check, faults
from recbench.cell import load_cell
from recbench.tests.small import CELLS

pytestmark = pytest.mark.gpu

SIZE = {'batch_size': 4096, 'rows': 100000}


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU: torch.cuda.is_available() is False')
  return torch.device('cuda')


@pytest.mark.parametrize('workload', CELLS)
def test_control_and_fault_fail_where_the_port_passes(cuda, workload):
  cell = load_cell(workload, shrink=SIZE)
  from recbench import harness
  harness.set_environment(cell)
  limits = cell.workload['limits']
  for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
    port, ref, _ = calibrate.reading(cell, seed, cuda)
    assert check.verdict(port, limits)[0], port
    control = calibrate.reading(cell, seed, cuda, ref,
                                compute_dtype='bfloat16')[0]
    assert not check.verdict(control, limits)[0], control
    half = calibrate.reading(cell, seed, cuda, ref,
                             fault=faults.half_batch)[0]
    assert not check.verdict(half, limits)[0], half
