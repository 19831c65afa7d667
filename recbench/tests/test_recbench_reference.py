"""The plain reference against the port for three steps at a small size on
the CPU, and `correct` coming out false with the timed path broken
underneath (faults.py): a step that returns its state unchanged, and half
of the batch left out. (One card: no exchange between chips to leave out.)"""

import pytest

from recbench import check, faults, harness
from recbench.cell import load_cell
from recbench.tests.small import CELLS, HELD_CELLS, SMALL, run_line


@pytest.mark.parametrize('workload', CELLS + HELD_CELLS)
def test_port_follows_the_reference(workload, root):
  cell = load_cell(workload, root, SMALL)
  harness.set_environment(cell)
  session = harness.Session(cell, 2 ** 32 + 5, 'cpu', batches=3)
  prog = session.readings
  ref = harness.reference_readings(cell, 2 ** 32 + 5, session.close(), 'cpu')
  assert len(prog['loss']) == 3 and set(prog['change']) == set(ref['change'])
  numbers = check.gaps(prog, ref)
  # the CPU's plain kernels follow the reference far closer than the card's
  assert numbers['loss_1'] < 1e-6 and numbers['grad_dense'] < 1e-4
  correct, _ = check.verdict(numbers, cell.workload['limits'])
  assert correct


@pytest.mark.parametrize('workload', CELLS + HELD_CELLS)
@pytest.mark.parametrize('fault', sorted(faults.FAULTS))
def test_a_broken_step_is_not_correct(workload, fault, root):
  rc, line = run_line(workload, seed=11, fault=faults.FAULTS[fault],
                      root=root)
  assert rc == 0 and line['correct'] is False
  over = [k for k, c in line['checks'].items() if c['value'] > c['limit']]
  assert over


def test_a_missing_limit_fails():
  correct, rows = check.verdict({k: 0.0 for k in check.NUMBERS}, {})
  assert not correct and len(rows) == len(check.NUMBERS)
