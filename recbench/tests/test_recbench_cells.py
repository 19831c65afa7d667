"""Each cell end to end on the CPU at a small size, on the plain kernel
paths: the result line has the contract's shape, and `correct` holds."""

import pytest

from recbench.tests.small import CELLS, HELD_CELLS, run_line

LINE_KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


@pytest.mark.parametrize('workload', CELLS + HELD_CELLS)
@pytest.mark.parametrize('trace', [0, 1])
def test_cell_prints_the_contract_line(workload, trace, root):
  rc, line = run_line(workload, seed=2 ** 31 + 12345, trace=trace,
                      root=root)
  assert rc == 0
  keys = list(line)
  assert keys[:5] == LINE_KEYS and keys[-1] == 'checks'
  assert ('breakdown' in line) == bool(trace)
  assert line['correct'] is True and line['failed'] == 0
  assert line['attempted'] >= 1
  for m in line['metrics'].values():
    assert set(m) == {'value', 'unit'} and isinstance(m['value'], float)
  if not trace:
    assert set(line['metrics']) == {'train_examples_per_s', 'peak_mem_gib',
                                    'setup_s'}
  else:
    # no device operations on the CPU: only the window's readers read
    assert set(line['metrics']) == {'step_mfu', 'step_ms_p95.host_paced'}
    assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
  for check in line['checks'].values():
    assert check['value'] <= check['limit']
