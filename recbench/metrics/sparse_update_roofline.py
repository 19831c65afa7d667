"""The sparse update's share of its roofline: the least time of the
traced steps' updates (their bytes, recbench/counts.py, over the card's
HBM bandwidth, recbench/peaks.py) over the device time of the operations
launched inside ops/packed_table.py apply_packed_update, in %."""

from recbench import counts, peaks

RANGES = ('recbench.sparse_update',)


def read(run):
  p = run.profile
  if p is None or not p.has(RANGES):
    return None
  layout = run.cell.config['layout']
  need = sum(counts.sparse_update_bytes(c['slot_bytes'], c['rows'], layout)
             for c in run.trace_counts)
  least_us = need / peaks.HBM_BYTES_PER_S * 1e6
  return 100.0 * least_us / p.device_us(RANGES)
