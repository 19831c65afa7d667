"""Share of the traced stretch in which no operation ran on the device:
from the union of the device operations' intervals, not their sum."""


def read(run):
  p = run.profile
  if p is None or not p.ops or p.window_us <= 0:
    return None
  return 100.0 * (1.0 - p.busy_us() / p.window_us)
