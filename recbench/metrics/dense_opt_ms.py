"""Device ms a step of the dense optimizer's step (optim/builder.py)."""

RANGES = ('recbench.dense_opt',)


def read(run):
  p = run.profile
  if p is None or not p.has(RANGES):
    return None
  return p.device_us(RANGES) / 1e3 / p.steps
