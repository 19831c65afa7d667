"""CUDA kernels launched in the traced stretch, a step (the step driver's
launches: the host's cost of a step)."""


def read(run):
  if run.profile is None or not run.profile.ops:
    return None
  kernels = sum(1 for op in run.profile.ops if op.kind == 'kernel')
  return kernels / run.profile.steps
