"""Device ms a step of the dense model: the operations launched inside
the model's forward and its loss (outside the input layer's embedding
calls), and the backward of what they recorded, with the backward the
trace ties to no forward range (the leaves' AccumulateGrad)."""

from recbench.trace import BACKWARD, backward_of

FORWARD = ('recbench.forward', 'recbench.loss')
RANGES = FORWARD + tuple(backward_of(r) for r in FORWARD) + (BACKWARD,)


def read(run):
  p = run.profile
  if p is None or not p.has(('recbench.forward',)):
    return None
  return p.device_us(RANGES) / 1e3 / p.steps
