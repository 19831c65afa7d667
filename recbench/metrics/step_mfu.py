"""The whole step's share of the card's peak: the dense model's forward
and backward operations a step (counted from the configuration's shapes
by its reference, recbench/reference/<config>.py), times the window's
steps, over the window's time (the unprofiled one), over the peak of the
precision the configuration computes in, in %."""

from recbench import counts, peaks


def read(run):
  w = run.window
  if w is None:           # a traced stretch alone (recbench.spans)
    return None
  flops = counts.train_flops(run.flops_per_example,
                             w['steps'] * run.cell.batch_size)
  return 100.0 * flops / w['seconds'] / \
      peaks.FLOPS[run.cell.config['precision']]
