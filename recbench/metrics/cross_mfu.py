"""The cross layers' share of the card's peak: their forward and backward
operations a step (three times the forward's, counted from the
configuration's shapes by its reference's cross_flops_per_example,
recbench/reference/<config>.py) over the device time of the port's span
easyrec.cross and its backward (cross_ms's reading), over the peak of
the precision the configuration computes in (recbench/peaks.py), in %."""

from recbench import counts, harness, peaks
from recbench.trace import span_ms


def read(run):
  ms = span_ms(run.profile.spans if run.profile is not None else None,
               ('easyrec.cross',))
  if not ms:
    return None
  flops = counts.train_flops(run.cell.reference().cross_flops_per_example(
      harness.model_description(run.cell)), run.cell.batch_size)
  return 100.0 * flops / (ms / 1e3) / \
      peaks.FLOPS[run.cell.config['precision']]
