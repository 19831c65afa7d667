"""The 95th percentile (nearest rank) over every step of the window of
the time from one step's start to the next's (the last step's: to the
end of its work), each start a CUDA event recorded on the stream with no
sync added. Per layer, of the step driver: where the host's launches pace
the step, its tail follows the host's speed from run to run, too widely
for a bound (PERF.md)."""

import math


def read(run):
  if run.window is None:  # a traced stretch alone (recbench.spans)
    return None
  steps = sorted(run.window['step_ms'])
  return steps[max(0, math.ceil(0.95 * len(steps)) - 1)]
