"""Seconds from the process's start to the first timed step: imports, the
trainer and its tables, weights and batches, the kernels' build where the
checkout has none, the first three steps and the warm-up."""


def read(run):
  return run.setup_s
