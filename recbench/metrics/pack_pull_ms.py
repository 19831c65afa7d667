"""Device ms a step of the embedding pack and pull: the operations
launched inside the id pack (ops/embedding.py pack_all_views), the pull
(Trainer.pull) and the input layer's embedding calls (InputLayer
feature_embedding and sequence_embedding: the slices and combiners of
the pulled rows), and the backward of what those recorded."""

from recbench.trace import backward_of

FORWARD = ('recbench.pack', 'recbench.pull', 'recbench.embed')
RANGES = FORWARD + tuple(backward_of(r) for r in FORWARD)


def read(run):
  p = run.profile
  if p is None or not p.has(('recbench.pack', 'recbench.pull')):
    return None
  return p.device_us(RANGES) / 1e3 / p.steps
