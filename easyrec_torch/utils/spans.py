"""Named spans of the train step, recorded only while a torch profiler runs.

    with spans.span('easyrec.pull'):
      ...

Inside a torch.profiler session a span is a `record_function` range: the
profiler's trace holds it beside the device's kernels and memcpys, on one
clock, nested as the code nests. With no profiler active, `span` checks
one flag and hands back one shared no-op context: nothing is recorded or
allocated. There is no other switch.

The spans of a train step (train/trainer.py Trainer.train_step and fit):
  easyrec.step                the whole train_step
  easyrec.pack                ops/embedding.py pack_all_views
  easyrec.pull                Trainer.pull (one device, or the exchange)
  easyrec.ev                  the EV mask of the pulled rows and the EV
                              state's update (with ev_params)
  easyrec.forward             the model's forward
  easyrec.embed               InputLayer.feature_embedding and
                              sequence_embedding (inside the forward)
  easyrec.embed.split         the one split of a pulled pack into its
                              uses' pieces (ops/embedding.py StepPulls),
                              inside the step's first easyrec.embed that
                              reads the pack
  easyrec.embed.pool          the reduction of pulled rows by their
                              combiner, inside easyrec.embed: every bag of
                              a pack at once, by K7 (ops/embedding.py
                              StepPulls.pooled, PoolBags), once a pooled
                              pack a step; else one feature's
                              (ops/embedding.py combine)
  easyrec.cross               the DCN-v2 cross layers (layers/
                              interaction.py CrossNetV2.forward), inside
                              easyrec.forward
  easyrec.loss                Trainer._regularised_loss
  easyrec.backward            total.backward()
  easyrec.dense_opt           the dense optimizer's step, after the
                              gradients' all-reduce in a world
  easyrec.sparse_update       the update of every table
  easyrec.sparse_update.sort  ops/packed_table.py sort_segments
  easyrec.input               fit's fetch of a batch and its copy to the
                              device (outside easyrec.step)
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

_profiling = torch.autograd._profiler_enabled


class _Off:
  """The context of a span with no profiler active. Its enter and exit are
  ''.format, a C call that takes any arguments and returns '': nothing is
  recorded, an exception passes through ('' is false), and a span costs
  about 40% less than with Python-level methods (contextlib.nullcontext);
  the embedding's span is entered once a feature."""
  __slots__ = ()
  __enter__ = ''.format
  __exit__ = ''.format


_OFF = _Off()


def span(name: str):
  """A context that records `name` while a torch profiler runs."""
  if _profiling():
    return record_function(name)
  return _OFF
