"""Work counted from shapes, the same whatever kernel does it."""

from __future__ import annotations


def slot_bytes(id_bytes: int, feature: dict) -> int:
  """Bytes one id slot of `feature` brings to the sparse update: its id,
  at the batch's integer width, and its float32 row gradient over the
  columns the feature's function uses (its deep `dim` and its
  `wide_dim`), not the table's padding."""
  width = int(feature['dim']) + int(feature.get('wide_dim', 0))
  return int(id_bytes) + 4 * width


def sparse_update_bytes(slot_bytes_total: int, rows: int,
                        layout: dict) -> int:
  """Bytes a step's sparse update needs: its inputs read once (the slots'
  bytes, slot_bytes summed over the batch), every distinct row it touches
  read once and written once, at the table's physical row width
  (`row_floats` float32)."""
  return int(slot_bytes_total) + 2 * rows * 4 * int(layout['row_floats'])


def train_flops(flops_per_example: float, examples: int) -> float:
  """A training step's operations: the forward's, and twice as many for
  the backward (the products' input and weight gradients)."""
  return 3.0 * flops_per_example * examples
