"""Synthetic packed batches straight from feature specs.

Counterpart of easyrec_tpu/utils/synthetic.py (categorical, dense, id and
numeric sequences). Batches are the same flat numpy
dicts the input pipeline yields, so benchmarks can time the train step
without the host CSV path.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from easyrec_torch.features.feature_spec import FeatureSpec


def synthetic_batch(specs: Dict[str, FeatureSpec],
                    label_fields: List[str],
                    batch_size: int,
                    seed: int = 0,
                    skew: float = 1.05) -> Dict[str, np.ndarray]:
  """Random packed batch matching the specs' static shapes. Ids follow a
  zipf-ish skew (power-law id popularity, the realistic and adversarial
  case for the sparse update)."""
  rng = np.random.default_rng(seed)
  batch = {}
  for spec in specs.values():
    if spec.kind == 'dense':
      batch[spec.dense_key] = rng.random(
          (batch_size, spec.value_dim)).astype(np.float32)
    elif spec.kind == 'sequence' and spec.seq_is_dense:
      batch[spec.dense_key] = rng.random(
          (batch_size, spec.num_ids, spec.value_dim)).astype(np.float32)
      batch[spec.mask_key] = np.ones((batch_size, spec.num_ids), np.float32)
    elif spec.kind == 'sequence':
      # lengths uniform in 1..L; padded positions carry id 0, mask 0
      lens = rng.integers(1, spec.num_ids + 1, batch_size)
      ids = _skewed_ids(rng, spec.rows, (batch_size, spec.num_ids), skew)
      mask = (np.arange(spec.num_ids)[None, :] <
              lens[:, None]).astype(np.float32)
      batch[spec.ids_key] = (ids * mask).astype(np.int32)
      batch[spec.mask_key] = mask
    elif spec.is_weighted:
      batch[spec.ids_key] = np.broadcast_to(
          np.arange(spec.num_ids, dtype=np.int32),
          (batch_size, spec.num_ids)).copy()
      batch[spec.weights_key] = rng.random(
          (batch_size, spec.num_ids)).astype(np.float32)
    else:
      batch[spec.ids_key] = _skewed_ids(
          rng, spec.rows, (batch_size, spec.num_ids), skew).astype(np.int32)
      batch[spec.weights_key] = np.ones((batch_size, spec.num_ids),
                                        np.float32)
  for label in label_fields:
    batch['label.%s' % label] = rng.integers(
        0, 2, batch_size).astype(np.float32)
  batch['sample_weight'] = np.ones(batch_size, np.float32)
  return batch


def _skewed_ids(rng, rows: int, shape, skew: float) -> np.ndarray:
  u = rng.random(shape)
  ids = np.floor(rows * np.power(u, skew)).astype(np.int64)
  return np.clip(ids, 0, rows - 1)
