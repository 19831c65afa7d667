"""Host-side feature transforms: raw columns -> packed numpy arrays.

Counterpart of easyrec_tpu/features/transforms.py for the feature types the
port runs: IdTransform (:136), RawTransform (:272) and the hashed-id branch
of SequenceTransform (:493). Columns are numpy arrays: object arrays of str
for STRING fields, float64 for FLOAT/DOUBLE, int64 for integer fields.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from easyrec_torch.features.feature_spec import FeatureSpec
from easyrec_torch.ops import hashing
from easyrec_torch.utils.registry import load_by_path


def to_numpy_str(col) -> np.ndarray:
  """Column -> object array of strings ('' for None)."""
  arr = np.asarray(col)
  if arr.dtype.kind in ('f', 'i', 'u'):
    return arr.astype(str).astype(object)
  out = arr.astype(object)
  out[out == None] = ''  # noqa: E711 (elementwise)
  return out


def to_float(col, default: float = 0.0) -> np.ndarray:
  arr = np.asarray(col)
  if arr.dtype.kind in ('f', 'i', 'u', 'b'):
    return np.nan_to_num(arr.astype(np.float32), nan=default)
  out = np.empty(arr.shape[0], dtype=np.float32)
  for i, v in enumerate(arr):
    try:
      out[i] = float(v) if v not in ('', None) else default
    except (TypeError, ValueError):
      out[i] = default
  return out


def to_int(col) -> np.ndarray:
  arr = np.asarray(col)
  if arr.dtype.kind in ('i', 'u'):
    return arr.astype(np.int64)
  if arr.dtype.kind == 'f':
    return np.nan_to_num(arr, nan=0).astype(np.int64)
  out = np.empty(arr.shape[0], dtype=np.int64)
  for i, v in enumerate(arr):
    try:
      out[i] = int(float(v)) if v not in ('', None) else 0
    except (TypeError, ValueError):
      out[i] = 0
  return out


def _lookup_ids(col, config) -> np.ndarray:
  """Single-value column -> int ids [B] by the feature's vocab scheme."""
  if config.hash_bucket_size > 0:
    return hashing.hash_strings(to_numpy_str(col),
                                int(config.hash_bucket_size))
  if config.num_buckets > 0:
    return np.clip(to_int(col), 0, int(config.num_buckets) - 1)
  if config.vocab_list or config.vocab_file:
    vocab = list(config.vocab_list)
    if not vocab:
      with open(config.vocab_file) as f:
        vocab = [line.strip() for line in f if line.strip()]
    mapping = {v: i for i, v in enumerate(vocab)}
    return np.array([mapping.get(s, len(vocab)) for s in to_numpy_str(col)],
                    dtype=np.int64)
  raise ValueError('feature %s has no vocab scheme' %
                   (config.feature_name or config.input_names[0]))


class BaseTransform:
  """Transforms one raw column set into packed arrays for one feature."""

  def __init__(self, spec: FeatureSpec):
    self.spec = spec
    self.config = spec.config

  def __call__(self, columns: Dict[str, object]) -> Dict[str, np.ndarray]:
    raise NotImplementedError


class IdTransform(BaseTransform):

  def __call__(self, columns):
    spec, config = self.spec, self.config
    col = columns[config.input_names[0]]
    ids = _lookup_ids(col, config)
    # empty strings carry zero weight
    if config.hash_bucket_size > 0 or config.vocab_list or config.vocab_file:
      weights = (to_numpy_str(col) != '').astype(np.float32)
    else:
      weights = np.ones(ids.shape[0], dtype=np.float32)
    return {
        spec.ids_key: ids.astype(np.int32)[:, None],
        spec.weights_key: weights[:, None],
    }


class RawTransform(BaseTransform):
  """Raw float features: normalize, then bucketize / raw-project / pass."""

  def __init__(self, spec):
    super().__init__(spec)
    self._normalizer = load_by_path(self.config.normalizer_fn) \
        if self.config.normalizer_fn else None

  def _values(self, columns) -> np.ndarray:
    config = self.config
    raw_dim = max(int(config.raw_input_dim), 1)
    col = columns[config.input_names[0]]
    if raw_dim == 1:
      vals = to_float(col)[:, None]
    else:
      strs = to_numpy_str(col)
      sep = config.separator or '|'
      vals = np.zeros((strs.shape[0], raw_dim), dtype=np.float32)
      for i, s in enumerate(strs):
        if not s:
          continue
        parts = s.split(sep)
        for d in range(min(raw_dim, len(parts))):
          try:
            vals[i, d] = float(parts[d])
          except ValueError:
            pass
    if config.max_val > config.min_val:
      vals = (vals - config.min_val) / (config.max_val - config.min_val)
    elif self._normalizer is not None:
      vals = self._normalizer(vals)
    return vals.astype(np.float32)

  def __call__(self, columns):
    spec, config = self.spec, self.config
    vals = self._values(columns)
    if list(config.boundaries):
      bounds = np.asarray(config.boundaries, dtype=np.float64)
      ids = np.searchsorted(bounds, vals, side='right')
      return {
          spec.ids_key: ids.astype(np.int32),
          spec.weights_key: np.ones_like(vals, dtype=np.float32),
      }
    if spec.kind == 'categorical':
      # raw projection: embed iota ids weighted by the values
      n, d = vals.shape
      ids = np.broadcast_to(np.arange(d, dtype=np.int32), (n, d))
      return {
          spec.ids_key: np.ascontiguousarray(ids),
          spec.weights_key: vals,
      }
    return {spec.dense_key: vals}


class SequenceTransform(BaseTransform):
  """Behaviour sequences 'i1|i2|...' -> ids[B, L] + mask[B, L]: hashed
  pieces in order, truncated to L, padded with id 0 and mask 0."""

  def __call__(self, columns):
    spec, config = self.spec, self.config
    col = to_numpy_str(columns[config.input_names[0]])
    ids, counts = hashing.split_hash(col, config.separator or '|',
                                     int(config.hash_bucket_size),
                                     spec.num_ids)
    mask = (np.arange(spec.num_ids)[None, :] < counts[:, None]).astype(
        np.float32)
    return {
        spec.ids_key: ids.astype(np.int32),
        spec.mask_key: mask,
    }


_TRANSFORMS = {
    'IdFeature': IdTransform,
    'RawFeature': RawTransform,
    'SequenceFeature': SequenceTransform,
}


def build_transform(spec: FeatureSpec) -> BaseTransform:
  cls = _TRANSFORMS.get(spec.config.feature_type)
  if cls is None:
    raise NotImplementedError('no transform for feature type %s'
                              % spec.config.feature_type)
  return cls(spec)


def build_transforms(specs: Dict[str, FeatureSpec]) -> List[BaseTransform]:
  return [build_transform(spec) for spec in specs.values()]


def apply_transforms(transforms: List[BaseTransform],
                     columns: Dict[str, object]) -> Dict[str, np.ndarray]:
  out: Dict[str, np.ndarray] = {}
  for t in transforms:
    out.update(t(columns))
  return out
