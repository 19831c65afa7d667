"""Host-side feature transforms: raw columns -> packed numpy arrays.

Counterpart of easyrec_tpu/features/transforms.py for the feature types the
port runs: IdTransform (:136), TagTransform (:184), RawTransform (:272) and
SequenceTransform (:493). Columns are numpy arrays: object arrays of str
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
  if list(config.boundaries):
    # numeric values bucketized by boundaries (a sequence of sub_feature_
    # type RawFeature with boundaries)
    vals = np.zeros(len(col), dtype=np.float64)
    for i, v in enumerate(to_numpy_str(col)):
      try:
        vals[i] = float(v)
      except ValueError:
        pass
    bounds = np.asarray(config.boundaries, dtype=np.float64)
    return np.searchsorted(bounds, vals, side='right').astype(np.int64)
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


def _split_lookup(strs, sep: str, k: int, config):
  """'a|b|c' rows -> (ids [n, k] by the vocab scheme, counts [n]): the
  non-empty pieces in order, at most k a row."""
  n = strs.shape[0]
  ids = np.zeros((n, k), dtype=np.int64)
  counts = np.zeros(n, dtype=np.int32)
  flat, pos = [], []
  for i, s in enumerate(strs):
    j = 0
    for piece in (s.split(sep) if s else []):
      if piece and j < k:
        flat.append(piece)
        pos.append((i, j))
        j += 1
    counts[i] = j
  if flat:
    looked = _lookup_ids(np.array(flat, dtype=object), config)
    for (i, j), h in zip(pos, looked):
      ids[i, j] = h
  return ids, counts


class TagTransform(BaseTransform):
  """Multi-value tags 'a|b|c' -> ids [B, K] + weights [B, K], K =
  max_multi_len; weighted 'a:0.5|b:2' under kv_separator (a weight that is
  not a number reads 1.0), or the weights 'w1|w2' of a second input
  column."""

  def __call__(self, columns):
    spec, config = self.spec, self.config
    col = columns[config.input_names[0]]
    sep = config.separator or '|'
    k = spec.num_ids
    if config.kv_separator:
      strs = to_numpy_str(col)
      n = strs.shape[0]
      ids = np.zeros((n, k), dtype=np.int64)
      weights = np.zeros((n, k), dtype=np.float32)
      kv = config.kv_separator
      keys_flat, wts_flat, pos = [], [], []
      for i, s in enumerate(strs):
        if not s:
          continue
        j = 0
        for piece in s.split(sep):
          if not piece or j >= k:
            continue
          if kv in piece:
            key, _, wstr = piece.partition(kv)
            try:
              w = float(wstr)
            except ValueError:
              w = 1.0
          else:
            key, w = piece, 1.0
          keys_flat.append(key)
          wts_flat.append(w)
          pos.append((i, j))
          j += 1
      if keys_flat:
        looked = _lookup_ids(np.array(keys_flat, dtype=object), config)
        for (i, j), h, w in zip(pos, looked, wts_flat):
          ids[i, j] = h
          weights[i, j] = w
    else:
      if config.hash_bucket_size > 0:
        ids, counts = hashing.split_hash(
            to_numpy_str(col), sep, int(config.hash_bucket_size), k)
      else:
        ids, counts = _split_lookup(to_numpy_str(col), sep, k, config)
      weights = (np.arange(k)[None, :] < counts[:, None]).astype(np.float32)
      if len(config.input_names) > 1:
        wstrs = to_numpy_str(columns[config.input_names[1]])
        wvals = np.zeros_like(weights)
        for i, s in enumerate(wstrs):
          if not s:
            continue
          for j, piece in enumerate(s.split(sep)[:k]):
            try:
              wvals[i, j] = float(piece)
            except ValueError:
              wvals[i, j] = 1.0
        weights = weights * wvals
    return {
        spec.ids_key: ids.astype(np.int32),
        spec.weights_key: weights,
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
  """Behaviour sequences 'i1|i2|...' -> ids[B, L] + mask[B, L]: the
  pieces in order (hashed, or by num_buckets, boundaries or vocab),
  truncated to L, padded with id 0 and mask 0. A numeric sequence gives
  dense[B, L, N] + mask[B, L]: positions split by `separator`, each
  position's N values by `seq_multi_sep`."""

  def __call__(self, columns):
    spec, config = self.spec, self.config
    col = to_numpy_str(columns[config.input_names[0]])
    sep = config.separator or '|'
    L = spec.num_ids
    if spec.seq_is_dense:
      n = col.shape[0]
      sub_sep = config.seq_multi_sep or None
      N = spec.value_dim
      vals = np.zeros((n, L, N), dtype=np.float32)
      mask = np.zeros((n, L), dtype=np.float32)
      for i, s in enumerate(col):
        if not s:
          continue
        for j, piece in enumerate(s.split(sep)[:L]):
          subs = piece.split(sub_sep) if sub_sep else [piece]
          for d, sub in enumerate(subs[:N]):
            try:
              vals[i, j, d] = float(sub)
            except ValueError:
              pass
          mask[i, j] = 1.0
      return {spec.dense_key: vals, spec.mask_key: mask}
    if config.hash_bucket_size > 0:
      ids, counts = hashing.split_hash(col, sep,
                                       int(config.hash_bucket_size), L)
    else:
      ids, counts = _split_lookup(col, sep, L, config)
    mask = (np.arange(spec.num_ids)[None, :] < counts[:, None]).astype(
        np.float32)
    return {
        spec.ids_key: ids.astype(np.int32),
        spec.mask_key: mask,
    }


_TRANSFORMS = {
    'IdFeature': IdTransform,
    'TagFeature': TagTransform,
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
