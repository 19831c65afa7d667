"""Host-side feature transforms: raw columns -> packed numpy arrays.

Counterpart of easyrec_tpu/features/transforms.py, every feature type:
IdTransform (:136), TagTransform (:184), RawTransform (:272),
ComboTransform (:333), LookupTransform (:387), ExprTransform (:468),
SequenceTransform (:493) and PassThroughTransform (:555). Columns are numpy
arrays: object arrays of str for STRING fields, float64 for FLOAT/DOUBLE,
int64 for integer fields (a Parquet column keeps its file's type), and a
Parquet LIST column an object array of Python lists, which the Tag,
Sequence and Raw transforms read. Everything runs on the host, on numpy.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np

from easyrec_torch.features.feature_spec import FeatureSpec
from easyrec_torch.ops import hashing
from easyrec_torch.utils import expr as expr_util
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


def _list_rows(col):
  """A list column's rows (a Parquet LIST column: an object array of
  Python lists, None for a null row) as a list, else None. Counterpart of
  the JAX package's _list_rows (easyrec_tpu/features/transforms.py:155);
  a list column whose rows are all null reads as strings, all ''."""
  arr = np.asarray(col)
  if arr.dtype != object:
    return None
  first = next((v for v in arr if v is not None), None)
  return arr.tolist() if isinstance(first, list) else None


def _lists_to_strings(col, sep: str):
  """A list column's rows joined with the feature's separator, each value
  by its Python str (a float64's as in the JAX package), an empty or null
  row as ''; None if col is not a list column (JAX :172-181)."""
  rows = _list_rows(col)
  if rows is None:
    return None
  out = np.empty(len(rows), dtype=object)
  for i, r in enumerate(rows):
    out[i] = '' if not r else sep.join(str(v) for v in r)
  return out


class TagTransform(BaseTransform):
  """Multi-value tags 'a|b|c' -> ids [B, K] + weights [B, K], K =
  max_multi_len; weighted 'a:0.5|b:2' under kv_separator (a weight that is
  not a number reads 1.0), or the weights 'w1|w2' of a second input
  column."""

  def __call__(self, columns):
    spec, config = self.spec, self.config
    col = columns[config.input_names[0]]
    sep = config.separator or '|'
    joined = _lists_to_strings(col, sep)
    if joined is not None:
      col = joined
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
    elif (rows := _list_rows(col)) is not None:
      vals = np.zeros((len(rows), raw_dim), dtype=np.float32)
      for i, r in enumerate(rows):
        if r:
          m = min(raw_dim, len(r))
          vals[i, :m] = np.asarray(r[:m], dtype=np.float32)
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


class ComboTransform(BaseTransform):
  """A cross of several inputs, hashed (or looked up by num_buckets or a
  vocab) into ids. Without combo_input_seps a row's values are joined by
  combo_join_sep ('\\x1d' by default) into one id; with them each input
  is split by its own separator (an input without one, or an empty
  value, stays whole) and the row's cross product, in order, gives up to
  K = spec.num_ids ids, the rest zero weight."""

  def __call__(self, columns):
    spec, config = self.spec, self.config
    join = config.combo_join_sep or '\x1d'
    cols = [to_numpy_str(columns[name]) for name in config.input_names]
    n = cols[0].shape[0]
    seps = list(config.combo_input_seps)
    use_vocab = bool(config.num_buckets or config.vocab_list or
                     config.vocab_file)

    def ids_of(values):
      return _lookup_ids(values, config) if use_vocab else \
          hashing.hash_strings(values, spec.rows)

    if not seps:
      joined = np.empty(n, dtype=object)
      for i in range(n):
        joined[i] = join.join(str(c[i]) for c in cols)
      return {
          spec.ids_key: ids_of(joined).astype(np.int32)[:, None],
          spec.weights_key: np.ones((n, 1), np.float32),
      }
    k = spec.num_ids
    flat, pos = [], []
    counts = np.zeros(n, dtype=np.int32)
    col_seps = seps + [''] * (len(cols) - len(seps))
    for i in range(n):
      parts = []
      for c, sep in zip(cols, col_seps):
        v = str(c[i])
        parts.append(v.split(sep) if sep and v else [v])
      for j, combo in enumerate(itertools.product(*parts)):
        if j >= k:
          break
        flat.append(join.join(combo))
        pos.append((i, j))
        counts[i] = j + 1
    ids = np.zeros((n, k), dtype=np.int64)
    if flat:
      for (i, j), h in zip(pos, ids_of(np.array(flat, dtype=object))):
        ids[i, j] = h
    weights = (np.arange(k)[None, :] < counts[:, None]).astype(np.float32)
    return {
        spec.ids_key: ids.astype(np.int32),
        spec.weights_key: weights,
    }


def _floats(strs: np.ndarray, counts: np.ndarray, dtype) -> np.ndarray:
  """[n, m] strings -> numbers, the first counts[i] of row i; a string
  that is not a number and every slot past the count read 0."""
  out = np.zeros(strs.shape, dtype=dtype)
  for i in range(strs.shape[0]):
    for j in range(counts[i]):
      try:
        out[i, j] = float(strs[i, j])
      except ValueError:
        pass
  return out


class LookupTransform(BaseTransform):
  """inputs [key, kv map]: each row selects the values of its map
  ('k1:v1|k2:v2', separator and kv_separator) whose key equals the row's
  key, at most n_sel of them in map order. The selected values are read
  as numbers (dense, or raw-projection weights of iota ids), bucketized
  by boundaries, or hashed / looked up into ids with mask weights."""

  def __call__(self, columns):
    spec, config = self.spec, self.config
    keys = to_numpy_str(columns[config.input_names[0]])
    maps = to_numpy_str(columns[config.input_names[1]])
    sep = config.separator or '|'
    kv = config.kv_separator or ':'
    n = maps.shape[0]
    n_sel = spec.num_ids if spec.kind == 'categorical' else spec.value_dim
    sel = np.empty((n, n_sel), dtype=object)
    sel.fill('')
    counts = np.zeros(n, dtype=np.int32)
    for i in range(n):
      if not maps[i]:
        continue
      j = 0
      for piece in maps[i].split(sep):
        pk, _, pv = piece.partition(kv)
        if pk == keys[i]:
          sel[i, j] = pv
          j += 1
          if j >= n_sel:
            break
      counts[i] = j
    mask = (np.arange(n_sel)[None, :] < counts[:, None]).astype(np.float32)
    if spec.kind == 'dense':
      return {spec.dense_key: _floats(sel, counts, np.float32)}
    if list(config.boundaries):
      bounds = np.asarray(config.boundaries, dtype=np.float64)
      ids = np.searchsorted(bounds, _floats(sel, counts, np.float64),
                            side='right')
      return {
          spec.ids_key: ids.astype(np.int32),
          spec.weights_key: mask,
      }
    if not (config.hash_bucket_size > 0 or config.num_buckets > 0 or
            config.vocab_list or config.vocab_file):
      # raw-projection numeric lookup: iota ids weighted by the values
      ids = np.broadcast_to(np.arange(n_sel, dtype=np.int32), (n, n_sel))
      return {
          spec.ids_key: np.ascontiguousarray(ids),
          spec.weights_key: _floats(sel, counts, np.float32),
      }
    ids = _lookup_ids(sel.ravel(), config).reshape(n, n_sel)
    return {
        spec.ids_key: (ids * (mask > 0)).astype(np.int32),
        spec.weights_key: mask,
    }


class ExprTransform(BaseTransform):
  """An expression over the input fields (utils/expr.py) -> dense values,
  or raw-projection weights of iota ids under an embedding. Arithmetic
  reads each field as f32; the string functions read its raw strings."""

  def __call__(self, columns):
    spec, config = self.spec, self.config
    variables = {name: to_float(columns[name])
                 for name in config.input_names}
    raw = {name: to_numpy_str(columns[name]) for name in config.input_names}
    vals = np.asarray(expr_util.evaluate(config.expression, variables, raw),
                      dtype=np.float32)
    if vals.ndim == 1:
      vals = vals[:, None]
    if spec.kind == 'categorical':
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
    col = columns[config.input_names[0]]
    sep = config.separator or '|'
    joined = _lists_to_strings(col, sep)
    col = to_numpy_str(col if joined is None else joined)
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


class PassThroughTransform(BaseTransform):
  """The input column as f32 values, one a row."""

  def __call__(self, columns):
    vals = to_float(columns[self.config.input_names[0]])
    if vals.ndim == 1:
      vals = vals[:, None]
    return {self.spec.dense_key: vals}


_TRANSFORMS = {
    'IdFeature': IdTransform,
    'TagFeature': TagTransform,
    'RawFeature': RawTransform,
    'ComboFeature': ComboTransform,
    'LookupFeature': LookupTransform,
    'SequenceFeature': SequenceTransform,
    'ExprFeature': ExprTransform,
    'PassThroughFeature': PassThroughTransform,
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
