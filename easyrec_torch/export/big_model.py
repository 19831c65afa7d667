"""Big-model export: embedding tables behind a pluggable KV transport
with memory-bounded lazy serving.

A copy of easyrec_tpu/export/big_model.py, but that a table's
update_rows leaves the flush to its caller: the Predictor writes every
update of a sweep, then flushes each table once (a flush of the
flagship's map writes its 3.3 GB back). The export keeps the tables out
of its variables, behind a transport interface (KVTransport):

- `file` (default): each fused table is a raw row-major `.bin` under
  `<export>/kv/` plus a manifest; the Predictor memory-maps the bins
  and gathers ONLY the rows a batch needs (np.memmap fancy indexing;
  the OS page cache plays the role of the redis LRU).
- `redis`: rows live as `<ns>:<table>:<row>` byte strings in a redis
  cluster, fetched with pipelined MGET (the reference's redis backend,
  export_big_model.py:43). Needs a reachable server + redis-py; the
  constructor also accepts any duck-typed client (mget/mset/get/set)
  so the wire contract is testable without connectivity.

The forward pass is split either way: host-side id packing + KV
gather, then the dense forward on the Predictor's device. Incremental
updates (IncrementSaveConfig channels) write through `update_rows` —
the serving-side equivalent of the EAS processor applying sparse
deltas to its store.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

KV_DIR = 'kv'
MANIFEST = 'kv_manifest.json'


# --------------------------------------------------------------- interface


class KVTransport:
  """Transport contract for big-model table storage.

  Implementations provide durable row storage addressed by
  (table key, row index) and a manifest of table specs
  ({key: {rows, dim, dtype}}). `open_table` returns a handle with
  `gather(ids) -> rows`, `update_rows(ids, values)` and `flush()`, which
  makes the rows written durable.
  """

  def write_table(self, key: str, arr: np.ndarray) -> dict:
    raise NotImplementedError

  def open_table(self, key: str, spec: dict, writable: bool = False):
    raise NotImplementedError

  def write_manifest(self, manifest: dict) -> None:
    raise NotImplementedError

  def read_manifest(self) -> dict:
    raise NotImplementedError


def make_transport(export_dir: str, uri: Optional[str] = None,
                   **kwargs) -> 'KVTransport':
  """uri None / 'file' -> FileKVTransport under <export_dir>/kv;
  'redis://host:port[/db]' -> RedisKVTransport."""
  if not uri or uri == 'file' or uri.startswith('file://'):
    return FileKVTransport(os.path.join(export_dir, KV_DIR))
  if uri.startswith('redis://'):
    return RedisKVTransport(uri, **kwargs)
  raise ValueError('unknown KV transport uri %r (file | redis://...)'
                   % uri)


# ------------------------------------------------------------------- file


class KVTableStore:
  """One memory-mapped table: gather rows lazily, write deltas through."""

  def __init__(self, kv_dir: str, key: str, spec: dict,
               writable: bool = False):
    self.key = key
    self.rows = spec['rows']
    self.dim = spec['dim']
    self._map = np.memmap(os.path.join(kv_dir, '%s.bin' % key),
                          dtype=np.float32,
                          mode='r+' if writable else 'r',
                          shape=(self.rows, self.dim))

  def gather(self, ids: np.ndarray) -> np.ndarray:
    """[...]-shaped int ids -> [..., dim] rows (only touched pages are
    faulted in)."""
    flat = np.asarray(ids).reshape(-1)
    out = np.asarray(self._map[np.clip(flat, 0, self.rows - 1)])
    return out.reshape(ids.shape + (self.dim,))

  def update_rows(self, ids: np.ndarray, values: np.ndarray) -> None:
    self._map[np.asarray(ids).reshape(-1)] = \
        np.asarray(values, np.float32).reshape(-1, self.dim)

  def flush(self) -> None:
    self._map.flush()


class FileKVTransport(KVTransport):
  def __init__(self, kv_dir: str):
    self.kv_dir = kv_dir

  def write_table(self, key: str, arr: np.ndarray) -> dict:
    os.makedirs(self.kv_dir, exist_ok=True)
    arr = np.ascontiguousarray(np.asarray(arr, np.float32))
    arr.tofile(os.path.join(self.kv_dir, '%s.bin' % key))
    return {'rows': int(arr.shape[0]), 'dim': int(arr.shape[1]),
            'dtype': 'float32'}

  def open_table(self, key: str, spec: dict, writable: bool = False):
    return KVTableStore(self.kv_dir, key, spec, writable=writable)

  def write_manifest(self, manifest: dict) -> None:
    os.makedirs(self.kv_dir, exist_ok=True)
    with open(os.path.join(self.kv_dir, MANIFEST), 'w') as f:
      json.dump(manifest, f, indent=2)

  def read_manifest(self) -> dict:
    with open(os.path.join(self.kv_dir, MANIFEST)) as f:
      return json.load(f)


# ------------------------------------------------------------------ redis


class RedisKVTable:
  """Row gather/update against a redis-style client: row r of table k
  lives at '<ns>:<k>:<r>' as raw float32 bytes (the reference's layout,
  export_big_model.py redis kv_module)."""

  def __init__(self, client, ns: str, key: str, spec: dict):
    self._c = client
    self._pre = '%s:%s:' % (ns, key)
    self.key = key
    self.rows = spec['rows']
    self.dim = spec['dim']

  def _names(self, flat):
    return [self._pre + str(int(r)) for r in flat]

  def gather(self, ids: np.ndarray) -> np.ndarray:
    flat = np.clip(np.asarray(ids).reshape(-1), 0, self.rows - 1)
    blobs = self._c.mget(self._names(flat))
    out = np.zeros((flat.size, self.dim), np.float32)
    for i, b in enumerate(blobs):
      if b is not None:
        out[i] = np.frombuffer(b, np.float32)
    return out.reshape(ids.shape + (self.dim,))

  def update_rows(self, ids: np.ndarray, values: np.ndarray) -> None:
    flat = np.asarray(ids).reshape(-1)
    vals = np.asarray(values, np.float32).reshape(-1, self.dim)
    self._c.mset({n: vals[i].tobytes()
                  for i, n in enumerate(self._names(flat))})

  def flush(self) -> None:
    """Nothing to do: each mset is on the server."""


class RedisKVTransport(KVTransport):
  """Rows in redis; manifest at '<ns>:manifest' (json). Pass `client`
  to use any mget/mset/get/set-compatible object (tested with a fake);
  otherwise redis-py connects to the uri."""

  def __init__(self, uri: str, namespace: str = 'easyrec', client=None):
    self.ns = namespace
    if client is None:
      try:
        import redis  # noqa: F401 — optional dependency
      except ImportError as e:
        raise RuntimeError(
            'redis:// KV transport needs the redis package (not baked '
            'into this image) or an injected client=') from e
      client = redis.Redis.from_url(uri)
    self._c = client

  def write_table(self, key: str, arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(np.asarray(arr, np.float32))
    table = RedisKVTable(self._c, self.ns, key,
                         {'rows': arr.shape[0], 'dim': arr.shape[1]})
    table.update_rows(np.arange(arr.shape[0]), arr)
    return {'rows': int(arr.shape[0]), 'dim': int(arr.shape[1]),
            'dtype': 'float32'}

  def open_table(self, key: str, spec: dict, writable: bool = False):
    return RedisKVTable(self._c, self.ns, key, spec)

  def write_manifest(self, manifest: dict) -> None:
    self._c.set('%s:manifest' % self.ns, json.dumps(manifest))

  def read_manifest(self) -> dict:
    blob = self._c.get('%s:manifest' % self.ns)
    if blob is None:
      raise FileNotFoundError('no %s:manifest in redis store' % self.ns)
    return json.loads(blob)


# ------------------------------------------------------------- module API


def write_kv_store(export_dir: str, tables: Dict[str, np.ndarray],
                   uri: Optional[str] = None, **kwargs) -> str:
  """Write tables through the chosen transport (default: file bins under
  <export_dir>/kv). Returns the kv dir for the file transport (legacy
  contract), else the uri."""
  transport = make_transport(export_dir, uri, **kwargs)
  manifest = {key: transport.write_table(key, arr)
              for key, arr in tables.items()}
  transport.write_manifest(manifest)
  return getattr(transport, 'kv_dir', uri)


def open_kv_store(export_dir: str, writable: bool = False,
                  uri: Optional[str] = None, **kwargs) -> Dict[str, object]:
  transport = make_transport(export_dir, uri, **kwargs)
  manifest = transport.read_manifest()
  return {key: transport.open_table(key, spec, writable=writable)
          for key, spec in manifest.items()}


def pack_ids_np(layout, batch: Dict[str, np.ndarray]
                ) -> Dict[str, np.ndarray]:
  """Host-side twin of ops/embedding.pack_ids (numpy, no device round
  trip): one [B, totK] int64 pack per fused table."""
  packs = {}
  for key, table in layout.tables.items():
    cols = []
    for use in table.uses:
      ids = np.asarray(batch['feat.%s.ids' % use.feature])
      cols.append(ids.astype(np.int64) + use.offset)
    if cols:
      packs[key] = np.concatenate(cols, axis=1) if len(cols) > 1 \
          else cols[0]
  return packs
