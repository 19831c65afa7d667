"""Predictor: load an export and predict, online or over a CSV.

Counterpart of easyrec_tpu/export/predictor.py (:31-401). An export split by
tools/split_model.py names its `tower` in export_meta.json: its Predictor
answers only that tower's `outputs` (both towers still run, as in the JAX
package, :62, :78-79), and a column it is not given is filled with ''. The export carries
the pipeline config, so the host transforms, the model and the tables'
layout are rebuilt exactly; the forward packs the ids, gathers rows from
the logical [rows, dim] tables by index_select (the JAX package's pull is
XLA, no Pallas kernel) and runs the model in eval mode under
torch.no_grad() on the device (CUDA unless the caller asks for the CPU).
The JAX Predictor pads each request to a static batch_size because jit
needs static shapes; here a request is cut into chunks of at most
batch_size rows, unpadded, and the rows come back in order.

A big-model export (export/big_model.py, meta 'big_model') keeps its
tables in a memory-mapped KV store: the ids are packed on the host
(pack_ids_np), the rows gathered from the store, and only the dense
forward runs on the device (JAX :82-97). Incremental updates
(train/incremental.py) come from a directory (consume_incremental), a
Kafka topic or a DataHub topic, each consumer's position kept on the
Predictor: an update stamped at or before the export's global_step is
skipped, and one that does not load (a half-written blob) stops the sweep
unconsumed, to be retried at the next poll, after the updates before it
have been applied (JAX :124-310). Table rows are written into the KV
store through update_rows, flushed once a sweep, or into the tables on
the device; dense parameters and BatchNorm statistics into the model.
"""

from __future__ import annotations

import base64
import csv as csv_lib
import io
import json
import os
import re
import zipfile
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from easyrec_torch.config import config_util
from easyrec_torch.data.input_pipeline import InputPipeline
from easyrec_torch.device import resolve_device
from easyrec_torch.export import saved_model as sm
from easyrec_torch.features import feature_spec as fs
from easyrec_torch.features import transforms as tr
from easyrec_torch.models import base as model_base
from easyrec_torch.models import (  # noqa: F401 (registers)
    backbone_model, match, match_extra, multi_task, rank, rank_extra)
from easyrec_torch.ops import embedding as emb_ops
from easyrec_torch.ops import packed_table as pt


class Predictor:
  """Loads an easyrec_torch export and predicts on `device`."""

  def __init__(self, export_dir: str, batch_size: int = 1024, device=None):
    self.device = resolve_device(device)
    self.export_dir = export_dir
    self.config, state = sm.load_serving_state(export_dir)
    with open(os.path.join(export_dir, sm.EXPORT_META)) as f:
      self.meta = json.load(f)
    self.batch_size = int(batch_size)
    self.feature_configs = config_util.get_feature_configs(self.config)
    self.specs = fs.build_feature_specs(
        self.feature_configs,
        max_tag_len=self.config.data_config.max_tag_len or 16)
    self.transforms = tr.build_transforms(self.specs)
    self.ctx = model_base.build_context(self.config, self.specs)
    self.layout = self.ctx.layout
    self.model = model_base.create_model(self.ctx, device=self.device)
    self.model.load_state_dict(state['model'])
    self.model.eval()
    self.tables: Dict[str, torch.Tensor] = {}
    self.metas: Dict[str, pt.TableMeta] = {}
    self.big_model = bool(self.meta.get('big_model'))
    self._kv_stores = None
    self._kv_writable = False
    if self.big_model:
      # read-only until an update writes into the store
      self._open_kv(writable=False)
    for key, t in self.layout.tables.items():
      if self.big_model:
        spec = self._kv_stores[key]
        if (spec.rows, spec.dim) != (t.rows, t.dim):
          raise ValueError('KV table %r is [%d, %d], the config gives '
                           '[%d, %d]' % (key, spec.rows, spec.dim, t.rows,
                                         t.dim))
        continue
      table = state['tables'][key]
      if tuple(table.shape) != (t.rows, t.dim):
        raise ValueError('export table %r is %s, the config gives [%d, %d]'
                         % (key, tuple(table.shape), t.rows, t.dim))
      self.tables[key] = table.to(self.device, copy=True)
      self.metas[key] = pt.TableMeta(t.rows, t.dim)
    self.rtp = bool(self.meta.get('export_rtp_outputs'))
    # a split-tower export answers only its tower's outputs
    self.wanted = self.meta.get('outputs') if self.meta.get('tower') \
        else None
    # consumed update files, and the Kafka offsets and DataHub sequences
    # reached, by channel
    self._consumed = set()
    self._kafka_offsets: Dict[tuple, int] = {}
    self._dh_seqs: Dict[tuple, int] = {}

  @property
  def input_names(self) -> List[str]:
    names = []
    for fc in self.feature_configs:
      names.extend(fc.input_names)
    return list(dict.fromkeys(names))

  @torch.no_grad()
  def predict_fn(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Packed numpy batch -> numpy outputs of its rows."""
    dev = {k: torch.from_numpy(_writable(v)).to(self.device)
           for k, v in batch.items()
           if k.startswith('feat.') or k == 'sample_weight'}
    if self.big_model:
      from easyrec_torch.export import big_model as bm
      pulled = {key: torch.from_numpy(self._kv_stores[key].gather(ids))
                .to(self.device)
                for key, ids in bm.pack_ids_np(self.layout, batch).items()}
    else:
      packs = emb_ops.pack_ids(self.layout, dev)
      pulled = emb_ops.pull_embeddings(self.tables, packs, self.metas)
    exported = self.model.export_outputs(self.model(dev, pulled))
    if self.rtp and ('probs' in exported or 'y' in exported):
      # RTP serving output: probs for classification, y for regression
      exported['rank_predict'] = exported.get('probs', exported.get('y'))
    if self.wanted:
      exported = {k: v for k, v in exported.items() if k in self.wanted}
    return {k: v.cpu().numpy() for k, v in exported.items()}

  # -- incremental updates -------------------------------------------------

  def _open_kv(self, writable: bool):
    """Open the big-model KV store, again writable where asked."""
    from easyrec_torch.export import big_model as bm
    if self._kv_stores is None or (writable and not self._kv_writable):
      self._kv_stores = bm.open_kv_store(self.export_dir, writable=writable)
      self._kv_writable = writable
    return self._kv_stores

  def consume_incremental(self, incr_dir: str) -> int:
    """Apply the update files of `incr_dir` not consumed yet; returns how
    many were applied."""
    from easyrec_torch.train import incremental as incr_lib
    pending = [u for u in incr_lib.list_updates(incr_dir)
               if u not in self._consumed]
    return self._apply_update_blobs(pending)

  def consume_incremental_kafka(self, server: str, topic: str,
                                start_offset: int = 0) -> int:
    """Drain the Kafka topic's partition 0 from this Predictor's offset
    (start_offset on the first call) and apply its updates."""
    from easyrec_torch.data import kafka_client as kc
    off = self._kafka_offsets.get((server, topic), start_offset)
    consumer = kc.KafkaConsumer(server)
    blobs = []
    try:
      while True:
        records, hwm = consumer.fetch(topic, {0: off}, max_wait_ms=100)
        for _pid, roff, _key, value in sorted(records, key=lambda r: r[1]):
          blobs.append(io.BytesIO(value))
          off = max(off, roff + 1)
        if not records and off >= hwm.get(0, 0):
          break
    finally:
      consumer.close()
    n = self._apply_update_blobs(blobs)
    self._kafka_offsets[(server, topic)] = off
    return n

  def consume_incremental_datahub(self, endpoint: str, access_id: str,
                                  access_key: str, project: str,
                                  topic: str, start_seq: int = 0) -> int:
    """Drain the DataHub topic from this Predictor's sequence (start_seq
    on the first call): TUPLE records (key, part, total, base64 payload)
    reassembled by key into npz blobs, then applied."""
    from easyrec_torch.data import datahub_client as dhc
    skey = (endpoint, project, topic)
    seq = self._dh_seqs.get(skey, start_seq)
    client = dhc.DataHubClient(endpoint, access_id, access_key)
    blobs, partial = [], {}
    try:
      for shard in client.list_shards(project, topic):
        cursor, cseq = client.get_cursor(project, topic, shard,
                                         dhc.SEQUENCE, sequence=seq)
        _, latest = client.get_cursor(project, topic, shard, dhc.LATEST)
        while cseq < latest:
          records, cursor = client.get_records(project, topic, shard,
                                               cursor)
          if not records:
            break
          for rseq, data in records:
            key, part, total, payload = data
            acc = partial.setdefault(key, [None] * int(total))
            acc[int(part)] = payload
            if all(c is not None for c in acc):
              blobs.append(io.BytesIO(base64.b64decode(''.join(acc)
                                                       .encode())))
              del partial[key]
            cseq = rseq + 1
          seq = max(seq, cseq)
    finally:
      client.close()
    n = self._apply_update_blobs(blobs)
    self._dh_seqs[skey] = seq
    return n

  @staticmethod
  def _update_step(u) -> int:
    """The step of an update: from its file name (update-N-step-S.npz) or
    the __meta__ of a blob; -1 where neither says."""
    if isinstance(u, str):
      m = re.search(r'-step-(\d+)\.npz$', u)
      return int(m.group(1)) if m else -1
    pos = u.tell()
    try:
      with np.load(u) as data:
        if '__meta__' not in data.files:
          return -1
        return int(json.loads(str(data['__meta__']))['step'])
    except (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile):
      return -1
    finally:
      u.seek(pos)

  def _apply_update_blobs(self, pending) -> int:
    """Apply updates (paths or file-like npz blobs) in order; returns how
    many were applied. Each is read whole before any of it is applied."""
    from easyrec_torch.train import incremental as incr_lib
    export_step = int(self.meta.get('global_step', -1))
    fresh = []
    for u in pending:
      step = self._update_step(u)
      if 0 <= step <= export_step:
        if isinstance(u, str):
          self._consumed.add(u)      # older than the export: never apply
        continue
      fresh.append(u)
    if not fresh:
      return 0
    tables = self._open_kv(writable=True) if self.big_model else \
        self.tables
    dense, stats = {}, {}
    applied = 0
    for u in fresh:
      try:
        blob = incr_lib.read_update(u)
      except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        break                        # half-written: retried next poll
      incr_lib.apply_update(dense, tables, blob, batch_stats=stats)
      applied += 1
      if isinstance(u, str):
        self._consumed.add(u)
    if self.big_model:
      for store in tables.values():
        store.flush()
    incr_lib.load_dense(self.model, dense, 'params')
    incr_lib.load_dense(self.model, stats, 'batch_stats')
    return applied

  def predict_columns(self, columns: Dict[str, np.ndarray]) -> Dict:
    """Raw input columns (one value per sample) -> output dict; a missing
    input column is filled with ''."""
    n = len(next(iter(columns.values())))
    for name in self.input_names:
      if name not in columns:
        columns = dict(columns)
        columns[name] = np.array([''] * n, dtype=object)
    echo = {}
    if self.meta.get('export_features'):
      # export_features: answers carry the input feature values
      echo = {'feature_%s' % k: np.asarray(v)
              for k, v in columns.items() if k in self.input_names}
    packed = tr.apply_transforms(self.transforms, columns)
    packed['sample_weight'] = np.ones(n, np.float32)
    chunks = [self.predict_fn({k: v[lo:lo + self.batch_size]
                               for k, v in packed.items()})
              for lo in range(0, n, self.batch_size)]
    out = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    out.update(echo)
    return out

  def predict(self, inputs: Iterable[Dict[str, object]]) -> List[Dict]:
    """List of {input_name: value} dicts -> list of output dicts."""
    rows = list(inputs)
    columns = {name: np.array([row.get(name, '') for row in rows],
                              dtype=object)
               for name in self.input_names}
    out = self.predict_columns(columns)
    return [{k: v[i] for k, v in out.items()} for i in range(len(rows))]

  def predict_csv(self, input_path: str, output_path: str,
                  reserved_cols: Optional[List[str]] = None,
                  shard_index: int = 0, shard_num: int = 1) -> int:
    """Predict a CSV input (the training schema) into an output CSV of the
    reserved input columns, then the outputs in sorted order; padded rows
    are left out. Returns the row count."""
    reserved = list(reserved_cols or [])
    pipeline = InputPipeline(
        self.config.data_config, self.feature_configs, input_path,
        mode='predict', batch_size=self.batch_size,
        shard_index=shard_index, shard_num=shard_num,
        extra_fields=reserved, raw_extra_fields=True)
    n_total = 0
    with open(output_path, 'w', newline='') as f:
      writer = None
      for batch in pipeline:
        valid = batch['sample_weight'] > 0
        res_in = {c: np.asarray(batch.pop('raw.%s' % c)) for c in reserved}
        res = self.predict_fn(batch)
        keys = sorted(res.keys())
        if writer is None:
          writer = csv_lib.writer(f)
          writer.writerow(reserved + keys)
        arrays = [np.asarray(res[k]) for k in keys]
        for i in np.nonzero(valid)[0]:
          writer.writerow([_fmt(res_in[c][i]) for c in reserved] +
                          [_fmt(a[i]) for a in arrays])
          n_total += 1
    return n_total


def _writable(v: np.ndarray) -> np.ndarray:
  """A C-contiguous, writable array of v's values (torch.from_numpy
  wants one; a transform may return a broadcast, read-only view)."""
  a = np.ascontiguousarray(v)
  return a if a.flags.writeable else a.copy()


def _fmt(v):
  arr = np.asarray(v)
  if arr.ndim == 0:
    return float(arr) if arr.dtype.kind == 'f' else arr.item()
  return '|'.join(str(float(x)) for x in arr.ravel())
