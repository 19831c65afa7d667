"""Incremental model updates for online serving.

Counterpart of easyrec_tpu/train/incremental.py. A publisher keeps the
last published snapshot and, at each publish, sends what changed since:
the dense parameters that differ and the table rows whose weights differ,
as LOGICAL [rows, dim] deltas (no optimizer slots), so the serving side
does not depend on the training layout. The first publish only takes the
snapshot.

The update format is the JAX package's, so either package consumes the
other's updates: an .npz with `dense/<flax path>` (a kernel in flax's
[in, out] layout, convert.flax_names), `sparse_ids/<table>` (int64) and
`sparse_vals/<table>` ([n, dim] f32); on the file channel
`update-%06d-step-%d.npz` beside a `.meta` json of
{step, version, ts, dense, sparse}, each written to a temporary name and
renamed into place; on Kafka the npz (with the meta as `__meta__`) as one
message keyed by its name; on DataHub the base64 npz in TUPLE records
(key, part, total, payload) of at most 512 KiB. The port also sends the
BatchNorm statistics that changed, as `batch_stats/<flax path>`, which
the JAX package's consumer does not read.

The snapshot of each table's weight columns is kept on the table's
device, and the rows that differ are found there: at the flagship's
[26,000,014, 32] only the changed rows travel to the host, where the JAX
design copies and compares the whole table each time.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from easyrec_torch import convert

DATAHUB_CHUNK = 512 * 1024


def dense_arrays(model) -> Dict[str, Dict[str, np.ndarray]]:
  """Copies of the model's parameters and BatchNorm statistics as numpy
  arrays under their flax paths, kernels in flax's layout: {'params': ...,
  'batch_stats': ...}."""
  state = model.state_dict()
  out = {'params': {}, 'batch_stats': {}}
  for name, (section, path) in convert.flax_names(
      state, root=model.flax_root).items():
    arr = state[name].detach().cpu().numpy()
    if path.endswith('kernel'):
      arr = arr.T
    # a copy: on the CPU .numpy() shares the live parameter's memory
    out[section][path] = np.array(arr, dtype=np.float32, order='C')
  return out


def load_dense(model, dense: Dict[str, np.ndarray],
               section: str = 'params') -> int:
  """Copy the arrays of `dense` (flax path -> array) into the model's
  tensors of that section; returns how many it copied."""
  state = model.state_dict()
  n = 0
  with torch.no_grad():
    for name, (sec, path) in convert.flax_names(
        state, root=model.flax_root).items():
      if sec != section or path not in dense:
        continue
      arr = np.asarray(dense[path], np.float32)
      if path.endswith('kernel'):
        arr = arr.T
      state[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
      n += 1
  return n


class IncrementalPublisher:
  """Publishes dense deltas and the changed table rows of a Trainer."""

  def __init__(self, incr_save_config, model_dir: str):
    self.config = incr_save_config
    which = incr_save_config.WhichOneof('incr_update')
    self.directory = None
    self._producer = None
    self._datahub = None
    if which == 'datahub':
      from easyrec_torch.data import datahub_client as dhc
      dh = incr_save_config.datahub
      self._datahub = dhc.DataHubClient(dh.region, dh.akId, dh.akSecret)
      self._dh_project, self._dh_topic = dh.project, dh.topic
    elif which == 'kafka':
      from easyrec_torch.data import kafka_client as kc
      self._producer = kc.KafkaProducer(incr_save_config.kafka.server)
      self._topic = incr_save_config.kafka.topic
    else:
      fs = incr_save_config.fs
      sub = fs.incr_save_dir or 'incr_save'
      self.directory = os.path.join(model_dir, sub) if fs.relative else sub
      os.makedirs(self.directory, exist_ok=True)
    self._last_dense: Optional[Dict[str, Dict[str, np.ndarray]]] = None
    self._last_tables: Dict[str, torch.Tensor] = {}
    self._version = 0

  def _changed_rows(self, key: str, weights: torch.Tensor):
    """(ids, values) of the rows of `weights` that differ from the
    snapshot, which takes them."""
    old = self._last_tables[key]
    ids = torch.nonzero((weights != old).any(dim=1)).flatten()
    old[ids] = weights[ids]
    return ids, weights[ids]

  def publish(self, trainer, step: int) -> Optional[str]:
    """Publish one update of `trainer`'s state; returns where it went (None
    on the first call, which takes the snapshot)."""
    dense = dense_arrays(trainer.model)
    first = self._last_dense is None
    payload = {}
    meta = {'step': int(step), 'version': self._version,
            'ts': time.time(), 'dense': [], 'sparse': {}}
    with torch.no_grad():
      for key, m in trainer.metas.items():
        weights = trainer.tables[key][:, :m.dim]
        if first:
          self._last_tables[key] = weights.clone()
          continue
        ids, vals = self._changed_rows(key, weights)
        if ids.numel():
          payload['sparse_ids/%s' % key] = ids.cpu().numpy().astype(
              np.int64)
          payload['sparse_vals/%s' % key] = vals.cpu().numpy()
          meta['sparse'][key] = int(ids.numel())
    if not first:
      for section, prefix in (('params', 'dense/'),
                              ('batch_stats', 'batch_stats/')):
        last = self._last_dense[section]
        for name, arr in dense[section].items():
          if not np.array_equal(arr, last.get(name)):
            payload[prefix + name] = arr
            if section == 'params':
              meta['dense'].append(name)
      meta['batch_stats'] = sorted(
          k[len('batch_stats/'):] for k in payload
          if k.startswith('batch_stats/'))
    self._last_dense = dense
    if first:
      logging.info('incremental publisher: snapshot at step %d', step)
      return None
    self._version += 1
    name = 'update-%06d-step-%d' % (self._version, step)
    if self._datahub is not None or self._producer is not None:
      buf = io.BytesIO()
      np.savez_compressed(buf, __meta__=np.array(json.dumps(meta)),
                          **payload)
      blob = buf.getvalue()
    if self._datahub is not None:
      text = base64.b64encode(blob).decode()
      parts = [text[i:i + DATAHUB_CHUNK]
               for i in range(0, len(text), DATAHUB_CHUNK)] or ['']
      rows = [[name, str(i), str(len(parts)), p]
              for i, p in enumerate(parts)]
      shards = self._datahub.list_shards(self._dh_project, self._dh_topic)
      self._datahub.put_records(self._dh_project, self._dh_topic,
                                shards[0], rows)
      logging.info('published incremental update %s to datahub %s/%s: '
                   '%d dense vars, %s sparse rows, %d record(s)',
                   name, self._dh_project, self._dh_topic,
                   len(meta['dense']), meta['sparse'], len(rows))
      return '%s/%s:%s' % (self._dh_project, self._dh_topic, name)
    if self._producer is not None:
      off = self._producer.send(self._topic, blob, key=name.encode())
      logging.info('published incremental update %s to kafka %s@%d: '
                   '%d dense vars, %s sparse rows', name, self._topic,
                   off, len(meta['dense']), meta['sparse'])
      return '%s@%d' % (self._topic, off)
    path = os.path.join(self.directory, name + '.npz')
    # consumers poll the directory: they never see a half-written file
    tmp = os.path.join(self.directory, '.tmp-' + name + '.npz')
    with open(tmp, 'wb') as f:
      np.savez_compressed(f, **payload)
    os.replace(tmp, path)
    tmp_meta = os.path.join(self.directory, '.tmp-' + name + '.meta')
    with open(tmp_meta, 'w') as f:
      json.dump(meta, f)
    os.replace(tmp_meta, path + '.meta')
    logging.info('published incremental update %s: %d dense vars, %s '
                 'sparse rows', path, len(meta['dense']), meta['sparse'])
    return path

  def close(self) -> None:
    if self._producer is not None:
      self._producer.close()
      self._producer = None
    if self._datahub is not None:
      self._datahub.close()
      self._datahub = None


def list_updates(directory: str):
  """The update files of `directory` in version order."""
  if not os.path.isdir(directory):
    return []
  files = [f for f in os.listdir(directory)
           if f.startswith('update-') and f.endswith('.npz')]
  return [os.path.join(directory, f) for f in sorted(files)]


def read_update(update) -> Dict[str, np.ndarray]:
  """Every array of one update (a path or a file-like npz)."""
  with np.load(update) as data:
    return {k: data[k] for k in data.files}


def apply_update(dense: Dict[str, np.ndarray], tables, update,
                 batch_stats: Optional[Dict[str, np.ndarray]] = None
                 ) -> None:
  """Apply one update (a path, a file-like npz or read_update's dict) in
  place: `dense` and `batch_stats` by flax path, `tables` (by table key:
  [rows, dim] tensors, or KV stores with `rows` and update_rows) by row,
  the ids below the table's rows."""
  data = update if isinstance(update, dict) else read_update(update)
  for key, arr in data.items():
    if key.startswith('dense/'):
      dense[key[len('dense/'):]] = arr
    elif key.startswith('batch_stats/') and batch_stats is not None:
      batch_stats[key[len('batch_stats/'):]] = arr
    elif key.startswith('sparse_ids/'):
      tname = key[len('sparse_ids/'):]
      table = tables[tname]
      if isinstance(table, torch.Tensor):
        keep = arr < table.shape[0]
        table[torch.from_numpy(arr[keep]).to(table.device)] = \
            torch.from_numpy(data['sparse_vals/%s' % tname][keep]).to(
                table.device)
      else:
        keep = arr < table.rows
        table.update_rows(arr[keep], data['sparse_vals/%s' % tname][keep])
