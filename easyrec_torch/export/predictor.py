"""Predictor: load an export and predict, online or over a CSV.

Counterpart of easyrec_tpu/export/predictor.py (:31-401) without the
big-model store and the incremental-update channels. An export split by
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
"""

from __future__ import annotations

import csv as csv_lib
import json
import os
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
    for key, t in self.layout.tables.items():
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
    packs = emb_ops.pack_ids(self.layout, dev)
    pulled = emb_ops.pull_embeddings(self.tables, packs, self.metas)
    exported = self.model.export_outputs(self.model(dev, pulled))
    if self.rtp and ('probs' in exported or 'y' in exported):
      # RTP serving output: probs for classification, y for regression
      exported['rank_predict'] = exported.get('probs', exported.get('y'))
    if self.wanted:
      exported = {k: v for k, v in exported.items() if k in self.wanted}
    return {k: v.cpu().numpy() for k, v in exported.items()}

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
