"""Serving export: a self-contained directory of config, weights and meta.

Counterpart of easyrec_tpu/export/saved_model.py (:30-147), in the same
layout:

    <export_base_dir>/<unix time>/
        pipeline.config          the trainer's config, in text format
        export_meta.json         the JAX package's keys, with
                                 'framework': 'easyrec_torch'
        variables/variables.pt   one torch.save of the serving state
        assets/                  export_config.asset_files, if any

The serving state is a dict: 'model', the model's state_dict with
Trainer.eval_params() in place of the parameters (the EMA weights under
use_moving_average) beside BatchNorm's running statistics; 'tables', the
LOGICAL [rows, dim] f32 weights of each fused table, with no optimizer
slots (the JAX package's unpack_host, :47-54), or none in a big-model
export, whose tables go to a KV store (export/big_model.py: under
kv/, one raw row-major .bin each and a manifest); 'step', an int64 scalar. The
port's BatchNorm keeps no num_batches_tracked (flax's BatchNorm has none and
its momentum is fixed), so the state holds none, and a state_dict holding
one does not load. Older timestamped exports beyond
export_config.exports_to_keep are pruned. A JAX export keeps its variables
with orbax, which the port does not read: easyrec_torch/convert.py
jax_export_to_bundle writes its arrays in this layout.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, Optional

import torch

from easyrec_torch.config import config_util
from easyrec_torch.ops import embedding as emb_ops

EXPORT_META = 'export_meta.json'
VARIABLES_DIR = 'variables'
VARIABLES_FILE = 'variables.pt'
CONFIG_FILE = 'pipeline.config'


@torch.no_grad()
def serving_state(trainer) -> Dict[str, object]:
  """The trainer's serving state (see the module docstring), copied to the
  host."""
  model = {k: v.detach().to('cpu', copy=True)
           for k, v in trainer.model.state_dict().items()}
  for name, p in trainer.eval_params().items():
    model[name] = p.detach().to('cpu', copy=True)
  tables = {}
  for key, meta in trainer.metas.items():
    weights = trainer.tables[key][:, :meta.dim]
    tables[key] = torch.empty(tuple(weights.shape),
                              dtype=torch.float32).copy_(weights)
  return {'model': model, 'tables': tables,
          'step': torch.tensor(int(trainer.step), dtype=torch.int64)}


def export_saved_model(trainer, export_base_dir: str,
                       assets: Optional[list] = None,
                       big_model: bool = False) -> str:
  """Write the trainer's current state as a timestamped export under
  export_base_dir; returns its path. big_model puts the tables into the
  file KV store beside the variables (JAX :30-60)."""
  stamp = str(int(time.time()))
  export_dir = os.path.join(export_base_dir, stamp)
  os.makedirs(export_dir, exist_ok=True)
  config_util.save_pipeline_config(trainer.pipeline_config, export_dir,
                                   CONFIG_FILE)
  state = serving_state(trainer)
  if big_model:
    from easyrec_torch.export import big_model as bm
    bm.write_kv_store(export_dir, {k: t.numpy()
                                   for k, t in state['tables'].items()})
    state['tables'] = {}
  os.makedirs(os.path.join(export_dir, VARIABLES_DIR), exist_ok=True)
  torch.save(state, os.path.join(export_dir, VARIABLES_DIR, VARIABLES_FILE))

  ec = trainer.pipeline_config.export_config
  outputs = set(_output_names(trainer))
  if ec.export_rtp_outputs and ('probs' in outputs or 'y' in outputs):
    outputs.add('rank_predict')
  meta = {
      'model_class': trainer.pipeline_config.model_config.model_class,
      'export_time': stamp,
      'global_step': int(state['step']),
      'outputs': sorted(outputs),
      'inputs': _input_signature(trainer),
      'framework': 'easyrec_torch',
      'big_model': bool(big_model),
      'export_features': bool(ec.export_features),
      'export_rtp_outputs': bool(ec.export_rtp_outputs),
  }
  with open(os.path.join(export_dir, EXPORT_META), 'w') as f:
    json.dump(meta, f, indent=2)

  if assets:
    asset_dir = os.path.join(export_dir, 'assets')
    os.makedirs(asset_dir, exist_ok=True)
    for path in assets:
      shutil.copy(path, asset_dir)

  keep = max(int(ec.exports_to_keep), 1)
  stamps = sorted(d for d in os.listdir(export_base_dir)
                  if d.isdigit() and
                  os.path.isdir(os.path.join(export_base_dir, d)))
  for old in stamps[:-keep]:
    shutil.rmtree(os.path.join(export_base_dir, old), ignore_errors=True)
  return export_dir


@torch.no_grad()
def _output_names(trainer) -> list:
  """The model's export outputs, probed on an 8-row synthetic batch."""
  from easyrec_torch.train.trainer import to_device
  from easyrec_torch.utils.synthetic import synthetic_batch
  batch = to_device(synthetic_batch(trainer.specs,
                                    list(trainer.ctx.label_fields), 8),
                    trainer.device)
  packs = emb_ops.pack_ids(trainer.layout, batch)
  pulled = emb_ops.pull_embeddings(trainer.tables, packs, trainer.metas)
  outputs = trainer.eval_forward(batch, pulled)
  return list(trainer.model.export_outputs(outputs).keys())


def _input_signature(trainer) -> Dict[str, dict]:
  sig = {}
  for fc in trainer.feature_configs:
    name = fc.feature_name or fc.input_names[0]
    sig[name] = {'input_names': list(fc.input_names),
                 'feature_type': fc.feature_type}
  return sig


def load_serving_state(export_dir: str):
  """(pipeline config, serving state) of a port export. The state's
  tensors are memory-mapped from variables.pt on the host. A JAX export
  (orbax variables) raises ValueError naming convert.py."""
  config = config_util.get_configs_from_pipeline_file(
      os.path.join(export_dir, CONFIG_FILE))
  path = os.path.join(export_dir, VARIABLES_DIR, VARIABLES_FILE)
  if not os.path.exists(path):
    var_dir = os.path.join(export_dir, VARIABLES_DIR)
    if os.path.isdir(var_dir) and os.listdir(var_dir):
      raise ValueError(
          '%s holds no %s: it is not an export of the port. An export of '
          'the JAX package keeps orbax variables, which the port does not '
          'read; restore them on the JAX side and write a port bundle with '
          'easyrec_torch/convert.py jax_export_to_bundle'
          % (var_dir, VARIABLES_FILE))
    raise FileNotFoundError('no serving variables under %s' % export_dir)
  state = torch.load(path, map_location='cpu', weights_only=True, mmap=True)
  return config, state
