"""Entry points: train_and_evaluate / evaluate / export / predict.

Counterpart of easyrec_tpu/main.py (:42-230). With a model_dir, training
writes pipeline.config and version there, checkpoints to
<model_dir>/checkpoints/<step>/ (train/checkpoints.py), resumes from the
latest one, and exports by export_config.exporter_type ('final' by default,
'none' to skip) into <model_dir>/export/<exporter_type>/<unix time>/
(export/saved_model.py). Every call runs on `device`, CUDA unless the
caller asks for the CPU.
"""

from __future__ import annotations

import csv as csv_lib
import json
import logging
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from easyrec_torch import __version__
from easyrec_torch.config import config_util
from easyrec_torch.config.text_format import Message

ConfigOrPath = Union[str, Message]


def load_config(config: ConfigOrPath,
                edit_config_json: Optional[dict] = None) -> Message:
  """A pipeline config (path or message; a message is copied) with the
  dotted-path edits applied."""
  if isinstance(config, str):
    config = config_util.get_configs_from_pipeline_file(config)
  else:
    config = config.copy()
  if edit_config_json:
    config_util.edit_config(config, edit_config_json)
  return config


def _prepare_model_dir(config: Message, continue_train: bool) -> None:
  model_dir = config.model_dir
  if not model_dir:
    return
  os.makedirs(model_dir, exist_ok=True)
  has_ckpt = os.path.isdir(os.path.join(model_dir, 'checkpoints'))
  if has_ckpt and not continue_train:
    logging.warning(
        'model_dir %s already contains checkpoints; training continues '
        'from the latest one (pass continue_train=True to silence)',
        model_dir)
  config_util.save_pipeline_config(config, model_dir)
  with open(os.path.join(model_dir, 'version'), 'w') as f:
    f.write(__version__ + '\n')


def _restored_trainer(config: Message, device, checkpoint_path=None):
  """A Trainer on `device` holding model_dir's latest checkpoint, or the
  step checkpoint_path names (its basename is the step)."""
  from easyrec_torch.train import checkpoints as ckpt_lib
  from easyrec_torch.train.trainer import Trainer
  trainer = Trainer(config, device=device)
  trainer.init_state()
  mgr = ckpt_lib.CheckpointManager(config.model_dir,
                                   layout_stamp=trainer.layout_stamp())
  if checkpoint_path:
    state = mgr.restore(int(os.path.basename(
        os.path.normpath(checkpoint_path))))
  else:
    state = mgr.restore_latest()
    if state is None:
      raise FileNotFoundError('no checkpoint under %s' % config.model_dir)
  trainer.load_state_dict(state)
  return trainer


def train_and_evaluate(pipeline_config: ConfigOrPath,
                       edit_config_json: Optional[dict] = None,
                       continue_train: bool = False,
                       fit_on_eval: bool = False,
                       fit_on_eval_steps: int = 0,
                       device=None) -> Dict:
  """Train, resuming from model_dir's latest checkpoint where there is
  one, evaluate on the eval input, and export per export_config.

  fit_on_eval: after training, train on the EVAL data (all of it, or
  fit_on_eval_steps batches) before the export. Returns the step count,
  the log history, this run's total losses and the eval metrics, the
  trainer, and export_dir where one was written."""
  from easyrec_torch.export.saved_model import export_saved_model
  from easyrec_torch.train.trainer import Trainer, to_device
  config = load_config(pipeline_config, edit_config_json)
  _prepare_model_dir(config, continue_train)
  trainer = Trainer(config, device=device)
  result = trainer.fit()

  if fit_on_eval and config.WhichOneof('eval_path'):
    steps = 0
    logging.info('fit_on_eval: continuing training on eval data')
    for batch in trainer.eval_input(
        batch_size=config.data_config.batch_size):
      trainer.train_step(to_device(batch, trainer.device))
      steps += 1
      if fit_on_eval_steps and steps >= fit_on_eval_steps:
        break
    result['global_step'] += steps
    logging.info('fit_on_eval: %d extra steps', steps)

  exporter_type = config.export_config.exporter_type or 'final'
  if exporter_type != 'none' and config.model_dir:
    result['export_dir'] = export_saved_model(
        trainer, os.path.join(config.model_dir, 'export', exporter_type),
        assets=list(config.export_config.asset_files))
    logging.info('exported serving model to %s', result['export_dir'])
  result['trainer'] = trainer
  return result


def evaluate(pipeline_config: ConfigOrPath,
             eval_result_filename: str = 'eval_result.txt',
             edit_config_json: Optional[dict] = None,
             device=None) -> Dict[str, float]:
  """Evaluate model_dir's latest checkpoint; the metrics also go to
  <model_dir>/<eval_result_filename> as json."""
  config = load_config(pipeline_config, edit_config_json)
  trainer = _restored_trainer(config, device)
  metrics = trainer.evaluate()
  with open(os.path.join(config.model_dir, eval_result_filename), 'w') as f:
    json.dump({k: float(v) for k, v in metrics.items()}, f)
  logging.info('eval result: %s', metrics)
  return metrics


def distribute_evaluate(pipeline_config: ConfigOrPath, **kwargs):
  """evaluate(): one device evaluates the whole eval input."""
  return evaluate(pipeline_config, **kwargs)


def export(pipeline_config: ConfigOrPath,
           export_dir: Optional[str] = None,
           checkpoint_path: Optional[str] = None,
           edit_config_json: Optional[dict] = None,
           big_model: bool = False,
           device=None) -> str:
  """Export a serving bundle from model_dir's latest checkpoint, or the
  one checkpoint_path names, into export_dir (default
  <model_dir>/export/final); returns the bundle's path. big_model, the
  JAX package's memory-mapped KV-store export, is not ported."""
  from easyrec_torch.export.saved_model import export_saved_model
  if big_model:
    raise NotImplementedError(
        'big_model export (export/big_model.py, a memory-mapped KV store '
        'of the tables) is not ported')
  config = load_config(pipeline_config, edit_config_json)
  trainer = _restored_trainer(config, device, checkpoint_path)
  base = export_dir or os.path.join(config.model_dir, 'export', 'final')
  return export_saved_model(trainer, base,
                            assets=list(config.export_config.asset_files))


@torch.no_grad()
def predict(pipeline_config: ConfigOrPath,
            input_path: Optional[str] = None,
            output_path: Optional[str] = None,
            edit_config_json: Optional[dict] = None,
            device=None) -> List[Dict]:
  """Predict input_path (default: the eval input) with model_dir's latest
  checkpoint: a list of {output: value} for every row that is not padding
  (sample_weight 0), also written as CSV with sorted keys to output_path.
  As the JAX package's predict, the forward reads the live parameters,
  not eval_params()."""
  from easyrec_torch.data.input_pipeline import InputPipeline
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.train.trainer import to_device
  config = load_config(pipeline_config, edit_config_json)
  input_path = input_path or config_util.get_eval_input_path(config)
  trainer = _restored_trainer(config, device)
  pipe = InputPipeline(config.data_config, trainer.feature_configs,
                       input_path, mode='predict')
  model = trainer.model
  model.eval()
  rows = []
  for batch in pipe:
    valid = batch['sample_weight'] > 0
    dev = to_device(batch, trainer.device)
    packs = emb_ops.pack_ids(trainer.layout, dev)
    pulled = emb_ops.pull_embeddings(trainer.tables, packs, trainer.metas)
    res = {k: v.cpu().numpy()
           for k, v in model.export_outputs(model(dev, pulled)).items()}
    keys = sorted(res)
    for i in np.nonzero(valid)[0]:
      rows.append({k: res[k][i] for k in keys})
  if output_path:
    with open(output_path, 'w', newline='') as f:
      writer = csv_lib.writer(f)
      keys = sorted(rows[0]) if rows else []
      writer.writerow(keys)
      for row in rows:
        writer.writerow([row[k] for k in keys])
  return rows
