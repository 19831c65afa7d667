"""Driver API: train_and_evaluate.

Counterpart of easyrec_tpu/main.py train_and_evaluate (:58). Checkpoints
and export are not ported yet: the call returns the step count, every
step's total loss and the eval metrics.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

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


def train_and_evaluate(pipeline_config: ConfigOrPath,
                       edit_config_json: Optional[dict] = None,
                       device=None) -> Dict:
  """Train, then evaluate on the eval input. `device` defaults to CUDA;
  pass 'cpu' to run on the CPU."""
  from easyrec_torch.train.trainer import Trainer
  config = load_config(pipeline_config, edit_config_json)
  trainer = Trainer(config, device=device)
  result = trainer.fit()
  result['trainer'] = trainer
  return result
