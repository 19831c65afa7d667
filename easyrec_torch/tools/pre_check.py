"""Check a pipeline config and a few batches of its data before training.

Counterpart of easyrec_tpu/tools/pre_check.py, with its messages: every
feature's inputs are input fields and its config builds a feature spec;
the label and sample_weight fields exist; model_class is a model of the
port; every feature group names known features; a field-interaction
model's stacked group has one embedding_dim; then the model's embedding
layout is built (the port's config refusals, config_util.check_ported,
are among its errors). check_data reads --data_batches batches of the
train input and reports non-finite values. It touches no model weights
and no device.

  python -m easyrec_torch.tools.pre_check --pipeline_config_path cfg \
      [--data_batches 2]
"""

from __future__ import annotations

import argparse
import logging
from typing import List


def check_config(pipeline_config) -> List[str]:
  """The problems found (empty when there are none)."""
  from easyrec_torch.config import config_util
  from easyrec_torch.features import feature_spec as fs
  from easyrec_torch.models import zoo  # noqa: F401 (registers)
  from easyrec_torch.utils.registry import MODELS

  problems = []
  dc = pipeline_config.data_config
  input_names = {f.input_name for f in dc.input_fields}
  feature_configs = config_util.get_feature_configs(pipeline_config)
  feature_names = set()
  for fc in feature_configs:
    name = fc.feature_name or (fc.input_names[0] if fc.input_names else '?')
    feature_names.add(name)
    for n in fc.input_names:
      if n not in input_names:
        problems.append('feature %r reads input %r which is not in '
                        'data_config.input_fields' % (name, n))
    try:
      fs.build_feature_spec(fc)
    except Exception as e:
      problems.append('feature %r is invalid: %s' % (name, e))
  for label in dc.label_fields:
    if label not in input_names:
      problems.append('label field %r not in input_fields' % label)
  if dc.sample_weight and dc.sample_weight not in input_names:
    problems.append('sample_weight %r not in input_fields' %
                    dc.sample_weight)
  mc = pipeline_config.model_config
  if mc.model_class not in MODELS:
    problems.append('unknown model_class %r (known: %s)' %
                    (mc.model_class, MODELS.keys()))
  for g in mc.feature_groups:
    for fname in g.feature_names:
      if fname not in feature_names:
        problems.append('feature group %r references unknown feature %r' %
                        (g.group_name, fname))
  problems.extend(_check_stacked_group_dims(mc, feature_configs))
  if not problems:
    # the layout enforces the group-level rules (a deep feature needs an
    # embedding_dim), the port's refusals the rest
    try:
      from easyrec_torch.models import base as model_base
      config_util.check_ported(pipeline_config)
      specs = {}
      for fc in feature_configs:
        spec = fs.build_feature_spec(fc)
        specs[spec.name] = spec
      model_base.build_context(pipeline_config, specs)
    except Exception as e:
      problems.append('model/feature layout invalid: %s' % e)
  return problems


# model_class -> the groups whose stacked embeddings share one dim (FM,
# attention and SENet interactions run over a [B, F, D] stack); group None
# is the model's first group; 'categorical': only embedded id features
_STACKED_GROUPS = {
    'DeepFM': [('deep', 'categorical')],
    'FM': [('deep', 'categorical')],
    'AutoInt': [(None, 'categorical')],
    'DLRM': [('sparse', 'categorical')],
    'DSSM_SENet': [('user', 'categorical'), ('item', 'categorical')],
    'CMBF': [('text', 'categorical')],
    'Uniter': [('text', 'categorical')],
}


def _check_stacked_group_dims(mc, feature_configs) -> List[str]:
  from easyrec_torch.features import feature_spec as fs
  if mc.model_class not in _STACKED_GROUPS:
    return []
  specs = {}
  for fc in feature_configs:
    try:
      spec = fs.build_feature_spec(fc)
    except Exception:
      continue                          # reported by the caller already
    specs[spec.name] = spec
  groups = {g.group_name: list(g.feature_names) for g in mc.feature_groups}
  problems = []
  for group_name, kind in _STACKED_GROUPS[mc.model_class]:
    if group_name not in groups:
      if group_name is None or not groups:
        names = next(iter(groups.values()), [])
      else:
        continue                        # the layout check reports it
    else:
      names = groups[group_name]
    dims = {}
    for n in names:
      spec = specs.get(n)
      if spec is not None and spec.kind == kind and spec.embedding_dim:
        dims.setdefault(int(spec.embedding_dim), []).append(n)
    if len(dims) > 1:
      problems.append(
          '%s stacks group %r for field interactions, which needs one '
          'shared embedding_dim, but got %s' %
          (mc.model_class, group_name or 'first',
           {d: v for d, v in sorted(dims.items())}))
  return problems


def check_data(pipeline_config, num_batches: int = 2) -> List[str]:
  """Read a few batches of the train input; report what fails."""
  import numpy as np
  problems = []
  try:
    from easyrec_torch.config import config_util
    from easyrec_torch.data.input_pipeline import InputPipeline
    pipe = InputPipeline(
        pipeline_config.data_config,
        config_util.get_feature_configs(pipeline_config),
        config_util.get_train_input_path(pipeline_config), mode='train')
    it = iter(pipe)
    for i in range(num_batches):
      batch = next(it, None)
      if batch is None:
        problems.append('training data exhausted after %d batches' % i)
        break
      for k, v in batch.items():
        arr = np.asarray(v)
        if arr.dtype.kind == 'f' and not np.isfinite(arr).all():
          problems.append('batch %d: column %r has non-finite values' %
                          (i, k))
  except Exception as e:
    problems.append('failed to read training data: %s' % e)
  return problems


def main(argv=None):
  logging.basicConfig(level=logging.INFO)
  parser = argparse.ArgumentParser()
  parser.add_argument('--pipeline_config_path', required=True)
  parser.add_argument('--data_batches', type=int, default=2)
  args = parser.parse_args(argv)
  from easyrec_torch.config import config_util
  config = config_util.get_configs_from_pipeline_file(
      args.pipeline_config_path)
  problems = check_config(config)
  if not problems:
    problems += check_data(config, args.data_batches)
  if problems:
    for p in problems:
      logging.error('PRECHECK FAIL: %s', p)
    return 1
  logging.info('pre-check passed')
  return 0


if __name__ == '__main__':
  import sys
  sys.exit(main())
