"""The multi-process dry-run matrix.

Counterpart of easyrec_tpu/utils/dryrun.py (:1-208). Each case builds the
real pipeline (CSV reader, transforms, the sampler's splice) and runs one
training step and an evaluate in a world of processes, so the paths a
multi-GPU job runs are driven end to end: row-sharded tables with EV
admission, the DIN sequence group's attention, MMoE's towers and the
negative sampler feeding the in-batch softmax. run_matrix runs every case
at the world size asked for and at the one below it where that is not
a power of two (4 and 3, where the JAX package runs 8 and 6), whose row
split differs (parallel/mesh.py row_split).

    python -m easyrec_torch.utils.dryrun --world 4 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np

_BASE = """
train_input_path: "{train}"
eval_input_path: "{train}"
model_dir: ""
train_config {{
  optimizer_config {{
    adam_optimizer {{
      learning_rate {{ constant_learning_rate {{ learning_rate: 0.01 }} }}
    }}
  }}
  num_steps: 1
}}
eval_config {{ metrics_set {{ auc {{}} }} }}
data_config {{
  batch_size: {batch}
  label_fields: "label"
  input_fields {{ input_name: "label" input_type: FLOAT }}
  input_fields {{ input_name: "uid" input_type: STRING }}
  input_fields {{ input_name: "iid" input_type: STRING }}
  input_fields {{ input_name: "cate" input_type: STRING }}
  input_fields {{ input_name: "seq_cate" input_type: STRING }}
  input_type: CSVInput
  {sampler}
}}
feature_config {{
  features {{ input_names: "uid" feature_type: IdFeature
             embedding_dim: 8 hash_bucket_size: 200 {ev} }}
  features {{ input_names: "iid" feature_type: IdFeature
             embedding_dim: 8 hash_bucket_size: 200 }}
  features {{ input_names: "cate" feature_type: IdFeature
             embedding_dim: 8 hash_bucket_size: 64 }}
  features {{ input_names: "seq_cate" feature_type: SequenceFeature
             embedding_dim: 8 hash_bucket_size: 64 max_seq_len: 6 }}
}}
model_config {{
{body}
}}
"""

_DEEPFM_EV_BODY = """
  model_class: "DeepFM"
  feature_groups { group_name: "deep" feature_names: "uid"
                   feature_names: "iid" feature_names: "cate"
                   wide_deep: DEEP }
  feature_groups { group_name: "wide" feature_names: "iid"
                   wide_deep: WIDE }
  deepfm { dnn { hidden_units: [16, 8] use_bn: false }
           final_dnn { hidden_units: [8] use_bn: false } }
"""

_DIN_SEQ_BODY = """
  model_class: "DeepFM"
  feature_groups {
    group_name: "deep"
    feature_names: "uid" feature_names: "iid" feature_names: "cate"
    wide_deep: DEEP
    sequence_features {
      group_name: "seq"
      seq_att_map { key: "cate" hist_seq: "seq_cate" }
    }
  }
  feature_groups { group_name: "wide" feature_names: "iid"
                   wide_deep: WIDE }
  deepfm { dnn { hidden_units: [16, 8] use_bn: false }
           final_dnn { hidden_units: [8] use_bn: false } }
"""

_MMOE_BODY = """
  model_class: "MMoE"
  feature_groups { group_name: "all" feature_names: "uid"
                   feature_names: "iid" feature_names: "cate"
                   wide_deep: DEEP }
  mmoe {
    expert_dnn { hidden_units: [16] use_bn: false }
    num_expert: 2
    task_towers { tower_name: "ctr" label_name: "label"
                  dnn { hidden_units: [8] use_bn: false } num_class: 1
                  loss_type: CLASSIFICATION weight: 1.0
                  metrics_set { auc {} } }
    task_towers { tower_name: "cvr" label_name: "label"
                  dnn { hidden_units: [8] use_bn: false } num_class: 1
                  loss_type: CLASSIFICATION weight: 1.0
                  metrics_set { auc {} } }
  }
"""

_DSSM_BODY = """
  model_class: "DSSM"
  feature_groups { group_name: "user" feature_names: "uid"
                   feature_names: "seq_cate" wide_deep: DEEP }
  feature_groups { group_name: "item" feature_names: "iid"
                   feature_names: "cate" wide_deep: DEEP }
  dssm {
    user_tower { id: "uid" dnn { hidden_units: [16, 8] use_bn: false } }
    item_tower { id: "iid" dnn { hidden_units: [16, 8] use_bn: false } }
    simi_func: INNER_PRODUCT
  }
  loss_type: SOFTMAX_CROSS_ENTROPY
"""

_SAMPLER = """
  negative_sampler {{
    input_path: "{items}"
    num_sample: 8
    attr_fields: "iid"
    attr_fields: "cate"
    item_id_field: "iid"
  }}
"""


def write_data(d: str, rows: int = 512):
  """The JAX matrix's train CSV and items table (the same rows from the
  same seed)."""
  rng = np.random.default_rng(0)
  train = os.path.join(d, 'train.csv')
  with open(train, 'w') as f:
    for _ in range(rows):
      n = rng.integers(1, 6)
      f.write('%d,u%d,i%d,c%d,%s\n' % (
          rng.integers(0, 2), rng.integers(0, 40), rng.integers(0, 40),
          rng.integers(0, 8),
          '|'.join('c%d' % c for c in rng.integers(0, 8, n))))
  items = os.path.join(d, 'items.txt')
  with open(items, 'w') as f:
    f.write('id:int64\tweight:float\tfeature:string\n')
    for i in range(40):
      f.write('i%d\t1.0\ti%d:c%d\n' % (i, i, i % 8))
  return train, items


def matrix_cases():
  """name -> (model body, ev_params of uid, sampler flag, environment)."""
  return {
      'packed_ev': (_DEEPFM_EV_BODY, 'ev_params { filter_freq: 2 }', '',
                    {'EASYREC_PACKED_TABLES': '1'}),
      'din_seq_group': (_DIN_SEQ_BODY, '', '', {}),
      'mmoe': (_MMOE_BODY, '', '', {}),
      'dssm_sampler': (_DSSM_BODY, '', 'sampler', {}),
  }


def case_config(name: str, directory: str, batch: int) -> str:
  """The pipeline config text of case `name` over data written into
  `directory`."""
  body, ev, sampler_flag, _env = matrix_cases()[name]
  train, items = write_data(directory)
  sampler = _SAMPLER.format(items=items) if sampler_flag else ''
  return _BASE.format(train=train, batch=batch, sampler=sampler, ev=ev,
                      body=body)


def run_case(world, name: str, batch: int, state: Optional[dict] = None,
             rows: Optional[Dict[str, np.ndarray]] = None) -> dict:
  """One matrix case on this rank of `world`: a Trainer over the case's
  CSV pipeline (each rank its shard, `batch` rows a rank), one training
  step and an evaluate of two batches. With `state` (a whole state_dict)
  the trainer starts from it; with `rows` it first trains a step on those
  rows. Returns the first step's losses, the pipeline step's, the eval
  metrics and whether the EV plan is on."""
  from easyrec_torch.config import config_util
  from easyrec_torch.train.trainer import Trainer
  d = tempfile.mkdtemp(prefix='dryrun_%s_' % name)
  cfg = config_util.get_configs_from_pipeline_str(
      case_config(name, d, batch))
  trainer = Trainer(cfg, world=world)
  trainer.init_state()
  if state is not None:
    trainer.load_state_dict(state)
  out = {'ev': bool(trainer.ev_plan), 'device': str(trainer.device)}
  if rows is not None:
    out['losses'] = {k: float(v) for k, v in
                     trainer.step_batch(rows).items()}
  step = {k: float(v) for k, v in trainer.step_batch(
      next(iter(trainer.train_input()))).items()}
  out.setdefault('losses', step)
  out['pipeline_losses'] = step
  for losses in (out['losses'], step):
    if not np.isfinite(losses['total_loss']):
      raise FloatingPointError('%s: non-finite loss %s' % (name, losses))
  out['eval'] = trainer.evaluate(max_batches=2)
  return out


def matrix_worker(world, batch: int, names=None) -> dict:
  """Every case (or `names`) on this rank, with each case's environment."""
  out = {}
  for name in names or matrix_cases():
    env = matrix_cases()[name][3]
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
      out[name] = run_case(world, name, batch)
    finally:
      for k, v in saved.items():
        if v is None:
          os.environ.pop(k, None)
        else:
          os.environ[k] = v
  return out


def run_matrix(world_size: int, device: str = 'cpu',
               timeout_s: float = 600.0) -> dict:
  """All cases in a world of world_size processes and, where world_size -
  1 is not a power of two, of that size too; {case@size: rank 0's
  loss}. The batch a rank divides both sizes' global batches alike:
  24 rows a rank."""
  from easyrec_torch.parallel import launch
  sizes = [world_size]
  if world_size > 3 and (world_size - 1) & (world_size - 2):
    sizes.append(world_size - 1)
  results = {}
  for size in sizes:
    ranks = launch.spawn('easyrec_torch.utils.dryrun:matrix_worker', [24],
                         size, device=device, timeout_s=timeout_s)
    for case, res in ranks[0].items():
      results['%s@%d' % (case, size)] = res['losses']['total_loss']
  return results


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__)
  ap.add_argument('--world', type=int, default=4)
  ap.add_argument('--device', default='cuda',
                  help="'cuda' (default; one card a rank) or 'cpu'")
  args = ap.parse_args(argv)
  print(json.dumps(run_matrix(args.world, args.device), sort_keys=True))
  return 0


if __name__ == '__main__':
  raise SystemExit(main())
