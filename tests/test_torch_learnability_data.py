"""The learnability gates' data, Bayes bars and configs, free of JAX.

A copy of what the JAX package's gates read: `tests/test_learnability.py`
(the one dataset of rank, sequence and multi-task labels; MIND's
multi-interest generator) and `tests/test_learnability_extra.py` (the
two-tower, PDN and cross-modal labels; DAT's preference generator), with
the same seeds, sizes, margins and configs. Both this repo's CPU gates
(`tests/test_torch_learnability_*.py`) and `chip_smoke.py`'s gates on the
card read it; the card's machine has no JAX, so nothing here imports JAX
or easyrec_tpu. `tests/test_torch_learnability_copy.py` holds every
generator's bytes and every Bayes number to the originals.

No test is defined here: `run_gate` trains one gate's config with the
port's Trainer on the device it is given and returns its eval metrics.
"""

import os
import time
import zlib

import numpy as np

# ---- tests/test_learnability.py -------------------------------------

N_UID, N_IID, N_CATE = 32, 32, 12
MAX_SEQ = 8


def _signs(rng, n):
  return rng.choice([-1.0, 1.0], n)


def _auc_of_probs(vals, mass):
  """Exact AUC of the Bayes-optimal scorer for a label drawn Bern(p)
  with p taking `vals` with probability `mass`: rank by p, positives
  contribute mass*p, negatives mass*(1-p); ties count half."""
  order = np.argsort(vals)
  vals, mass = np.asarray(vals, np.float64)[order], \
      np.asarray(mass, np.float64)[order]
  a = mass * vals
  b = mass * (1.0 - vals)
  cum_b = np.concatenate([[0.0], np.cumsum(b)[:-1]])
  return float((np.sum(a * cum_b) + 0.5 * np.sum(a * b)) /
               (np.sum(a) * np.sum(b)))


def bayes_aucs():
  """Closed-form Bayes-optimal AUC per synthetic label, from the fixed
  signal tables make_csv uses."""
  srng = np.random.default_rng(99)
  s_i, s_c = _signs(srng, N_IID), _signs(srng, N_CATE)
  s_u, s_k = _signs(srng, N_UID), _signs(srng, N_CATE)
  out = {}
  lint = 1 / (1 + np.exp(-2.8 * np.outer(s_i, s_c).ravel()))
  out['lint'] = _auc_of_probs(lint, np.full(lint.size, 1.0 / lint.size))
  lctr = 1 / (1 + np.exp(-2.2 * s_u))
  out['lctr'] = _auc_of_probs(lctr, np.full(lctr.size, 1.0 / lctr.size))
  lcvr = 1 / (1 + np.exp(-2.2 * s_k))
  out['lcvr'] = _auc_of_probs(lcvr, np.full(lcvr.size, 1.0 / lcvr.size))
  # lseq: p=0.85 iff cate in seq; seq elements uniform, L uniform 1..MAX
  ls = np.arange(1, MAX_SEQ + 1)
  p_member = float(np.mean(1 - (1 - 1.0 / N_CATE) ** ls))
  out['lseq'] = _auc_of_probs([0.85, 0.15], [p_member, 1 - p_member])
  return out


BAYES = bayes_aucs()  # {'lint': ~0.943, 'lseq': ~0.826, 'lctr'/'lcvr': ~0.90}

# margins below the Bayes AUC: 0.03 covers finite-eval noise (4096 rows:
# AUC std ~0.007) and short-run convergence; ESMM's cvr tower trains
# through pCTR*pCVR and cannot reach the plain-cvr bound
MARGIN = {
    'rank': 0.03,
    'seq': 0.03,
    'mt': 0.03,
    'esmm_cvr': 0.08,
}


def make_csv(path, n, seed):
  rng = np.random.default_rng(seed)
  srng = np.random.default_rng(99)          # signal tables: fixed across files
  s_i, s_c = _signs(srng, N_IID), _signs(srng, N_CATE)
  s_u, s_k = _signs(srng, N_UID), _signs(srng, N_CATE)
  with open(path, 'w') as f:
    for _ in range(n):
      uid = rng.integers(0, N_UID)
      iid = rng.integers(0, N_IID)
      cate = rng.integers(0, N_CATE)
      L = rng.integers(1, MAX_SEQ + 1)
      seq = rng.integers(0, N_CATE, L)
      p_int = 1 / (1 + np.exp(-2.8 * s_i[iid] * s_c[cate]))
      p_seq = 0.85 if cate in seq else 0.15
      p_ctr = 1 / (1 + np.exp(-2.2 * s_u[uid]))
      p_cvr = 1 / (1 + np.exp(-2.2 * s_k[cate]))
      lint = int(rng.random() < p_int)
      lseq = int(rng.random() < p_seq)
      lctr = int(rng.random() < p_ctr)
      lcvr = int(rng.random() < p_cvr)
      d1, d2 = rng.random(), rng.random()
      f.write('%d,%d,%d,%d,u%d,i%d,c%d,%s,%.4f,%.4f\n' % (
          lint, lseq, lctr, lcvr, uid, iid, cate,
          '|'.join('c%d' % s for s in seq), d1, d2))


CONFIG = """
train_input_path: "{train}"
eval_input_path: "{eval}"
model_dir: ""
train_config {{
  log_step_count_steps: 100
  optimizer_config {{
    adam_optimizer {{
      learning_rate {{ constant_learning_rate {{ learning_rate: 0.02 }} }}
    }}
  }}
  num_steps: {num_steps}
  save_checkpoints_steps: 100000
}}
eval_config {{ {metrics} }}
data_config {{
  batch_size: 256
  label_fields: {label_fields}
  input_fields {{ input_name: "lint" input_type: FLOAT }}
  input_fields {{ input_name: "lseq" input_type: FLOAT }}
  input_fields {{ input_name: "lctr" input_type: FLOAT }}
  input_fields {{ input_name: "lcvr" input_type: FLOAT }}
  input_fields {{ input_name: "uid" input_type: STRING }}
  input_fields {{ input_name: "iid" input_type: STRING }}
  input_fields {{ input_name: "cate" input_type: STRING }}
  input_fields {{ input_name: "seq_cate" input_type: STRING }}
  input_fields {{ input_name: "d1" input_type: FLOAT }}
  input_fields {{ input_name: "d2" input_type: FLOAT }}
  input_type: CSVInput
}}
feature_config {{
  features {{ input_names: "uid" feature_type: IdFeature
              embedding_dim: 8 hash_bucket_size: 3000 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "iid" feature_type: IdFeature
              embedding_dim: 8 hash_bucket_size: 3000 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "cate" feature_type: IdFeature
              embedding_dim: 8 hash_bucket_size: 1200 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "seq_cate" feature_type: SequenceFeature
              embedding_dim: 8 hash_bucket_size: 1200 max_seq_len: 8 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "d1" feature_type: RawFeature embedding_dim: 8 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "d2" feature_type: RawFeature embedding_dim: 8 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
}}
model_config {{
{model_body}
}}
"""

AUC_METRIC = 'metrics_set { auc {} }'

RANK_GROUPS = """
  feature_groups {
    group_name: "deep"
    feature_names: "uid" feature_names: "iid" feature_names: "cate"
    feature_names: "d1" feature_names: "d2"
    wide_deep: DEEP
  }
"""

RANK_BODIES = {
    'FM': """
  model_class: "FM"
  feature_groups {
    group_name: "deep"
    feature_names: "iid" feature_names: "cate" wide_deep: DEEP
  }
  feature_groups {
    group_name: "wide"
    feature_names: "iid" feature_names: "cate" wide_deep: WIDE
  }
  fm {}
""",
    'DCN': RANK_GROUPS + """
  model_class: "DCN"
  dcn {
    deep_tower { input: "deep" dnn { hidden_units: [32, 16] use_bn: false } }
    cross_tower { input: "deep" cross_num: 3 }
    final_dnn { hidden_units: [16] use_bn: false }
  }
""",
    'AutoInt': RANK_GROUPS + """
  model_class: "AutoInt"
  autoint {
    multi_head_num: 2
    multi_head_size: 8
    interacting_layer_num: 2
    final_dnn { hidden_units: [16] use_bn: false }
  }
""",
    'DLRM': RANK_GROUPS.replace('group_name: "deep"',
                                'group_name: "sparse"')
                       .replace('feature_names: "d1" '
                                'feature_names: "d2"\n', '') + """
  feature_groups {
    group_name: "dense"
    feature_names: "d1" feature_names: "d2" wide_deep: DEEP
  }
  model_class: "DLRM"
  dlrm {
    bot_dnn { hidden_units: [16, 8] use_bn: false }
    top_dnn { hidden_units: [32, 16] use_bn: false }
  }
""",
    'WideAndDeep': RANK_GROUPS + """
  feature_groups {
    group_name: "wide"
    feature_names: "iid" feature_names: "cate" wide_deep: WIDE
  }
  model_class: "WideAndDeep"
  wide_and_deep {
    dnn { hidden_units: [32, 16] use_bn: false }
    final_dnn { hidden_units: [16] use_bn: false }
  }
""",
    'MultiTower': """
  model_class: "MultiTower"
  feature_groups {
    group_name: "item" feature_names: "iid" feature_names: "cate"
    wide_deep: DEEP
  }
  feature_groups {
    group_name: "user" feature_names: "uid" feature_names: "d1"
    wide_deep: DEEP
  }
  multi_tower {
    towers { input: "item" dnn { hidden_units: [32, 16] use_bn: false } }
    towers { input: "user" dnn { hidden_units: [16] use_bn: false } }
    final_dnn { hidden_units: [16] use_bn: false }
  }
""",
    'MaskNet': RANK_GROUPS + """
  model_class: "RankModel"
  backbone {
    blocks {
      name: "feat"
      inputs { feature_group_name: "deep" }
      input_layer { do_layer_norm: true }
    }
    blocks {
      name: "masknet"
      inputs { block_name: "feat" }
      keras_layer {
        class_name: "MaskNet"
        masknet {
          mask_blocks { output_size: 32 reduction_factor: 1.0 }
          mask_blocks { output_size: 32 reduction_factor: 1.0 }
          mlp { hidden_units: [16] }
        }
      }
    }
    top_mlp { hidden_units: [16] }
  }
""",
    'FiBiNet': RANK_GROUPS + """
  model_class: "RankModel"
  backbone {
    blocks {
      name: "feat"
      inputs { feature_group_name: "deep" }
      input_layer { only_output_3d_tensor: true }
    }
    blocks {
      name: "fibinet"
      inputs { block_name: "feat" }
      keras_layer {
        class_name: "FiBiNet"
        fibinet {
          senet { reduction_ratio: 2 }
          bilinear { type: "each" num_output_units: 16 }
          mlp { hidden_units: [32, 16] }
        }
      }
    }
    top_mlp { hidden_units: [16] }
  }
""",
}

SEQ_BODIES = {
    'MultiTowerDIN': """
  model_class: "MultiTowerDIN"
  feature_groups {
    group_name: "item" feature_names: "iid" feature_names: "cate"
    wide_deep: DEEP
  }
  feature_groups {
    group_name: "user" feature_names: "uid" wide_deep: DEEP
  }
  seq_att_groups {
    group_name: "din"
    seq_att_map { key: "cate" hist_seq: "seq_cate" }
  }
  multi_tower {
    towers { input: "item" dnn { hidden_units: [16] use_bn: false } }
    towers { input: "user" dnn { hidden_units: [16] use_bn: false } }
    din_towers { input: "din" dnn { hidden_units: [16] use_bn: false } }
    final_dnn { hidden_units: [16] use_bn: false }
  }
""",
    'MultiTowerBST': """
  model_class: "MultiTowerBST"
  feature_groups {
    group_name: "item" feature_names: "iid" feature_names: "cate"
    wide_deep: DEEP
  }
  feature_groups {
    group_name: "user" feature_names: "uid" wide_deep: DEEP
  }
  seq_att_groups {
    group_name: "bst"
    seq_att_map { key: "cate" hist_seq: "seq_cate" }
  }
  multi_tower {
    towers { input: "item" dnn { hidden_units: [16] use_bn: false } }
    towers { input: "user" dnn { hidden_units: [16] use_bn: false } }
    bst_towers {
      input: "bst"
      seq_len: 8
      multi_head_size: 2
    }
    final_dnn { hidden_units: [16] use_bn: false }
  }
""",
}

MT_GROUPS = """
  feature_groups {
    group_name: "all"
    feature_names: "uid" feature_names: "iid" feature_names: "cate"
    wide_deep: DEEP
  }
"""

MT_TOWERS = """
    task_towers {
      tower_name: "ctr" label_name: "lctr"
      dnn { hidden_units: [16] use_bn: false }
    }
    task_towers {
      tower_name: "cvr" label_name: "lcvr"
      dnn { hidden_units: [16] use_bn: false }
    }
"""

MT_BODIES = {
    'MMoE': MT_GROUPS + """
  model_class: "MMoE"
  mmoe {
    expert_dnn { hidden_units: [32, 16] use_bn: false }
    num_expert: 3
""" + MT_TOWERS + '  }\n',
    'PLE': MT_GROUPS + """
  model_class: "PLE"
  ple {
    extraction_networks {
      network_name: "layer1"
      expert_num_per_task: 2
      share_num: 2
      task_expert_net { hidden_units: [32, 16] use_bn: false }
      share_expert_net { hidden_units: [32, 16] use_bn: false }
    }
""" + MT_TOWERS + '  }\n',
    'SimpleMultiTask': MT_GROUPS + """
  model_class: "SimpleMultiTask"
  simple_multi_task {
""" + MT_TOWERS + '  }\n',
    'DBMTL': MT_GROUPS + """
  model_class: "DBMTL"
  dbmtl {
    bottom_dnn { hidden_units: [32] use_bn: false }
    expert_dnn { hidden_units: [16] use_bn: false }
    num_expert: 3
    task_towers {
      tower_name: "ctr" label_name: "lctr"
      dnn { hidden_units: [16] use_bn: false }
    }
    task_towers {
      tower_name: "cvr" label_name: "lcvr"
      dnn { hidden_units: [16] use_bn: false }
      relation_tower_names: "ctr"
      relation_dnn { hidden_units: [8] use_bn: false }
    }
  }
""",
}

ESMM_BODY = MT_GROUPS + """
  model_class: "ESMM"
  esmm {
    groups { input: "all" dnn { hidden_units: [32, 16] use_bn: false } }
    ctr_tower { tower_name: "ctr" label_name: "lctr"
                dnn { hidden_units: [16] use_bn: false } }
    cvr_tower { tower_name: "cvr" label_name: "lcvr"
                dnn { hidden_units: [16] use_bn: false } }
  }
"""

# The flagship model at the gates' size, which the JAX package does not
# gate: RANK_GROUPS' deep group, a wide group of iid and cate, DNN [32, 16]
# and final [16]. Its DNNs are what a bf16 compute_dtype runs in bf16.
DEEPFM_BODY = RANK_GROUPS + """
  feature_groups {
    group_name: "wide"
    feature_names: "iid" feature_names: "cate" wide_deep: WIDE
  }
  model_class: "DeepFM"
  deepfm {
    dnn { hidden_units: [32, 16] use_bn: false }
    final_dnn { hidden_units: [16] use_bn: false }
  }
"""

def _midrank_auc(scores, labels):
  """AUC of `scores` against 0/1 `labels`, ties counted half."""
  _, inv, cnt = np.unique(scores, return_inverse=True, return_counts=True)
  ranks = (np.cumsum(cnt) - (cnt - 1) / 2.0)[inv]
  pos = labels.sum()
  neg = labels.size - pos
  return (ranks[labels == 1].sum() - pos * (pos + 1) / 2.0) / (pos * neg)


def lint_order_spread(eval_path, draws=500, seed=0):
  """The std of the lint AUC on make_csv's file `eval_path` of a scorer
  that ranks lint's two Bayes levels apart and orders the (iid, cate)
  cells inside each level at random, over `draws` orders. Two converged
  models that differ only in those orders (as a model trained on the card
  and one trained on the CPU, from other initial tables) read about
  sqrt(2) times it apart."""
  srng = np.random.default_rng(99)
  s_i, s_c = _signs(srng, N_IID), _signs(srng, N_CATE)
  with open(eval_path) as f:
    rows = [line.split(',') for line in f]
  labels = np.array([int(r[0]) for r in rows])
  iid = np.array([int(r[5][1:]) for r in rows])
  cate = np.array([int(r[6][1:]) for r in rows])
  level = s_i[iid] * s_c[cate]
  rng = np.random.default_rng(seed)
  aucs = [_midrank_auc(level + 1e-3 * rng.random((N_IID, N_CATE))[iid, cate],
                       labels) for _ in range(draws)]
  return float(np.std(aucs))


def gate_config(tmp, body, label_fields, metrics=AUC_METRIC, num_steps=250,
                n_train=16384, seed=5, lr=None, bf16=False, frozen=False):
  """test_learnability._train_eval's files and pipeline text: train and
  eval CSVs of make_csv under `tmp`; returns the config's path. `bf16`
  sets compute_dtype bfloat16, as test_bfloat16_compute_quality does;
  `frozen` sets the tables' learning rate to 0
  (embedding_learning_rate_multiplier): the sparse update still runs (K1
  + K2 or K3 on the card) but moves no weight, so a label learnable only
  through the id embeddings must then read under its bar."""
  train = data_file(tmp, make_csv, n_train, seed)
  evalp = data_file(tmp, make_csv, 4096, seed + 1)
  lf = '\n  label_fields: '.join('"%s"' % f for f in label_fields)
  text = CONFIG.format(train=train, eval=evalp, num_steps=num_steps,
                       metrics=metrics, label_fields=lf, model_body=body)
  if lr is not None:
    text = text.replace('learning_rate: 0.02', 'learning_rate: %g' % lr)
  if bf16:
    text = text.replace('num_steps: %d' % num_steps, 'num_steps: %d\n'
                        '  compute_dtype: "bfloat16"' % num_steps)
  if frozen:
    text = text.replace('  optimizer_config {\n', '  optimizer_config {\n'
                        '    embedding_learning_rate_multiplier: 0\n', 1)
  return write_config(tmp, text)


def data_file(tmp, make, n, seed):
  """make(path, n, seed)'s file under `tmp`, written once: the gates that
  share a generator, size and seed share the file."""
  os.makedirs(str(tmp), exist_ok=True)
  path = os.path.join(str(tmp), '%s_%d_%d.csv' % (make.__name__, n, seed))
  if not os.path.exists(path):
    make(path, n, seed)
  return path


def write_config(tmp, text):
  """`text` as a config file under `tmp`, named by its checksum: gates
  that share `tmp` keep their own configs."""
  path = os.path.join(str(tmp), 'pipeline-%08x.config' % zlib.crc32(
      text.encode()))
  with open(path, 'w') as f:
    f.write(text)
  return path


def one_thread():
  """The gate modules' fixture body (each wraps it with pytest.fixture,
  autouse and module-scoped): one torch thread while the module's gates
  train, so the test workers do not oversubscribe the CPU."""
  import torch
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def run_gate(path, device='cpu'):
  """Train the pipeline at `path` with the port's Trainer on `device` (no
  checkpoint), as the JAX gates' Trainer(cfg).fit(checkpoint=False).
  Returns (eval metrics, the Trainer, the fit's result, seconds)."""
  from easyrec_torch.config import config_util
  from easyrec_torch.train.trainer import Trainer
  cfg = config_util.get_configs_from_pipeline_file(path)
  t0 = time.time()
  trainer = Trainer(cfg, device=device)
  result = trainer.fit(checkpoint=False)
  return result['eval_metrics'], trainer, result, time.time() - t0


# ---- MIND (tests/test_learnability.py) ------------------------------

MIND_CONFIG = """
train_input_path: "{train}"
eval_input_path: "{eval}"
model_dir: ""
train_config {{
  log_step_count_steps: 100
  optimizer_config {{
    adam_optimizer {{
      learning_rate {{ constant_learning_rate {{ learning_rate: 0.01 }} }}
    }}
  }}
  num_steps: {num_steps}
  save_checkpoints_steps: 100000
}}
eval_config {{ metrics_set {{ recall_at_topk {{ topk: 5 }} }} }}
data_config {{
  batch_size: 128
  label_fields: "label"
  input_fields {{ input_name: "label" input_type: FLOAT }}
  input_fields {{ input_name: "uid" input_type: STRING }}
  input_fields {{ input_name: "iid" input_type: STRING }}
  input_fields {{ input_name: "cate" input_type: STRING }}
  input_fields {{ input_name: "seq_cate" input_type: STRING }}
  input_type: CSVInput
}}
feature_config {{
  features {{ input_names: "uid" feature_type: IdFeature
              embedding_dim: 8 hash_bucket_size: 3000 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "iid" feature_type: IdFeature
              embedding_dim: 8 hash_bucket_size: 3000 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "cate" feature_type: IdFeature
              embedding_dim: 8 hash_bucket_size: 600 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "seq_cate" feature_type: SequenceFeature
              embedding_dim: 8 hash_bucket_size: 600 max_seq_len: 10 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
}}
model_config {{
  model_class: "MIND"
  feature_groups {{
    group_name: "user" feature_names: "uid" wide_deep: DEEP
  }}
  feature_groups {{
    group_name: "hist" feature_names: "seq_cate" wide_deep: DEEP
  }}
  feature_groups {{
    group_name: "item"
    feature_names: "iid" feature_names: "cate" wide_deep: DEEP
  }}
  mind {{
    user_dnn {{ hidden_units: [32, 16] use_bn: false }}
    item_dnn {{ hidden_units: [32, 16] use_bn: false }}
    concat_dnn {{ hidden_units: [16] use_bn: false }}
    capsule_config {{ max_k: 3 high_dim: 16 num_iters: 3 }}
    item_id: "iid"
    simi_pow: 10
  }}
  loss_type: SOFTMAX_CROSS_ENTROPY
}}
"""

N_MIND_CATES = 6
N_MIND_ITEMS = 48   # item i has cate i % 6


def _mind_interests(u):
  return (u % N_MIND_CATES, (u * 3 + 1) % N_MIND_CATES)


def make_mind_csv(path, n, seed):
  """All-positive (user, item) interactions; each user has TWO interest
  cates; history holds items from both interests (multi-interest signal)."""
  rng = np.random.default_rng(seed)
  by_cate = {c: [i for i in range(N_MIND_ITEMS) if i % N_MIND_CATES == c]
             for c in range(N_MIND_CATES)}
  with open(path, 'w') as f:
    for _ in range(n):
      u = rng.integers(0, 40)
      ints = _mind_interests(u)
      cate = ints[rng.integers(0, len(ints))]
      iid = by_cate[cate][rng.integers(0, len(by_cate[cate]))]
      L = rng.integers(3, 11)
      hist = [by_cate[ints[rng.integers(0, 2)]][
          rng.integers(0, len(by_cate[ints[0]]))] for _ in range(L)]
      f.write('1,u%d,i%d,c%d,%s\n' % (
          u, iid, iid % N_MIND_CATES,
          '|'.join('c%d' % (h % N_MIND_CATES) for h in hist)))


def _mind_bayes_recall5(eval_path):
  """Bayes ceiling of in-batch recall@5 on this generator, by simulation:
  history carries only cate signal and items are uniform within a cate,
  so the optimal scorer is the cate-match indicator with one tie-break per
  item; in-batch masking removes only copies of the row's own positive.
  Ceiling ~0.13; random floor ~0.05."""
  rows = []
  with open(eval_path) as f:
    for line in f:
      _, u, i, _, _ = line.strip().split(',', 4)
      rows.append((int(u[1:]), int(i[1:])))
  r = np.random.default_rng(0)
  noise = r.random(N_MIND_ITEMS) * 1e-6
  hits = tot = 0
  for s in range(0, len(rows) - 127, 128):
    bat = rows[s:s + 128]
    iids = np.array([x[1] for x in bat])
    for bi, (u, iid) in enumerate(bat):
      ints = set(_mind_interests(u))
      scores = np.array([(j % N_MIND_CATES) in ints for j in iids],
                        np.float64) + noise[iids]
      dup = iids == iid
      dup[bi] = False
      scores[dup] = -1e9
      hits += int((scores > scores[bi]).sum() < 5)
      tot += 1
  return hits / tot


MIND_FLOOR = 5.0 / 110  # 5 / (batch 128 - own-duplicate columns)


def mind_config(tmp, num_steps=300):
  """test_learnability._mind_train's files and config; returns the config
  path and the eval file's path."""
  train = data_file(tmp, make_mind_csv, 16384, 21)
  evalp = data_file(tmp, make_mind_csv, 2048, 22)
  text = MIND_CONFIG.format(train=train, eval=evalp, num_steps=num_steps)
  return write_config(tmp, text), evalp


def mind_gate(eval_path):
  return max(_mind_bayes_recall5(eval_path) - 0.035, MIND_FLOOR * 2)


# ---- tests/test_learnability_extra.py (its names prefixed X_) -------

X_N_UID, X_N_IID, X_N_CATE = 32, 48, 12
X_MAX_SEQ = 8
IMG_DIM = 16


def x_tables():
  srng = np.random.default_rng(77)
  return {
      's_u': _signs(srng, X_N_UID),
      's_i': _signs(srng, X_N_IID),
      'm_i': _signs(srng, X_N_IID),       # image modality sign per item
      's_c': _signs(srng, X_N_CATE),
      'img_base': srng.normal(size=IMG_DIM),
  }


def x_bayes():
  t = x_tables()
  out = {}
  twr = 1 / (1 + np.exp(-2.8 * np.outer(t['s_u'], t['s_i']).ravel()))
  out['ltwr'] = _auc_of_probs(twr, np.full(twr.size, 1.0 / twr.size))
  iids = np.arange(X_N_IID)
  img = 1 / (1 + np.exp(-2.8 * t['m_i'][iids] * t['s_c'][iids % X_N_CATE]))
  out['limg'] = _auc_of_probs(img, np.full(img.size, 1.0 / img.size))
  ls = np.arange(1, X_MAX_SEQ + 1)
  pm = float(np.mean(1 - (1 - 1.0 / X_N_CATE) ** ls))
  out['lpdn'] = _auc_of_probs([0.85, 0.15], [pm, 1 - pm])
  return out


X_BAYES = x_bayes()

X_MARGIN = {
    'two_tower': 0.03,
    'pdn': 0.03,
    'multimodal': 0.04,   # transformer towers converge slower at 250 steps
}


def make_extra_csv(path, n, seed):
  t = x_tables()
  rng = np.random.default_rng(seed)
  with open(path, 'w') as f:
    for _ in range(n):
      uid = rng.integers(0, X_N_UID)
      iid = rng.integers(0, X_N_IID)
      cate = iid % X_N_CATE
      L = rng.integers(1, X_MAX_SEQ + 1)
      seq = rng.integers(0, X_N_CATE, L)
      p_twr = 1 / (1 + np.exp(-2.8 * t['s_u'][uid] * t['s_i'][iid]))
      p_img = 1 / (1 + np.exp(-2.8 * t['m_i'][iid] * t['s_c'][cate]))
      p_pdn = 0.85 if cate in seq else 0.15
      ltwr = int(rng.random() < p_twr)
      limg = int(rng.random() < p_img)
      lpdn = int(rng.random() < p_pdn)
      yreg = 2.0 * t['s_u'][uid] * t['s_i'][iid] + 0.3 * rng.normal()
      img = t['m_i'][iid] * t['img_base'] + 0.3 * rng.normal(size=IMG_DIM)
      title = 't%d|t%d' % (rng.integers(0, 30), rng.integers(0, 30))
      f.write('%d,%.4f,%d,%d,u%d,i%d,c%d,s%d,%s,%s,%s\n' % (
          ltwr, yreg, lpdn, limg, uid, iid, cate, cate,
          '|'.join('%.3f' % v for v in img), title,
          '|'.join('c%d' % s for s in seq)))


EXTRA_CONFIG = """
train_input_path: "{train}"
eval_input_path: "{eval}"
model_dir: ""
train_config {{
  log_step_count_steps: 100
  optimizer_config {{
    adam_optimizer {{
      learning_rate {{ constant_learning_rate {{ learning_rate: {lr} }} }}
    }}
  }}
  num_steps: {num_steps}
  save_checkpoints_steps: 100000
}}
eval_config {{ {metrics} }}
data_config {{
  batch_size: 256
  label_fields: "{label}"
  input_fields {{ input_name: "ltwr" input_type: FLOAT }}
  input_fields {{ input_name: "yreg" input_type: FLOAT }}
  input_fields {{ input_name: "lpdn" input_type: FLOAT }}
  input_fields {{ input_name: "limg" input_type: FLOAT }}
  input_fields {{ input_name: "uid" input_type: STRING }}
  input_fields {{ input_name: "iid" input_type: STRING }}
  input_fields {{ input_name: "cate" input_type: STRING }}
  input_fields {{ input_name: "sess" input_type: STRING }}
  input_fields {{ input_name: "img_vec" input_type: STRING }}
  input_fields {{ input_name: "title" input_type: STRING }}
  input_fields {{ input_name: "seq_cate" input_type: STRING }}
  input_type: CSVInput
}}
feature_config {{
  features {{ input_names: "uid" feature_type: IdFeature
              embedding_dim: 8 hash_bucket_size: 3000 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "iid" feature_type: IdFeature
              embedding_dim: 8 hash_bucket_size: 3000 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "cate" feature_type: IdFeature
              embedding_dim: 8 hash_bucket_size: 1200 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "img_vec" feature_type: RawFeature
              raw_input_dim: {img_dim} separator: "|" }}
  features {{ input_names: "title" feature_type: TagFeature
              embedding_dim: 8 hash_bucket_size: 200 max_multi_len: 2 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "seq_cate" feature_type: SequenceFeature
              embedding_dim: 8 hash_bucket_size: 1200 max_seq_len: 8 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
}}
model_config {{
{model_body}
}}
"""

UI_GROUPS = """
  feature_groups {
    group_name: "user" feature_names: "uid" wide_deep: DEEP
  }
  feature_groups {
    group_name: "item"
    feature_names: "iid" feature_names: "cate" wide_deep: DEEP
  }
"""

MM_GROUPS = """
  feature_groups {
    group_name: "image" feature_names: "img_vec" wide_deep: DEEP
  }
  feature_groups {
    group_name: "text" feature_names: "cate" feature_names: "title"
    wide_deep: DEEP
  }
"""


def extra_config(tmp, body, label, metrics=AUC_METRIC, num_steps=250,
                 lr=0.02, n_train=16384):
  """test_learnability_extra._run's files and config; returns its path."""
  train = data_file(tmp, make_extra_csv, n_train, 11)
  evalp = data_file(tmp, make_extra_csv, 4096, 12)
  text = EXTRA_CONFIG.format(train=train, eval=evalp, num_steps=num_steps,
                             metrics=metrics, label=label, lr=lr,
                             img_dim=IMG_DIM, model_body=body)
  return write_config(tmp, text)


DSSM_POINTWISE = UI_GROUPS + """
  model_class: "DSSM"
  dssm {
    user_tower { id: "uid" dnn { hidden_units: [16, 8] use_bn: false } }
    item_tower { id: "iid" dnn { hidden_units: [16, 8] use_bn: false } }
    simi_func: INNER_PRODUCT
    scale_simi: true
  }
  loss_type: CLASSIFICATION
"""

DSSM_REG = DSSM_POINTWISE.replace('loss_type: CLASSIFICATION',
                                  'loss_type: L2_LOSS')

MULTI_TOWER_RECALL = UI_GROUPS + """
  model_class: "MultiTowerRecall"
  multi_tower_recall {
    user_tower { dnn { hidden_units: [16, 8] use_bn: false } }
    item_tower { dnn { hidden_units: [16, 8] use_bn: false } }
    final_dnn { hidden_units: [8] use_bn: false }
  }
"""

DROPOUTNET = """
  feature_groups {
    group_name: "user_content" feature_names: "uid" wide_deep: DEEP
  }
  feature_groups {
    group_name: "item_content" feature_names: "iid" wide_deep: DEEP
  }
  feature_groups {
    group_name: "item_preference" feature_names: "cate" wide_deep: DEEP
  }
  model_class: "DropoutNet"
  dropoutnet {
    user_content { hidden_units: [16] use_bn: false }
    item_content { hidden_units: [16] use_bn: false }
    item_preference { hidden_units: [8] use_bn: false }
    user_tower { hidden_units: [16] use_bn: false }
    item_tower { hidden_units: [16] use_bn: false }
    softmax_loss { num_negative_samples: 4 }
  }
"""

PDN_BODY = UI_GROUPS + """
  feature_groups {
    group_name: "hist" feature_names: "seq_cate" wide_deep: DEEP
  }
  model_class: "PDN"
  pdn {
    user_dnn { hidden_units: [16, 8] use_bn: false }
    item_dnn { hidden_units: [16, 8] use_bn: false }
    u2i_dnn { hidden_units: [8] use_bn: false }
    trigger_dnn { hidden_units: [8, 1] use_bn: false }
    i2i_dnn { hidden_units: [8] use_bn: false }
    sim_dnn { hidden_units: [8, 1] use_bn: false }
    direct_user_dnn { hidden_units: [8] use_bn: false }
    direct_item_dnn { hidden_units: [8] use_bn: false }
    item_id: "iid"
  }
"""

ROCKET = """
  feature_groups {
    group_name: "all"
    feature_names: "uid" feature_names: "iid" wide_deep: DEEP
  }
  model_class: "RocketLaunching"
  rocket_launching {
    share_dnn { hidden_units: [32] use_bn: false }
    booster_dnn { hidden_units: [32, 16] }
    light_dnn { hidden_units: [16] }
    feature_based_distillation: false
  }
"""

CMBF_BODY = MM_GROUPS + """
  model_class: "CMBF"
  cmbf {
    config {
      multi_head_num: 2
      image_multi_head_num: 2
      text_multi_head_num: 2
      text_head_size: 8
      image_head_size: 8
      image_feature_patch_num: 4
      image_self_attention_layer_num: 1
      text_self_attention_layer_num: 1
      cross_modal_layer_num: 1
    }
    final_dnn { hidden_units: [16] use_bn: false }
  }
"""

UNITER_BODY = MM_GROUPS + """
  model_class: "Uniter"
  uniter {
    config {
      hidden_size: 16
      num_hidden_layers: 1
      num_attention_heads: 2
      intermediate_size: 32
    }
    final_dnn { hidden_units: [16] use_bn: false }
  }
"""

CML_BODY = """
  feature_groups {
    group_name: "item"
    feature_names: "iid" feature_names: "title" wide_deep: DEEP
  }
  model_class: "CoMetricLearningI2I"
  metric_learning {
    session_id: "sess"
    input: "item"
    dnn { hidden_units: [16, 8] use_bn: false }
    circle_loss { margin: 0.25 gamma: 32 }
    output_l2_normalized_emb: true
  }
"""

# DAT: in-batch softmax recall on a fine-grained preference fixture, every
# (user, item) pair a distinct true logit (a rank-4 factorisation)
N_PU, N_PI, PRANK = 64, 48, 4


def _pref_logits():
  rng = np.random.default_rng(55)
  z = rng.normal(size=(N_PU, PRANK))
  w = rng.normal(size=(N_PI, PRANK))
  return 2.2 * z @ w.T


def _pref_rows(n, seed):
  logits = _pref_logits()
  p = np.exp(logits - logits.max(axis=1, keepdims=True))
  p /= p.sum(axis=1, keepdims=True)
  rng = np.random.default_rng(seed)
  us = rng.integers(0, N_PU, n)
  iids = np.array([rng.choice(N_PI, p=p[u]) for u in us])
  return us, iids


def make_pref_csv(path, n, seed):
  us, iids = _pref_rows(n, seed)
  with open(path, 'w') as f:
    for u, i in zip(us, iids):
      f.write('1,u%d,i%d,c%d\n' % (u, i, i % X_N_CATE))


def bayes_inbatch_recall(n=2048, seed=32, batch=128, k=5):
  """Ceiling recall@k of an in-batch-softmax-trained scorer under the
  metric's own semantics (eval file order, no collision mask for DAT):
  the popularity-corrected scorer s = logit - log pop, ties counted half.
  About 0.422."""
  us, iids = _pref_rows(n, seed)
  logits = _pref_logits()
  p = np.exp(logits - logits.max(axis=1, keepdims=True))
  p /= p.sum(axis=1, keepdims=True)
  s_all = logits - np.log(p.mean(axis=0))[None, :]
  hits = cnt = 0
  for b0 in range(0, n - batch + 1, batch):
    u = us[b0:b0 + batch]
    it = iids[b0:b0 + batch]
    s = s_all[u][:, it]
    pos = np.diag(s)
    rank = (s > pos[:, None]).sum(axis=1) + \
        0.5 * ((s == pos[:, None]).sum(axis=1) - 1)
    hits += int((rank < k).sum())
    cnt += batch
  return hits / cnt


DAT_CONFIG = """
train_input_path: "{train}"
eval_input_path: "{eval}"
model_dir: ""
train_config {{
  log_step_count_steps: 100
  optimizer_config {{
    adam_optimizer {{
      learning_rate {{ constant_learning_rate {{ learning_rate: 0.01 }} }}
    }}
  }}
  num_steps: 600
  save_checkpoints_steps: 100000
}}
eval_config {{ metrics_set {{ recall_at_topk {{ topk: 5 }} }} }}
data_config {{
  batch_size: 128
  label_fields: "label"
  input_fields {{ input_name: "label" input_type: FLOAT }}
  input_fields {{ input_name: "uid" input_type: STRING }}
  input_fields {{ input_name: "iid" input_type: STRING }}
  input_fields {{ input_name: "cate" input_type: STRING }}
  input_type: CSVInput
}}
feature_config {{
  features {{ input_names: "uid" feature_type: IdFeature
              embedding_dim: 8 hash_bucket_size: 3000 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "iid" feature_type: IdFeature
              embedding_dim: 8 hash_bucket_size: 3000 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
  features {{ input_names: "cate" feature_type: IdFeature
              embedding_dim: 8 hash_bucket_size: 600 initializer {{ random_normal_initializer {{ stddev: 0.35 }} }} }}
}}
model_config {{
  model_class: "DAT"
  feature_groups {{
    group_name: "user" feature_names: "uid" wide_deep: DEEP
  }}
  feature_groups {{
    group_name: "item"
    feature_names: "iid" feature_names: "cate" wide_deep: DEEP
  }}
  dat {{
    user_tower {{ id: "uid" dnn {{ hidden_units: [16, 8] use_bn: false }} }}
    item_tower {{ id: "iid" dnn {{ hidden_units: [16, 8] use_bn: false }} }}
    simi_func: INNER_PRODUCT
  }}
  loss_type: SOFTMAX_CROSS_ENTROPY
}}
"""


def dat_config(tmp):
  train = data_file(tmp, make_pref_csv, 16384, 31)
  evalp = data_file(tmp, make_pref_csv, 2048, 32)
  return write_config(tmp, DAT_CONFIG.format(train=train, eval=evalp))


GROUP_SEQ_MMOE = """
  model_class: "MMoE"
  feature_groups {
    group_name: "all"
    feature_names: "uid" feature_names: "cate"
    wide_deep: DEEP
    sequence_features {
      group_name: "seq_fea"
      seq_dnn { hidden_units: [32, 16, 1] }
      seq_att_map { key: "cate" hist_seq: "seq_cate" }
    }
  }
  mmoe {
    expert_dnn { hidden_units: [32, 16] use_bn: false }
    num_expert: 2
    task_towers {
      tower_name: "ctr" label_name: "lpdn"
      dnn { hidden_units: [16] use_bn: false } num_class: 1
      loss_type: CLASSIFICATION weight: 1.0
      metrics_set { auc {} }
    }
  }
"""

# the extra file's AUC gates, name: (body, label, steps, lr, bar), the
# bars as its gates set them
TWO_TOWER_BAR = X_BAYES['ltwr'] - X_MARGIN['two_tower']
PDN_BAR = X_BAYES['lpdn'] - X_MARGIN['pdn']
MULTIMODAL_BAR = X_BAYES['limg'] - X_MARGIN['multimodal']
EXTRA_AUC_GATES = {
    'dssm_pointwise': (DSSM_POINTWISE, 'ltwr', 250, 0.02, TWO_TOWER_BAR),
    'multi_tower_recall': (MULTI_TOWER_RECALL, 'ltwr', 250, 0.02,
                           TWO_TOWER_BAR),
    # cosine-similarity logits, cold-start dropout: a wider margin
    'dropoutnet': (DROPOUTNET, 'ltwr', 400, 0.02,
                   X_BAYES['ltwr'] - 2 * X_MARGIN['two_tower']),
    # eval scores come from the light net
    'rocket_launching': (ROCKET, 'ltwr', 250, 0.02, TWO_TOWER_BAR),
    # sessions group the items of one cate; a broken pairwise loss leaves
    # the session pairs' AUC near 0.5
    'cml_i2i': (CML_BODY, 'ltwr', 250, 0.02, 0.90),
    # lpdn depends only on (cate, seq_cate): the trigger / i2i path must
    # carry it; the additive-hazard link converges slower
    'pdn': (PDN_BODY, 'lpdn', 500, 0.02, PDN_BAR),
    # the DIN attention inside a feature group must attend the history
    'group_seq_attention': (GROUP_SEQ_MMOE, 'lpdn', 250, 0.02, PDN_BAR),
    'cmbf': (CMBF_BODY, 'limg', 400, 0.005, MULTIMODAL_BAR),
    'uniter': (UNITER_BODY, 'limg', 400, 0.005, MULTIMODAL_BAR),
}


def check_extra_auc_gate(tmp, name):
  """One of EXTRA_AUC_GATES trained on the CPU; its eval AUC must clear
  its bar."""
  body, label, steps, lr, bar = EXTRA_AUC_GATES[name]
  m = run_gate(extra_config(tmp, body, label, num_steps=steps, lr=lr))[0]
  assert m['auc'] > bar, '%s gate: auc=%.4f < %.4f (%s)' % (
      name, m['auc'], bar, m)
