"""The files of a DLRM-DCNv2 cell (MLPerf Training's recommendation
benchmark, github.com/mlcommons/training recommendation_v2/torchrec_dlrm),
written into a copy of the benchmark: a configuration with features that
have no table, multi-hot bags and the backbone's DCN-v2 Cross, added by
files alone.

The shape is the published one: 13 dense values through a bottom MLP
512-256-<dim>; 26 multi-hot id features, each a sum-pooled bag of BAGS[i]
ids at `dim` into a table of CARDINALITIES[i] rows (Criteo 1TB capped at
40M); a DCN-v2 cross network of 3 low-rank layers (rank 512) over the 27
x dim concatenation; the top MLP 1024-1024-512-256 and one logit. `dim`
(128 published), the tables' rows and the batch are arguments. Adam on
both sides, as the DeepFM's (the source trains with Adagrad).

    write(root, dim=16)                # the test's cell, CPU sized
    write(root, dim=128, rows=SHARD)   # one card's share of four

The cell's limits are the DeepFM cell's, stand-ins until they are
calibrated on the card at the cell's own size.
"""

import json
import os
import shutil

from recbench.cell import REPO_DIR

NAME = 'dlrm_dcnv2'
TRAFFIC = 'criteo1tb_multihot_b16384'
CELL = NAME + '.multihot_b16384'
SOURCE = ('https://github.com/mlcommons/training/tree/master/'
          'recommendation_v2/torchrec_dlrm')
CARDINALITIES = [40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63,
                 40000000, 3067956, 405282, 10, 2209, 11938, 155, 4, 976,
                 14, 40000000, 40000000, 40000000, 590152, 12973, 108, 36]
BAGS = [3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
        27, 10, 3, 1, 1]
# one card's share of four: a table of 1M rows or more row-sharded by four
SHARD = [c // 4 if c >= 1000000 else c for c in CARDINALITIES]
DENSE = 13
BOTTOM = [512, 256]
TOP = [1024, 1024, 512, 256]
CROSS_LAYERS, CROSS_RANK = 3, 512
ENV = {'EASYREC_PACKED_COMPACT': '1', 'EASYREC_GG_BF16': '1',
       'EASYREC_PACKED_FUSED': '0'}
OPTIMIZER = {'b1': 0.9, 'b2': 0.999, 'eps': 1e-08,
             'initial_learning_rate': 0.001, 'decay_steps': 1000,
             'decay_factor': 0.5, 'min_learning_rate': 1e-05}


def _mlp(units) -> str:
  """An MLP message's fields: relu, with biases, no BatchNorm."""
  return ('%s use_bn: false use_final_bn: false use_bias: true '
          'use_final_bias: true' % ' '.join('hidden_units: %d' % u
                                            for u in units))


def pipeline_config(dim: int, rows, batch_size: int) -> str:
  """The pipeline config the port runs."""
  fields = ['input_fields { input_name: "label" input_type: FLOAT }',
            'input_fields { input_name: "dense" input_type: STRING }']
  feats = ['features { input_names: "dense" feature_type: RawFeature '
           'raw_input_dim: %d }' % DENSE]
  for i, (n, k) in enumerate(zip(rows, BAGS)):
    fields.append('input_fields { input_name: "C%d" input_type: STRING }'
                  % (i + 1))
    feats.append('features { input_names: "C%d" feature_type: TagFeature '
                 'embedding_dim: %d hash_bucket_size: %d max_multi_len: %d '
                 'combiner: "sum" }' % (i + 1, dim, n, k))
  sparse = ' '.join('feature_names: "C%d"' % (i + 1)
                    for i in range(len(rows)))
  lr = OPTIMIZER
  return '''train_input_path: "synthetic"
eval_input_path: "synthetic"
model_dir: ""
train_config {
  optimizer_config { adam_optimizer { learning_rate {
    exponential_decay_learning_rate {
      initial_learning_rate: %(lr0)r decay_steps: %(steps)d
      decay_factor: %(factor)r min_learning_rate: %(lr_min)r } } } }
  num_steps: 1000
  log_step_count_steps: 100
}
eval_config { metrics_set { auc { } } }
data_config {
  batch_size: %(batch)d
  label_fields: "label"
  input_type: DummyInput
  separator: "\\t"
  %(fields)s
}
feature_config {
  %(feats)s
}
model_config {
  model_class: "RankModel"
  feature_groups { group_name: "dense" feature_names: "dense"
                   wide_deep: DEEP }
  feature_groups { group_name: "sparse" %(sparse)s wide_deep: DEEP }
  backbone {
    blocks { name: "bottom" inputs { feature_group_name: "dense" }
             keras_layer { class_name: "MLP" mlp { %(bottom)s } } }
    blocks { name: "cross" inputs { block_name: "bottom" }
             inputs { feature_group_name: "sparse" }
             keras_layer { class_name: "Cross" st_params {
               fields { key: "num_layers" value { number_value: %(layers)d } }
               fields { key: "projection_dim"
                        value { number_value: %(rank)d } } } } }
    concat_blocks: ["cross"]
    top_mlp { %(top)s }
  }
}
''' % {'lr0': lr['initial_learning_rate'], 'steps': lr['decay_steps'],
       'factor': lr['decay_factor'], 'lr_min': lr['min_learning_rate'],
       'batch': batch_size, 'fields': '\n  '.join(fields),
       'feats': '\n  '.join(feats), 'sparse': sparse,
       'bottom': _mlp(BOTTOM + [dim]), 'layers': CROSS_LAYERS,
       'rank': CROSS_RANK,
       'top': _mlp(TOP)}


def configuration(dim: int, rows) -> dict:
  feats = [{'name': 'dense', 'kind': 'dense', 'value_dim': DENSE}]
  feats += [{'name': 'C%d' % (i + 1), 'kind': 'id', 'rows': n, 'dim': dim,
             'max_len': k} for i, (n, k) in enumerate(zip(rows, BAGS))]
  return {
      'name': NAME, 'source': SOURCE, 'pipeline_config': NAME + '.config',
      'reduced': (['embedding_dim'] if dim != 128 else []) +
                 (['rows'] if list(rows) != CARDINALITIES else []),
      'assumed': {'optimizer': 'Adam, as the DeepFM cell (the source: '
                               'Adagrad)',
                  'initial_weights': 'tables normal(0, init_std)'},
      'env': ENV, 'precision': 'float32',
      'model': {'class': 'RankModel', 'label': 'label', 'features': feats,
                'bottom_mlp': BOTTOM + [dim],
                'cross': {'num_layers': CROSS_LAYERS,
                          'projection_dim': CROSS_RANK},
                'top_mlp': TOP, 'l2_regularization': 0.0,
                'embedding_regularization': 0.0, 'init_std': 0.01,
                'optimizer': OPTIMIZER,
                'sparse': {'moments': 'bf16_pair', 'grad_sum': 'bf16'}},
      'layout': {'weight_dim': dim, 'row_floats': 2 * dim,
                 'why': 'one fused table of dim columns, then the bf16 '
                        'moment pairs (compact Adam)'}}


def traffic(batch_size: int) -> dict:
  feats = {'dense': {'draw': 'lognormal', 'sigma': 1.0, 'decimals': 3}}
  for i in range(len(BAGS)):
    feats['C%d' % (i + 1)] = {'draw': 'power_law', 'exponent': 1.1,
                              'scatter': 2654435761}
  return {'name': TRAFFIC,
          'why': 'Criteo 1TB shaped: 13 dense values, 26 bags of 1-100 '
                 'power-law ids',
          'batch_size': batch_size, 'batches': 8, 'features': feats,
          'labels': {'label': {'draw': 'bernoulli', 'p': 0.0325}}}


def write(root: str, dim: int = 16, rows=CARDINALITIES,
          batch_size: int = 16384) -> str:
  """Add the cell's files to the benchmark at `root` (BENCHMARK.json and
  recbench/): its configuration, pipeline config, reference, traffic and
  limits, and its BENCHMARK.json entries. Returns the cell's name."""
  base = os.path.join(root, 'recbench')

  def dump(obj, *parts):
    with open(os.path.join(base, *parts), 'w') as f:
      json.dump(obj, f, indent=1)

  dump(configuration(dim, rows), 'configs', NAME + '.json')
  with open(os.path.join(base, 'configs', NAME + '.config'), 'w') as f:
    f.write(pipeline_config(dim, rows, batch_size))
  shutil.copy(os.path.join(os.path.dirname(__file__),
                           'dlrm_dcnv2_reference.py'),
              os.path.join(base, 'reference', NAME + '.py'))
  dump(traffic(batch_size), 'traffic', TRAFFIC + '.json')
  with open(os.path.join(REPO_DIR, 'recbench', 'workloads',
                         'deepfm_criteo.zipf_b131072.json')) as f:
    workload = json.load(f)
  workload['name'] = CELL
  dump(workload, 'workloads', CELL + '.json')
  path = os.path.join(root, 'BENCHMARK.json')
  with open(path) as f:
    bench = json.load(f)
  bench['configs'].append({
      'name': NAME, 'source': SOURCE,
      'file': 'recbench/configs/%s.json' % NAME,
      'reduced': configuration(dim, rows)['reduced'],
      'why': 'MLPerf DLRM-DCNv2: 13 dense values with no table, 26 '
             'multi-hot bags at dim 128, a low-rank DCN-v2 cross network'})
  bench['workloads'].append({
      'name': CELL, 'config': NAME, 'traffic': TRAFFIC, 'chips': 1,
      'why': 'bags of 1-100 ids (214 an example) into 26 tables, dense '
             'values with no table, the backbone Cross; K1 + K2'})
  with open(path, 'w') as f:
    json.dump(bench, f, indent=1)
  return CELL
