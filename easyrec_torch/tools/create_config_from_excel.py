"""Generate a pipeline config from a feature sheet.

Counterpart of easyrec_tpu/tools/create_config_from_excel.py, whose CSV
form it ports whole: one row a column of the sheet (header row required),

  name, data_type (string/float/int), feature_type (id/raw/tag/sequence/
  combo/label/passthrough), hash_bucket_size, num_buckets, embedding_dim,
  boundaries (|-separated), group, wide_deep (deep/wide/wide_and_deep),
  separator, max_seq_len

gives a text config of its input fields, features, groups and a model
body of --model_class (DeepFM, MultiTower, WideAndDeep or DSSM), checked
by parsing it back. An .xlsx or .xls sheet raises the JAX tool's
ImportError: reading it needs an excel engine, which the port does not use
(export the sheet as CSV).

  python -m easyrec_torch.tools.create_config_from_excel \
      --template features.csv --model_class DeepFM \
      --train_input_path t.csv --eval_input_path e.csv \
      --model_dir ./model --output_path pipeline.config
"""

from __future__ import annotations

import argparse
import csv
import logging


def _read_rows(path: str):
  if path.endswith(('.xlsx', '.xls')):
    raise ImportError('reading %s needs an excel engine (openpyxl); '
                      'export the sheet as CSV instead' % path)
  with open(path) as f:
    return list(csv.DictReader(f))


_TYPE_MAP = {'id': 'IdFeature', 'raw': 'RawFeature', 'tag': 'TagFeature',
             'sequence': 'SequenceFeature', 'combo': 'ComboFeature',
             'lookup': 'LookupFeature', 'expr': 'ExprFeature',
             'passthrough': 'PassThroughFeature'}
_DTYPE_MAP = {'string': 'STRING', 'float': 'FLOAT', 'double': 'DOUBLE',
              'int': 'INT64', 'int64': 'INT64', 'int32': 'INT32'}


def generate_config(rows, model_class: str, train_input_path: str,
                    eval_input_path: str, model_dir: str,
                    batch_size: int = 256) -> str:
  input_fields, features = [], []
  groups = {}
  labels = []
  for row in rows:
    name = (row.get('name') or '').strip()
    if not name:
      continue
    ftype = (row.get('feature_type') or 'id').strip().lower()
    dtype = _DTYPE_MAP.get((row.get('data_type') or 'string').strip()
                           .lower(), 'STRING')
    if ftype == 'label':
      labels.append(name)
      input_fields.append((name, 'FLOAT'))
      continue
    input_fields.append((name, dtype))
    lines = ['    input_names: "%s"' % name,
             '    feature_type: %s' % _TYPE_MAP.get(ftype, 'IdFeature')]
    def _num(key):
      v = (row.get(key) or '').strip() if isinstance(row.get(key), str) \
          else row.get(key)
      try:
        return int(float(v)) if v not in (None, '') else 0
      except (TypeError, ValueError):
        return 0
    if _num('hash_bucket_size'):
      lines.append('    hash_bucket_size: %d' % _num('hash_bucket_size'))
    if _num('num_buckets'):
      lines.append('    num_buckets: %d' % _num('num_buckets'))
    if _num('embedding_dim'):
      lines.append('    embedding_dim: %d' % _num('embedding_dim'))
    bounds = (row.get('boundaries') or '')
    if bounds:
      for b in str(bounds).split('|'):
        if b.strip():
          lines.append('    boundaries: %s' % float(b))
      if not _num('embedding_dim'):
        # bucketized raw features are embeddings; give them a dim
        lines.append('    embedding_dim: 16')
    if row.get('separator'):
      lines.append('    separator: "%s"' % row['separator'])
    if _num('max_seq_len'):
      lines.append('    max_seq_len: %d' % _num('max_seq_len'))
    features.append('  features {\n%s\n  }' % '\n'.join(lines))
    group = (row.get('group') or 'all').strip() or 'all'
    wd = (row.get('wide_deep') or 'deep').strip().upper()
    groups.setdefault((group, wd), []).append(name)

  if not labels:
    raise ValueError('template declares no label row '
                     "(feature_type: 'label')")

  group_blocks = []
  for (gname, wd), names in groups.items():
    body = '\n'.join('    feature_names: "%s"' % n for n in names)
    group_blocks.append(
        '  feature_groups {\n    group_name: "%s"\n%s\n'
        '    wide_deep: %s\n  }' % (gname, body, wd))

  model_body = {
      'DeepFM': '  deepfm { dnn { hidden_units: [128, 64] } }',
      'MultiTower': '  multi_tower {\n%s\n'
                    '    final_dnn { hidden_units: [128, 64] }\n  }' %
                    '\n'.join('    towers { input: "%s" dnn '
                              '{ hidden_units: [128, 64] } }' % g
                              for (g, _) in groups),
      'WideAndDeep': '  wide_and_deep { dnn { hidden_units: [128, 64] } }',
      'DSSM': '  dssm {\n    user_tower { id: "user" dnn '
              '{ hidden_units: [128, 64] } }\n    item_tower '
              '{ id: "item" dnn { hidden_units: [128, 64] } }\n  }',
  }.get(model_class, '')

  return """train_input_path: "%s"
eval_input_path: "%s"
model_dir: "%s"
train_config {
  optimizer_config {
    adam_optimizer {
      learning_rate { constant_learning_rate { learning_rate: 0.001 } }
    }
  }
  num_steps: 10000
}
eval_config { metrics_set { auc {} } }
data_config {
  batch_size: %d
%s
%s
  input_type: CSVInput
}
feature_config {
%s
}
model_config {
  model_class: "%s"
%s
%s
}
""" % (train_input_path, eval_input_path, model_dir, batch_size,
       '\n'.join('  label_fields: "%s"' % l for l in labels),
       '\n'.join('  input_fields { input_name: "%s" input_type: %s }' %
                 (n, t) for n, t in input_fields),
       '\n'.join(features), model_class,
       '\n'.join(group_blocks), model_body)


def main(argv=None):
  logging.basicConfig(level=logging.INFO)
  parser = argparse.ArgumentParser()
  parser.add_argument('--template', '--excel_path', dest='template',
                      required=True)
  parser.add_argument('--model_class', default='DeepFM')
  parser.add_argument('--train_input_path', default='train.csv')
  parser.add_argument('--eval_input_path', default='eval.csv')
  parser.add_argument('--model_dir', default='./model_dir')
  parser.add_argument('--output_path', required=True)
  parser.add_argument('--batch_size', type=int, default=256)
  args = parser.parse_args(argv)
  rows = _read_rows(args.template)
  text = generate_config(rows, args.model_class, args.train_input_path,
                         args.eval_input_path, args.model_dir,
                         args.batch_size)
  with open(args.output_path, 'w') as f:
    f.write(text)
  from easyrec_torch.config import config_util
  config_util.get_configs_from_pipeline_file(args.output_path)
  logging.info('wrote %s', args.output_path)


if __name__ == '__main__':
  main()
