"""Predict a CSV with an export and check the outputs against expected ones.

Counterpart of easyrec_tpu/tools/predict_and_chk.py over the port's
Predictor (export/predictor.py), on --device (CUDA by default):

  python -m easyrec_torch.tools.predict_and_chk \
      --export_dir <dir> --input_path in.csv --output_path out.csv \
      [--cmp_path expected.csv --cmp_key probs --tol 1e-4] [--device cpu]

It prints one JSON line (num_predictions, output_path and, with
--cmp_path, matched, max_abs_diff and tolerance) and exits 0 when the
predictions were written (and, with --cmp_path, matched), 1 on a
mismatch. The input is read by the export's own input_type, so a
CriteoInput export predicts binary record files.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys

import numpy as np


def _read_column(path: str, key: str) -> np.ndarray:
  with open(path, newline='') as f:
    reader = csv.DictReader(f)
    if key not in (reader.fieldnames or []):
      raise KeyError('column %r not in %s (has %s)' %
                     (key, path, reader.fieldnames))
    return np.array([float(row[key]) for row in reader])


def predict_and_check(export_dir: str, input_path: str, output_path: str,
                      cmp_path: str = '', cmp_key: str = 'probs',
                      tol: float = 1e-4, batch_size: int = 1024,
                      device=None) -> dict:
  from easyrec_torch.export.predictor import Predictor
  predictor = Predictor(export_dir, batch_size=batch_size, device=device)
  n = predictor.predict_csv(input_path, output_path)
  result = {'num_predictions': int(n), 'output_path': output_path}
  if cmp_path:
    got = _read_column(output_path, cmp_key)
    want = _read_column(cmp_path, cmp_key)
    if len(got) != len(want):
      result.update(matched=False,
                    error='row count %d != expected %d' %
                          (len(got), len(want)))
      return result
    diff = float(np.max(np.abs(got - want))) if len(got) else 0.0
    result.update(matched=bool(diff <= tol), max_abs_diff=diff,
                  tolerance=tol)
  return result


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--export_dir', required=True)
  parser.add_argument('--input_path', required=True)
  parser.add_argument('--output_path', required=True)
  parser.add_argument('--cmp_path', default='',
                      help='expected-results csv to compare against')
  parser.add_argument('--cmp_key', default='probs',
                      help='output column to compare')
  parser.add_argument('--tol', type=float, default=1e-4)
  parser.add_argument('--batch_size', type=int, default=1024)
  parser.add_argument('--device', default=None,
                      help='cuda (default) or cpu')
  args = parser.parse_args(argv)
  result = predict_and_check(args.export_dir, args.input_path,
                             args.output_path, args.cmp_path, args.cmp_key,
                             args.tol, args.batch_size, args.device)
  print(json.dumps(result))
  if args.cmp_path and not result.get('matched'):
    sys.exit(1)


if __name__ == '__main__':
  main()
