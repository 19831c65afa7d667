"""Eval CLI: python -m easyrec_torch.eval --pipeline_config_path ...

Counterpart of easyrec_tpu/eval.py plus --device: evaluates model_dir's
latest checkpoint and writes the metrics to <model_dir>/eval_result.txt.
Runs on CUDA unless --device cpu is given.
"""

import argparse
import json
import logging


def get_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description='easyrec_torch eval')
  parser.add_argument('--pipeline_config_path', required=True)
  parser.add_argument('--model_dir', default=None)
  parser.add_argument('--eval_input_path', default=None)
  parser.add_argument('--eval_result_filename', default='eval_result.txt')
  parser.add_argument('--edit_config_json', default=None)
  parser.add_argument('--distribute_eval', action='store_true',
                      default=False)
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'")
  return parser


def main(argv=None) -> int:
  logging.basicConfig(level=logging.INFO)
  args = get_parser().parse_args(argv)
  from easyrec_torch import main as main_lib
  edits = json.loads(args.edit_config_json) if args.edit_config_json else {}
  if args.model_dir:
    edits['model_dir'] = args.model_dir
  if args.eval_input_path:
    edits['eval_input_path'] = args.eval_input_path
  fn = main_lib.distribute_evaluate if args.distribute_eval else \
      main_lib.evaluate
  metrics = fn(args.pipeline_config_path,
               eval_result_filename=args.eval_result_filename,
               edit_config_json=edits or None, device=args.device)
  logging.info('eval metrics: %s', metrics)
  return 0


if __name__ == '__main__':
  raise SystemExit(main())
