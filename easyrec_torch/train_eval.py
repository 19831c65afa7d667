"""Train CLI: python -m easyrec_torch.train_eval --pipeline_config_path ...

Counterpart of easyrec_tpu/train_eval.py (:13-74) plus --device. Runs on
CUDA unless --device cpu is given.
"""

import argparse
import json
import logging


def get_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description='easyrec_torch train')
  parser.add_argument('--pipeline_config_path', required=True,
                      help='path to the pipeline config file')
  parser.add_argument('--edit_config_json', default=None,
                      help='json dict of dotted-path config edits')
  parser.add_argument('--num_steps', type=int, default=None,
                      help='override train_config.num_steps')
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'")
  return parser


def main(argv=None) -> int:
  logging.basicConfig(
      level=logging.INFO,
      format='[%(levelname)s] %(asctime)s %(filename)s:%(lineno)d : '
             '%(message)s')
  args = get_parser().parse_args(argv)
  from easyrec_torch import main as main_lib
  edits = json.loads(args.edit_config_json) if args.edit_config_json else {}
  if args.num_steps is not None:
    edits['train_config.num_steps'] = args.num_steps
  result = main_lib.train_and_evaluate(args.pipeline_config_path,
                                     edit_config_json=edits or None,
                                     device=args.device)
  logging.info('done: step=%s metrics=%s', result['global_step'],
               result.get('eval_metrics', {}))
  return 0


if __name__ == '__main__':
  raise SystemExit(main())
