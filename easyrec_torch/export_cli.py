"""Export CLI: python -m easyrec_torch.export_cli --pipeline_config_path ...

Counterpart of easyrec_tpu/export_cli.py plus --device: writes a serving
bundle from model_dir's latest checkpoint, or --checkpoint_path. Runs on
CUDA unless --device cpu is given. --big_model is not ported and raises.
"""

import argparse
import json
import logging


def get_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description='easyrec_torch export')
  parser.add_argument('--pipeline_config_path', required=True)
  parser.add_argument('--export_dir', default=None)
  parser.add_argument('--checkpoint_path', default=None)
  parser.add_argument('--model_dir', default=None)
  parser.add_argument('--edit_config_json', default=None)
  parser.add_argument('--big_model', action='store_true',
                      help='not ported: raises NotImplementedError')
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
  path = main_lib.export(args.pipeline_config_path,
                       export_dir=args.export_dir,
                       checkpoint_path=args.checkpoint_path,
                       edit_config_json=edits or None,
                       big_model=args.big_model, device=args.device)
  logging.info('exported to %s', path)
  return 0


if __name__ == '__main__':
  raise SystemExit(main())
