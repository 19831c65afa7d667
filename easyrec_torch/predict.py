"""Predict CLI: python -m easyrec_torch.predict --pipeline_config_path ...

Counterpart of easyrec_tpu/predict.py plus --device: offline predict with
model_dir's latest checkpoint, or with --saved_model_dir from an export
bundle (then --reserved_cols and the shard flags apply). Runs on CUDA
unless --device cpu is given.
"""

import argparse
import json
import logging


def get_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description='easyrec_torch predict')
  parser.add_argument('--pipeline_config_path', default=None)
  parser.add_argument('--saved_model_dir', default=None,
                      help='predict from an export bundle instead of the '
                           'latest checkpoint')
  parser.add_argument('--input_path', default=None)
  parser.add_argument('--output_path', default=None)
  parser.add_argument('--model_dir', default=None)
  parser.add_argument('--shard_index', type=int, default=0)
  parser.add_argument('--shard_num', type=int, default=1)
  parser.add_argument('--reserved_cols', default='',
                      help='comma-separated input columns copied into '
                           'the output (saved-model path only)')
  parser.add_argument('--edit_config_json', default=None)
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'")
  return parser


def main(argv=None) -> int:
  logging.basicConfig(level=logging.INFO)
  parser = get_parser()
  args = parser.parse_args(argv)

  if args.saved_model_dir:
    from easyrec_torch.export.predictor import Predictor
    if not args.input_path or not args.output_path:
      parser.error('--saved_model_dir needs --input_path and '
                   '--output_path')
    predictor = Predictor(args.saved_model_dir, device=args.device)
    reserved = [c for c in args.reserved_cols.split(',') if c]
    n = predictor.predict_csv(args.input_path, args.output_path,
                              reserved_cols=reserved or None,
                              shard_index=args.shard_index,
                              shard_num=args.shard_num)
    logging.info('predicted %d rows -> %s', n, args.output_path)
    return 0

  if not args.pipeline_config_path:
    parser.error('need --pipeline_config_path or --saved_model_dir')
  from easyrec_torch import main as main_lib
  edits = json.loads(args.edit_config_json) if args.edit_config_json else {}
  if args.model_dir:
    edits['model_dir'] = args.model_dir
  rows = main_lib.predict(args.pipeline_config_path,
                        input_path=args.input_path,
                        output_path=args.output_path,
                        edit_config_json=edits or None, device=args.device)
  logging.info('predicted %d rows', len(rows))
  return 0


if __name__ == '__main__':
  _rc = main()
  from easyrec_torch.utils.proc import exit_after
  exit_after(_rc)
