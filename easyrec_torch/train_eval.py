"""Train CLI: python -m easyrec_torch.train_eval --pipeline_config_path ...

Counterpart of easyrec_tpu/train_eval.py (:13-74) plus --device. Runs on
CUDA unless --device cpu is given. Started by torchrun (or with
EASYREC_DISTRIBUTED=1 and RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT set),
each process joins the world as one rank: NCCL on cuda:<LOCAL_RANK>, gloo
under --device cpu:

    torchrun --nproc_per_node 4 -m easyrec_torch.train_eval \
        --pipeline_config_path cfg.config --device cpu With model_dir set in the config (or
--model_dir), it writes checkpoints there and a second call resumes from
the latest one.
"""

import argparse
import json
import logging


def get_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description='easyrec_torch train')
  parser.add_argument('--pipeline_config_path', required=True,
                      help='path to the pipeline config file')
  parser.add_argument('--continue_train', action='store_true', default=False,
                      help='continue training from the latest checkpoint')
  parser.add_argument('--model_dir', default=None,
                      help='override model_dir in the config')
  parser.add_argument('--edit_config_json', default=None,
                      help='json dict of dotted-path config edits')
  parser.add_argument('--fine_tune_checkpoint', default=None,
                      help='warm-start checkpoint path')
  parser.add_argument('--num_steps', type=int, default=None,
                      help='override train_config.num_steps')
  parser.add_argument('--fit_on_eval', action='store_true', default=False,
                      help='continue training on eval data after training')
  parser.add_argument('--fit_on_eval_steps', type=int, default=0)
  parser.add_argument('--check_mode', action='store_true', default=False,
                      help='validate every input batch with pointed '
                           'errors')
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'")
  return parser


def main(argv=None) -> int:
  logging.basicConfig(
      level=logging.INFO,
      format='[%(levelname)s] %(asctime)s %(filename)s:%(lineno)d : '
             '%(message)s')
  args = get_parser().parse_args(argv)
  from easyrec_torch.parallel import mesh
  if mesh.world_requested():
    # one process a device (torchrun --nproc_per_node N): join the world
    # (the JAX CLI's jax.distributed.initialize, train_eval.py:43-50)
    world = mesh.join_world(args.device)
    logging.info('distributed: rank %d/%d on %s', world.rank, world.size,
                 world.device)
  from easyrec_torch import main as main_lib
  edits = json.loads(args.edit_config_json) if args.edit_config_json else {}
  if args.model_dir:
    edits['model_dir'] = args.model_dir
  if args.fine_tune_checkpoint:
    edits['train_config.fine_tune_checkpoint'] = args.fine_tune_checkpoint
  if args.num_steps is not None:
    edits['train_config.num_steps'] = args.num_steps
  result = main_lib.train_and_evaluate(
      args.pipeline_config_path, edit_config_json=edits or None,
      continue_train=args.continue_train, fit_on_eval=args.fit_on_eval,
      fit_on_eval_steps=args.fit_on_eval_steps, device=args.device,
      check_mode=args.check_mode)
  logging.info('done: step=%s metrics=%s', result['global_step'],
               result.get('eval_metrics', {}))
  return 0


if __name__ == '__main__':
  _rc = main()
  from easyrec_torch.utils.proc import exit_after
  exit_after(_rc)
