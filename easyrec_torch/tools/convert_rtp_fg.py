"""Turn an RTP fg.json into a standalone pipeline config.

Counterpart of easyrec_tpu/tools/convert_rtp_fg.py over the port's
utils/fg_util.py and config/text_format.to_text: the fg.json's input
fields and feature configs (the label first), either alone or merged into
--base_config, whose fg_json_path is then cleared (the output needs no
fg.json at run time).

  python -m easyrec_torch.tools.convert_rtp_fg \
      --rtp_fg fg.json --label clk --output_path pipeline.config \
      [--base_config existing.config] [--embedding_dim 16]
"""

from __future__ import annotations

import argparse
import json
import logging

from easyrec_torch.config import config_util
from easyrec_torch.config.text_format import Message, to_text
from easyrec_torch.utils import fg_util


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--rtp_fg', required=True, help='fg.json path')
  p.add_argument('--output_path', required=True)
  p.add_argument('--label', default='', help='label field name '
                 '(prepended to input_fields; fg.json "label" wins)')
  p.add_argument('--base_config', default='',
                 help='existing pipeline config to merge the generated '
                      'data/feature configs into')
  p.add_argument('--embedding_dim', type=int, default=16)
  args = p.parse_args(argv)

  with open(args.rtp_fg) as f:
    fg = json.load(f)
  if args.base_config:
    cfg = config_util.get_configs_from_pipeline_file(args.base_config)
    if args.label and not cfg.data_config.label_fields:
      cfg.data_config.label_fields.append(args.label)
    cfg.fg_json_path = args.rtp_fg
    fg_util.load_fg_json_to_config(cfg)
    cfg.fg_json_path = ''              # generated: no runtime dependency
  else:
    converted = fg_util.convert_rtp_fg(
        fg, embedding_dim=args.embedding_dim,
        label_fields=[args.label] if args.label else [])
    cfg = Message('EasyRecConfig')
    cfg.data_config = Message('DatasetConfig')
    cfg.data_config.input_fields = converted['input_fields']
    cfg.data_config.label_fields = converted['label_fields']
    cfg.feature_config = Message('FeatureConfigV2')
    cfg.feature_config.features = converted['feature_configs']
  with open(args.output_path, 'w') as f:
    f.write(to_text(cfg))
  logging.info('wrote %s (%d input_fields, %d features)',
               args.output_path, len(cfg.data_config.input_fields),
               len(cfg.feature_config.features))


if __name__ == '__main__':
  logging.basicConfig(level=logging.INFO)
  main()
