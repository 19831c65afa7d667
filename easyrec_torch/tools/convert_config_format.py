"""Convert a pipeline config between text format (.config) and JSON (.json).

Counterpart of easyrec_tpu/tools/convert_config_format.py: each path's
extension picks the codec, config/text_format.py for .config and
config/json_format.py for .json (protobuf's JSON form under the proto
field names, as the JAX tool writes it with preserving_proto_field_name;
read with unknown fields dropped). A field the port's schema does not
list is dropped on the way, as the port's text reader drops it.

  python -m easyrec_torch.tools.convert_config_format \
      --input_config pipeline.config --output_config pipeline.json
"""

from __future__ import annotations

import argparse
import os

from easyrec_torch.config import json_format
from easyrec_torch.config.text_format import Message, parse, to_text


def load_config(path: str) -> Message:
  with open(path, 'r') as f:
    content = f.read()
  if path.endswith('.json'):
    return json_format.parse(content, 'EasyRecConfig')
  if path.endswith('.config'):
    return parse(content, 'EasyRecConfig')
  raise ValueError('only .config/.json are supported (%s)' % path)


def save_config(config: Message, path: str) -> None:
  if path.endswith('.json'):
    text = json_format.message_to_json(config,
                                       preserving_proto_field_name=True)
  elif path.endswith('.config'):
    text = to_text(config)
  else:
    raise ValueError('only .config/.json are supported (%s)' % path)
  with open(path, 'w') as f:
    f.write(text)


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--input_config', required=True)
  parser.add_argument('--output_config', required=True)
  args = parser.parse_args(argv)
  assert os.path.exists(args.input_config), args.input_config
  save_config(load_config(args.input_config), args.output_config)
  print('wrote %s' % args.output_config)


if __name__ == '__main__':
  main()
