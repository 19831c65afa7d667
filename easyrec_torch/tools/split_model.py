"""Split a trained match model's export into a user and an item tower.

Counterpart of easyrec_tpu/tools/split_model.py (:22-88): recall serving
embeds the item corpus offline with the item tower and answers users
online with the user tower, so each side gets an export of its own whose
export_meta.json names the tower (`tower`), its outputs (`outputs`), its
features (`inputs`) and the input columns they read
(`required_columns`). The Predictor of such an export answers only the
tower's outputs and fills the columns it is not given with '' (the JAX
package runs both towers too).

  python -m easyrec_torch.tools.split_model \
      --export_dir <model_dir>/export/final/<ts> \
      --output_dir <dir>       # writes <dir>/user and <dir>/item
      [--device cpu]

The CLI then loads each tower's export with the Predictor on --device
(CUDA by default) and checks that a one-row request answers exactly the
outputs the meta names.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil

TOWER_OUTPUTS = {
    'user': ['user_emb', 'user_tower_emb', 'user_interests'],
    'item': ['item_emb', 'item_tower_emb'],
}


def split_export(export_dir: str, output_dir: str, device=None) -> dict:
  """Copy the export once per tower, each copy's meta restricted to that
  tower: its feature groups are `user` or `item`, groups named
  `<tower>_*`, and for the user tower `hist`. With a `device`, each copy
  is loaded there and must answer its outputs and no other. Returns
  {tower: path}."""
  from easyrec_torch.config import config_util
  from easyrec_torch.export import saved_model as sm

  config = config_util.get_configs_from_pipeline_file(
      os.path.join(export_dir, sm.CONFIG_FILE))
  groups = {g.group_name: list(g.feature_names)
            for g in config.model_config.feature_groups}
  feature_inputs = {}
  for fc in config_util.get_feature_configs(config):
    feature_inputs[fc.feature_name or fc.input_names[0]] = \
        list(fc.input_names)
  with open(os.path.join(export_dir, sm.EXPORT_META)) as f:
    meta = json.load(f)

  out = {}
  for tower in ('user', 'item'):
    feats = []
    for gname, names in groups.items():
      if gname == tower or gname.startswith(tower + '_') or \
          (tower == 'user' and gname == 'hist'):
        feats.extend(names)
    if not feats:
      logging.warning('no %r feature group found; skipping tower', tower)
      continue
    dst = os.path.join(output_dir, tower)
    if os.path.exists(dst):
      shutil.rmtree(dst)
    shutil.copytree(export_dir, dst)
    tower_meta = dict(meta)
    tower_meta['tower'] = tower
    tower_meta['outputs'] = [o for o in meta.get('outputs', [])
                             if o in TOWER_OUTPUTS[tower]]
    tower_meta['inputs'] = {f: meta.get('inputs', {}).get(f, {})
                            for f in feats}
    tower_meta['required_columns'] = sorted(
        {c for f in feats for c in feature_inputs.get(f, [f])})
    with open(os.path.join(dst, sm.EXPORT_META), 'w') as f:
      json.dump(tower_meta, f, indent=2)
    out[tower] = dst
    logging.info('%s tower -> %s (outputs=%s)', tower, dst,
                 tower_meta['outputs'])
    if device is not None:
      check_tower(dst, tower_meta, device)
  return out


def check_tower(export_dir: str, meta: dict, device) -> None:
  """Raise unless the tower export at export_dir, fed one row of its
  required columns (all ''), answers exactly meta['outputs']."""
  import numpy as np
  from easyrec_torch.export.predictor import Predictor
  pred = Predictor(export_dir, device=device)
  row = {c: np.array([''], dtype=object) for c in meta['required_columns']}
  got = sorted(k for k in pred.predict_columns(row)
               if not (meta.get('export_features') and
                       k.startswith('feature_')))
  if got != sorted(meta['outputs']):
    raise ValueError('tower export %s answers %s, its meta names %s'
                     % (export_dir, got, meta['outputs']))


def main(argv=None) -> int:
  logging.basicConfig(level=logging.INFO)
  parser = argparse.ArgumentParser()
  parser.add_argument('--export_dir', required=True)
  parser.add_argument('--output_dir', required=True)
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'")
  args = parser.parse_args(argv)
  from easyrec_torch.device import resolve_device
  device = resolve_device(args.device)
  print(json.dumps(split_export(args.export_dir, args.output_dir,
                                device=device)))
  return 0


if __name__ == '__main__':
  raise SystemExit(main())
