"""Local hyper-parameter tuner.

Counterpart of easyrec_tpu/hpo/tuner.py: a sequential search over dotted
config paths (config_util.edit_config's, selectors included), each trial
one train_and_evaluate on --device (CUDA by default) in the model_dir
`<model_dir>/hpo_trial_<i>`, the summary written to
`<model_dir>/hpo_result.json`. Modes: random, grid, and bayes (a Gaussian
process with an RBF kernel and expected improvement, in numpy). Under one
seed the trials' parameters are the JAX tuner's: both draw from numpy's
generator in the same order.

search_space.json, a list of parameter specs:
  [{"name": "train_config.optimizer_config[0].adam_optimizer.learning_rate
             .constant_learning_rate.learning_rate",
    "type": "double", "min": 1e-4, "max": 1e-2, "log_scale": true},
   {"name": "model_config.deepfm.dnn.hidden_units",
    "type": "categorical", "candidates": [[64, 32], [128, 64, 32]]}]

  python -m easyrec_torch.hpo.tuner --pipeline_config_path cfg \
      --search_space_path space.json --num_trials 8 --metric auc \
      [--mode random|grid|bayes] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import logging
import math
import os
from typing import Dict, List

import numpy as np


def _sample_value(spec: dict, rng: np.random.Generator):
  t = spec.get('type', 'categorical').lower()
  if t in ('categorical', 'enum', 'choice'):
    cands = spec['candidates']
    return cands[int(rng.integers(0, len(cands)))]
  lo, hi = float(spec['min']), float(spec['max'])
  if spec.get('log_scale'):
    v = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
  else:
    v = float(rng.uniform(lo, hi))
  if t in ('integer', 'int'):
    return int(round(v))
  return v


def _grid_values(spec: dict, grid_points: int) -> List:
  t = spec.get('type', 'categorical').lower()
  if t in ('categorical', 'enum', 'choice'):
    return list(spec['candidates'])
  lo, hi = float(spec['min']), float(spec['max'])
  if spec.get('log_scale'):
    vals = np.exp(np.linspace(np.log(lo), np.log(hi), grid_points))
  else:
    vals = np.linspace(lo, hi, grid_points)
  if t in ('integer', 'int'):
    return sorted({int(round(v)) for v in vals})
  return [float(v) for v in vals]


def _encode(spec: dict, value) -> float:
  """Map a sampled value into [0, 1] for the GP."""
  t = spec.get('type', 'categorical').lower()
  if t in ('categorical', 'enum', 'choice'):
    cands = spec['candidates']
    if len(cands) == 1:
      return 0.0
    return cands.index(value) / (len(cands) - 1)
  lo, hi = float(spec['min']), float(spec['max'])
  if spec.get('log_scale'):
    lo, hi, value = np.log(lo), np.log(hi), np.log(float(value))
  return float((float(value) - lo) / max(hi - lo, 1e-12))


class _GPSampler:
  """Gaussian-process expected-improvement proposer (RBF kernel).

  Pure-numpy stand-in for the PAI AutoML GP tuner
  (hpo/pai_hpo.py:28): fit on normalized-encoded finished trials,
  propose the candidate (from a random pool) with the best EI.
  """

  def __init__(self, space: List[dict], rng: np.random.Generator,
               pool: int = 256, length_scale: float = 0.3,
               noise: float = 1e-4):
    self.space = space
    self.rng = rng
    self.pool = pool
    self.ls = length_scale
    self.noise = noise

  def _kern(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / self.ls ** 2)

  def propose(self, xs: np.ndarray, ys: np.ndarray) -> Dict:
    """xs: [n, d] encoded trials, ys: [n] scores (bigger better)."""
    cands = [{s['name']: _sample_value(s, self.rng) for s in self.space}
             for _ in range(self.pool)]
    xc = np.array([[_encode(s, c[s['name']]) for s in self.space]
                   for c in cands])
    mu, std = np.mean(ys), max(float(np.std(ys)), 1e-8)
    yn = (ys - mu) / std
    k = self._kern(xs, xs) + self.noise * np.eye(len(xs))
    kinv_y = np.linalg.solve(k, yn)
    kc = self._kern(xc, xs)                     # [pool, n]
    pred = kc @ kinv_y
    kinv_kc = np.linalg.solve(k, kc.T)          # [n, pool]
    var = np.clip(1.0 - np.einsum('pn,np->p', kc, kinv_kc), 1e-9, None)
    sd = np.sqrt(var)
    best = float(np.max(yn))
    z = (pred - best) / sd
    # EI = sd * (z * Phi(z) + phi(z))
    phi = np.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)
    cdf = 0.5 * (1 + np.vectorize(math.erf)(z / np.sqrt(2)))
    ei = sd * (z * cdf + phi)
    return cands[int(np.argmax(ei))]


class LocalTuner:
  """Sequential random/grid/bayes search over dotted config paths."""

  def __init__(self, pipeline_config, search_space: List[dict],
               metric: str = 'auc', metric_bigger: bool = True,
               mode: str = 'random', num_trials: int = 8,
               grid_points: int = 3, seed: int = 7, device=None):
    self.base_config = pipeline_config
    self.device = device
    self.space = search_space
    self.metric = metric
    self.bigger = metric_bigger
    self.mode = mode
    self.num_trials = num_trials
    self.grid_points = grid_points
    self.rng = np.random.default_rng(seed)
    self.trials: List[dict] = []

  def _assignments(self):
    if self.mode == 'grid':
      names = [s['name'] for s in self.space]
      grids = [_grid_values(s, self.grid_points) for s in self.space]
      for combo in itertools.product(*grids):
        yield dict(zip(names, combo))
      return
    # random / bayes: lazy so bayes sees earlier trials' results
    n_seed = max(2, min(4, self.num_trials // 2))
    gp = _GPSampler(self.space, self.rng)
    for i in range(self.num_trials):
      done = [t for t in self.trials if np.isfinite(t[self.metric])]
      if self.mode == 'bayes' and i >= n_seed and len(done) >= 2:
        xs = np.array([[_encode(s, t['assignment'][s['name']])
                        for s in self.space] for t in done])
        ys = np.array([t[self.metric] if self.bigger else -t[self.metric]
                       for t in done])
        yield gp.propose(xs, ys)
      else:
        yield {s['name']: _sample_value(s, self.rng) for s in self.space}

  def run(self) -> dict:
    from easyrec_torch import main as main_lib
    from easyrec_torch.config import config_util

    base_dir = self.base_config.model_dir
    best = None
    for i, assignment in enumerate(self._assignments()):
      if self.mode != 'grid' and i >= self.num_trials:
        break
      config = copy.deepcopy(self.base_config)
      config_util.edit_config(config, dict(assignment))
      config.model_dir = os.path.join(base_dir, 'hpo_trial_%d' % i)
      logging.info('hpo trial %d: %s', i, assignment)
      try:
        result = main_lib.train_and_evaluate(config, device=self.device)
        metrics = result.get('eval_metrics', {})
        value = float(metrics.get(self.metric, float('nan')))
      except Exception as e:  # a bad assignment must not kill the sweep
        logging.warning('trial %d failed: %s', i, e)
        metrics, value = {'error': str(e)}, float('nan')
      trial = {'trial': i, 'assignment': assignment, 'metrics':
               {k: float(v) for k, v in metrics.items()
                if isinstance(v, (int, float))},
               self.metric: value}
      self.trials.append(trial)
      if np.isfinite(value) and (
          best is None or
          (value > best[self.metric]) == self.bigger):
        best = trial
    summary = {'best': best, 'trials': self.trials,
               'metric': self.metric}
    out = os.path.join(base_dir, 'hpo_result.json')
    os.makedirs(base_dir, exist_ok=True)
    with open(out, 'w') as f:
      json.dump(summary, f, indent=2)
    logging.info('hpo done: best=%s', best)
    return summary


def main(argv=None):
  logging.basicConfig(level=logging.INFO)
  parser = argparse.ArgumentParser()
  parser.add_argument('--pipeline_config_path', required=True)
  parser.add_argument('--search_space_path', required=True)
  parser.add_argument('--metric', default='auc')
  parser.add_argument('--metric_smaller_better', action='store_true')
  parser.add_argument('--mode', default='random',
                      choices=['random', 'grid', 'bayes'])
  parser.add_argument('--num_trials', type=int, default=8)
  parser.add_argument('--grid_points', type=int, default=3)
  parser.add_argument('--device', default=None, help='cuda (default) or cpu')
  args = parser.parse_args(argv)

  from easyrec_torch.config import config_util
  config = config_util.get_configs_from_pipeline_file(
      args.pipeline_config_path)
  with open(args.search_space_path) as f:
    space = json.load(f)
  if isinstance(space, dict):
    space = space.get('param', space.get('params', []))
  tuner = LocalTuner(config, space, metric=args.metric,
                     metric_bigger=not args.metric_smaller_better,
                     mode=args.mode, num_trials=args.num_trials,
                     grid_points=args.grid_points, device=args.device)
  summary = tuner.run()
  print(json.dumps(summary['best']))


if __name__ == '__main__':
  main()
