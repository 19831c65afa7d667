"""What the plain references share: a dense layer, BatchNorm, an MLP, the
sigmoid cross entropy, and three training steps with the configuration's
optimizers, read out as the harness reads the port.

Plain PyTorch in float32 with TF32 off. It imports nothing of
easyrec_torch and takes nothing the port made: the harness hands it the
configuration's description (recbench/configs/<config>.json "model"), the
initial weights of recbench/weights.py and the batches of
recbench/traffic.py, the same it hands the port. What the port derives
from them (its fused, packed table with the moments as bf16 pairs in one
word) is worked out again here from the configuration: one table a
feature and role, f32 weights, moments held at bf16 precision where the
configuration states `"moments": "bf16_pair"`.

The optimizers are optax's, as the configuration's framework states them:
dense Adam (mu, nu, bias corrections at the update count) and lazy Adam on
the table rows a batch touches (the global step's bias corrections; the
update uses the new moments before they are stored at bf16), over the
per-row gradient sums, whose slots are rounded to bf16 and the sums once
more where the configuration states `"grad_sum": "bf16"`.

A feature of kind `dense` has no table: its values reach the model
through the batch (feat.<f>.dense). Each table is held once, trained in
place; the lazy moments are kept for the rows a step has touched alone
(an untouched row's are zero), and the change from the initial table is
read against the initial rows drawn again, block by block.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Tuple

import torch

from recbench.cell import TABLELESS, table_features  # noqa: F401

Leaf = str


def no_tf32() -> None:
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False


def bf16(x: torch.Tensor) -> torch.Tensor:
  """x rounded to the nearest bf16 (ties to even), kept in float32."""
  return x.to(torch.bfloat16).to(torch.float32)


def dense(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str
          ) -> torch.Tensor:
  return x @ p[name + '.weight'].T + p[name + '.bias']


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
               eps: float = 1e-5) -> torch.Tensor:
  """Training-mode BatchNorm: the batch's mean and biased variance."""
  mean = x.mean(dim=0)
  var = ((x - mean) ** 2).mean(dim=0)
  return (x - mean) / torch.sqrt(var + eps) * p[name + '.weight'] + \
      p[name + '.bias']


def mlp(x: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str,
        units: List[int], bn: bool = True, last_relu: bool = True
        ) -> torch.Tensor:
  """Dense, BatchNorm (with `bn`), relu per layer; the last layer's relu
  only with `last_relu`."""
  for i in range(len(units)):
    x = dense(x, p, '%s.dense_%d' % (prefix, i))
    if bn:
      x = batch_norm(x, p, '%s.bn_%d' % (prefix, i))
    if i < len(units) - 1 or last_relu:
      x = torch.relu(x)
  return x


def mlp_shapes(prefix: str, units: List[int], fan_in: int,
               bn: bool = True) -> Tuple[Dict[str, Tuple[int, ...]], int]:
  shapes = {}
  for i, u in enumerate(units):
    shapes['%s.dense_%d.weight' % (prefix, i)] = (u, fan_in)
    shapes['%s.dense_%d.bias' % (prefix, i)] = (u,)
    if bn:
      shapes['%s.bn_%d.weight' % (prefix, i)] = (u,)
      shapes['%s.bn_%d.bias' % (prefix, i)] = (u,)
    fan_in = u
  return shapes, fan_in


def mlp_flops(units: List[int], fan_in: int) -> float:
  """Multiply-adds of an MLP's products, counted as two operations."""
  total = 0.0
  for u in units:
    total += 2.0 * fan_in * u
    fan_in = u
  return total


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
  """The weighted mean of the sigmoid cross entropy."""
  per = torch.clamp(logits, min=0) - logits * labels + \
      torch.log1p(torch.exp(-torch.abs(logits)))
  return (per * weights).sum() / torch.clamp(weights.sum(), min=1e-9)


def pooled(rows: torch.Tensor, batch, name: str) -> torch.Tensor:
  """[B, k, d] rows of a feature -> [B, d], summed with its weights."""
  return (rows * batch['feat.%s.weights' % name][:, :, None]).sum(dim=1)


def roles(feature: dict) -> List[Tuple[str, int]]:
  """(role, width) of each table a feature has: none for a `dense`
  feature."""
  if feature['kind'] in TABLELESS:
    return []
  out = [('deep', int(feature['dim']))]
  if int(feature.get('wide_dim', 0)):
    out.append(('wide', int(feature['wide_dim'])))
  return out


def leaf_name(name: str, role: str) -> Leaf:
  return 'table.%s' % name if role == 'deep' else 'table.%s.wide' % name


def learning_rate(opt: dict, step: int) -> float:
  """Exponential decay, not staircase, floored at min_learning_rate."""
  lr = opt['initial_learning_rate'] * \
      opt['decay_factor'] ** (step / opt['decay_steps'])
  return max(lr, opt['min_learning_rate'])


def _norm(x: torch.Tensor) -> float:
  return float(torch.linalg.vector_norm(x.to(torch.float64)))


def squared_gap(a: torch.Tensor, b: torch.Tensor) -> float:
  """sum((a - b) ** 2) in float64, over one block of a table's rows."""
  return float(((a - b).double() ** 2).sum())


class Moments:
  """Lazy Adam's moments of the rows a table's updates have touched:
  sorted row ids and their m and v; every other row's are zero."""

  def __init__(self, width: int, device):
    self.rows = torch.zeros(0, dtype=torch.int64, device=device)
    self.m = torch.zeros((0, width), device=device)
    self.v = torch.zeros((0, width), device=device)

  def _find(self, rows: torch.Tensor):
    """(where each of `rows` is or would go, whether it is there)."""
    n = self.rows.shape[0]
    if n == 0:
      return rows, torch.zeros_like(rows, dtype=torch.bool)
    pos = torch.searchsorted(self.rows, rows).clamp_(max=n - 1)
    return pos, self.rows[pos] == rows

  def get(self, rows: torch.Tensor):
    """(m, v) of `rows` (sorted, distinct), zero where never touched."""
    pos, known = self._find(rows)
    m = torch.zeros((rows.shape[0], self.m.shape[1]), device=self.m.device)
    v = torch.zeros_like(m)
    m[known] = self.m[pos[known]]
    v[known] = self.v[pos[known]]
    return m, v

  def put(self, rows: torch.Tensor, m: torch.Tensor, v: torch.Tensor):
    """Store (m, v) of `rows` (sorted, distinct)."""
    pos, known = self._find(rows)
    self.m[pos[known]] = m[known]
    self.v[pos[known]] = v[known]
    new = ~known
    every = torch.cat([self.rows, rows[new]])
    order = torch.argsort(every)
    self.rows = every[order]
    self.m = torch.cat([self.m, m[new]])[order]
    self.v = torch.cat([self.v, v[new]])[order]


class Reference:
  """A configuration's model trained by plain PyTorch from the harness's
  initial weights. `loss_fn(params, emb, batch)` is the reference module's
  model loss; emb maps (feature, role) to its pulled rows [B, k, d].
  `tables` maps (feature, role) to its initial table, which is trained in
  place; `initial(feature)` draws a feature's initial [rows, dim +
  wide_dim] table again as (lo, hi, rows lo..hi) blocks, for the change
  norms."""

  def __init__(self, model: dict, loss_fn: Callable,
               tables: Dict[Tuple[str, str], torch.Tensor],
               dense_params: Dict[str, torch.Tensor],
               initial: Callable[[dict], Iterator[Tuple[int, int,
                                                         torch.Tensor]]]):
    self.model = model
    self.loss_fn = loss_fn
    self.features = model['features']
    self.w = tables
    self.initial = initial
    self.moments = {k: Moments(t.shape[1], t.device)
                    for k, t in tables.items()}
    self.p = {k: t.clone() for k, t in dense_params.items()}
    self.p0 = dense_params
    self.mu = {k: torch.zeros_like(t) for k, t in dense_params.items()}
    self.nu = {k: torch.zeros_like(t) for k, t in dense_params.items()}
    self.step = 0

  def total_loss(self, batch):
    """(total loss, pulled rows by (feature, role), dense leaves): the
    model loss, l2 over the kernels and the embedding regulariser over
    every pulled row, masked by sample_weight."""
    emb = {}
    for f in table_features(self.features):
      ids = batch['feat.%s.ids' % f['name']].to(torch.int64)
      for role, _ in roles(f):
        emb[(f['name'], role)] = \
            self.w[(f['name'], role)][ids].requires_grad_()
    params = {k: t.detach().requires_grad_() for k, t in self.p.items()}
    total = self.loss_fn(params, emb, batch)
    l2 = float(self.model['l2_regularization'])
    if l2 > 0:
      total = total + l2 * sum(torch.sum(t * t) for k, t in
                               sorted(params.items())
                               if k.endswith('.weight') and t.ndim >= 2)
    reg = float(self.model['embedding_regularization'])
    if reg > 0:
      valid = (batch['sample_weight'] > 0).to(torch.float32)
      per_row = sum(torch.sum(r * r, dim=(1, 2)) for r in emb.values())
      total = total + reg * torch.sum(per_row * valid)
    return total, emb, params

  @torch.no_grad()
  def _dense_update(self, params, lr: float, opt: dict) -> None:
    b1, b2, eps = opt['b1'], opt['b2'], opt['eps']
    t = self.step + 1
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    for k, leaf in params.items():
      g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
      self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
      self.nu[k] = (1 - b2) * (g * g) + b2 * self.nu[k]
      self.p[k] = self.p[k] - lr * (self.mu[k] / bc1) / \
          (torch.sqrt(self.nu[k] / bc2) + eps)

  @torch.no_grad()
  def _sparse_update(self, batch, emb, lr: float, opt: dict) -> None:
    sparse = self.model['sparse']
    b1, b2, eps = opt['b1'], opt['b2'], opt['eps']
    t = self.step + 1
    c1, c2 = 1.0 / (1 - b1 ** t), 1.0 / (1 - b2 ** t)
    for f in table_features(self.features):
      ids = batch['feat.%s.ids' % f['name']].reshape(-1).to(torch.int64)
      uniq, inv = torch.unique(ids, return_inverse=True)
      sums = {}
      for role, width in roles(f):
        g = emb[(f['name'], role)].grad.reshape(-1, width)
        if sparse['grad_sum'] == 'bf16':
          g = bf16(g)
        s = torch.zeros((uniq.shape[0], width), dtype=torch.float64,
                        device=g.device).index_add_(0, inv, g.double())
        s = s.to(torch.float32)
        sums[role] = bf16(s) if sparse['grad_sum'] == 'bf16' else s
      touched = torch.zeros(uniq.shape[0], dtype=torch.bool,
                            device=ids.device)
      for s in sums.values():
        touched |= (s != 0).any(dim=1)
      rows = uniq[touched]
      for role, _ in roles(f):
        key = (f['name'], role)
        g = sums[role][touched]
        m0, v0 = self.moments[key].get(rows)
        m = b1 * m0 + (1 - b1) * g
        v = b2 * v0 + (1 - b2) * (g * g)
        self.w[key][rows] += -lr * (m * c1) / (torch.sqrt(v * c2) + eps)
        if sparse['moments'] == 'bf16_pair':
          m, v = bf16(m), bf16(v)
        self.moments[key].put(rows, m, v)

  def train_step(self, batch) -> float:
    total, emb, params = self.total_loss(batch)
    total.backward()
    opt = self.model['optimizer']
    lr = learning_rate(opt, self.step)
    self._dense_update(params, lr, opt)
    self._sparse_update(batch, emb, lr, opt)
    self.step += 1
    return float(total.detach())

  def gradient_norms(self) -> Dict[str, Dict[Leaf, float]]:
    """Each leaf's first gradient as the optimizer holds it after one
    step: |mu| / (1 - b1) and |sqrt(nu)| / sqrt(1 - b2)."""
    opt = self.model['optimizer']
    a, b = 1 - opt['b1'], math.sqrt(1 - opt['b2'])
    grad_m = {k: _norm(t) / a for k, t in self.mu.items()}
    grad_v = {k: math.sqrt(float(t.double().sum())) / b
              for k, t in self.nu.items()}
    for (name, role), mom in self.moments.items():
      grad_m[leaf_name(name, role)] = _norm(mom.m) / a
      grad_v[leaf_name(name, role)] = \
          math.sqrt(float(mom.v.double().sum())) / b
    return {'grad_m': grad_m, 'grad_v': grad_v}

  @torch.no_grad()
  def change_norms(self) -> Dict[Leaf, float]:
    out = {k: _norm(t - self.p0[k]) for k, t in self.p.items()}
    for f in table_features(self.features):
      sq = {role: 0.0 for role, _ in roles(f)}
      for lo, hi, block in self.initial(f):
        at = 0
        for role, width in roles(f):
          sq[role] += squared_gap(self.w[(f['name'], role)][lo:hi],
                                  block[:, at:at + width])
          at += width
        del block
      for role in sq:
        out[leaf_name(f['name'], role)] = math.sqrt(sq[role])
    return out


def readings(ref: Reference, batches: List[dict], steps: int = 3) -> dict:
  """The harness's readings of `steps` steps: each step's total loss, the
  first gradient's norms by leaf, the change of every leaf after the
  last step."""
  out = {'loss': []}
  for i in range(steps):
    out['loss'].append(ref.train_step(batches[i]))
    if i == 0:
      out.update(ref.gradient_norms())
  out['change'] = ref.change_norms()
  return out
