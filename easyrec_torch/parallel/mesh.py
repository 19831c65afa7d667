"""The world of processes, the sharding rules and the batch-wide reductions.

Counterpart of easyrec_tpu/parallel/mesh.py. The JAX package runs one SPMD
program over a ('data', 'model') device mesh: batch rows are sharded over
every device and, under the EmbeddingParallel-style strategies, so are the
rows of every fused table. The port runs one process a device instead:
  - a World (rank, size, local device, process group) is joined from the
    torchrun environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT), over NCCL on CUDA and gloo where the caller asks for the
    CPU; a process that joins none stays on the single-device path;
  - build_mesh checks data_parallel * model_parallel == world size
    (:30-45); make_rules row-shards the tables under
    EmbeddingParallelStrategy, SokStrategy, NoStrategy and PSStrategy and
    replicates them under the others (:108-125);
  - RowSplit is the owner of every row: the row blocks of the JAX
    package's packed geometry (ops/packed_table.py PackMeta and
    local_view, :125-171), so the same ids go to the same owner as there.

A JAX step reduces over the GLOBAL batch wherever it sums over the batch
axis. In a world of more than one process the port keeps that: inside
`step_scope(world)` the loss denominators and numerators, BatchNorm's
statistics and a match model's in-batch columns go through batch_sum and
gather_rows, collectives whose backward SUMS the gradients of every rank.
Every rank then holds the same global loss, the gradient of a rank's own
data comes back world-size times, and a term every rank computes alike
(l2, the Uncertainty weights, a sampled view's regulariser) once a rank:
so the trainer divides every gradient, dense and sparse, summed over the
ranks, by the world size, and gets the global batch's gradient. A loss
that pairs rows across the batch (the pairwise, listwise and metric
learning losses, OHEM, jrc's sessions, the rolled negatives, the
backbone's contrastive loss) runs inside `whole_batch`: its inputs
gathered from every rank in rank order, with their gradient, it computes
on the global batch as one process would, every rank alike.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import math
import os
import pickle
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# train_distribute values whose tables are row-sharded (mesh.py:113-118)
SHARDING_STRATEGIES = ('EmbeddingParallelStrategy', 'SokStrategy',
                       'NoStrategy', 'PSStrategy')


@dataclasses.dataclass
class World:
  """One process of a data-parallel job: its rank, the world size, its
  device and the process group (None: the default group).

  It counts its collectives since reset_traffic() (traffic()), a dict
  update a call: by kind, [calls, payload bytes sent, payload bytes
  received]. An all_reduce sends and receives its tensor, an all_gather
  sends its tensor and receives every rank's, an all_gather_object its
  pickled object and every rank's, an all_to_all what its split sizes say
  (also by peer rank: [sent, received]), a broadcast_object its arrays'
  bytes, sent at the root and received elsewhere. host_syncs counts the
  collectives whose result the host waits for (a route's size matrix,
  all_gather_rows' sizes). tools/scaling_model.py prices the payloads as
  wire bytes."""
  rank: int
  size: int
  device: torch.device
  group: object = None
  _traffic: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
  _peers: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
  _syncs: List[int] = dataclasses.field(default_factory=lambda: [0])

  def count_traffic(self, kind: str, sent: int, recv: int) -> None:
    c = self._traffic.setdefault(kind, [0, 0, 0])
    c[0] += 1
    c[1] += int(sent)
    c[2] += int(recv)

  def count_peers(self, sent: Sequence[int], recv: Sequence[int]) -> None:
    """An all_to_all's bytes to and from each peer rank, in rank order."""
    for peer, (s, r) in enumerate(zip(sent, recv)):
      c = self._peers.setdefault(peer, [0, 0])
      c[0] += int(s)
      c[1] += int(r)

  def count_host_sync(self) -> None:
    self._syncs[0] += 1

  def traffic(self) -> dict:
    """What this rank's collectives moved since reset_traffic()."""
    return {'kinds': {k: {'calls': c[0], 'sent': c[1], 'recv': c[2]}
                      for k, c in self._traffic.items()},
            'peers': {p: {'sent': c[0], 'recv': c[1]}
                      for p, c in self._peers.items()},
            'host_syncs': self._syncs[0]}

  def reset_traffic(self) -> None:
    self._traffic.clear()
    self._peers.clear()
    self._syncs[0] = 0

  @property
  def is_chief(self) -> bool:
    return self.rank == 0

  def barrier(self) -> None:
    if self.device.type == 'cuda':
      dist.barrier(group=self.group, device_ids=[self.device.index])
    else:
      dist.barrier(group=self.group)

  def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
    """In-place sum over the ranks; returns `t`."""
    nbytes = t.numel() * t.element_size()
    self.count_traffic('all_reduce', nbytes, nbytes)
    dist.all_reduce(t, group=self.group)
    return t

  def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's `t` (same shape on every rank), in rank order."""
    nbytes = t.numel() * t.element_size()
    self.count_traffic('all_gather', nbytes, nbytes * self.size)
    out = [torch.empty_like(t) for _ in range(self.size)]
    dist.all_gather(out, t.contiguous(), group=self.group)
    return out

  def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `t` ([n_r, ...], n_r may differ), concatenated
    in rank order."""
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    self.count_host_sync()
    sizes = [int(s) for s in torch.cat(self.all_gather(n)).tolist()]
    top = max(sizes)
    pad = t
    if t.shape[0] < top:
      pad = torch.cat([t, t.new_zeros((top - t.shape[0],) + t.shape[1:])])
    parts = self.all_gather(pad)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])

  def gather_objects(self, obj) -> list:
    """Every rank's picklable `obj`, in rank order."""
    out = [None] * self.size
    dist.all_gather_object(out, obj, group=self.group)
    self.count_traffic('all_gather_object', len(pickle.dumps(obj)),
                       sum(len(pickle.dumps(o)) for o in out))
    return out


_JOINED: List[Optional[World]] = [None]
# a Trainer's default world: the one this process joined, if any
CURRENT = 'current'


def world_requested() -> bool:
  """Whether this process was started to join a world: the torchrun
  environment is set, or EASYREC_DISTRIBUTED=1 (easyrec_tpu/train_eval.py
  :43-50)."""
  return bool(os.environ.get('WORLD_SIZE')) or \
      os.environ.get('EASYREC_DISTRIBUTED') == '1'


def world_device(device=None, local_rank: int = 0) -> torch.device:
  """cuda:<local_rank> unless the caller asks for the CPU; CUDA asked for
  and absent raises (no process of a world falls back on the CPU)."""
  dev = torch.device('cuda' if device is None else device)
  if dev.type == 'cpu':
    return dev
  if dev.type != 'cuda':
    raise ValueError('unsupported device %s' % dev)
  if not torch.cuda.is_available():
    raise RuntimeError(
        'device %s was asked for but torch.cuda.is_available() is False; '
        "pass device='cpu' (CLI: --device cpu) to run on the CPU" % dev)
  if dev.index is None:
    dev = torch.device('cuda', local_rank)
  torch.cuda.set_device(dev)
  return dev


def join_world(device=None, rank: Optional[int] = None,
               size: Optional[int] = None, init_method: Optional[str] = None,
               timeout_s: float = 300.0) -> World:
  """Join the world this process belongs to and make it the current one.

  rank, size and init_method default to the torchrun environment (RANK,
  WORLD_SIZE, MASTER_ADDR and MASTER_PORT; LOCAL_RANK picks the card).
  The backend is NCCL on CUDA and gloo on the CPU; nothing swaps one for
  the other."""
  if _JOINED[0] is not None:
    return _JOINED[0]
  rank = int(os.environ.get('RANK', '0')) if rank is None else int(rank)
  size = int(os.environ.get('WORLD_SIZE', '1')) if size is None \
      else int(size)
  local_rank = int(os.environ.get('LOCAL_RANK', str(rank)))
  dev = world_device(device, local_rank)
  if init_method is None:
    init_method = 'tcp://%s:%s' % (
        os.environ.get('MASTER_ADDR', 'localhost'),
        os.environ.get('MASTER_PORT', '29500'))
  backend = 'nccl' if dev.type == 'cuda' else 'gloo'
  kw = {'device_id': dev} if dev.type == 'cuda' else {}
  dist.init_process_group(backend, init_method=init_method, rank=rank,
                          world_size=size,
                          timeout=datetime.timedelta(seconds=timeout_s),
                          **kw)
  _JOINED[0] = World(rank=rank, size=size, device=dev)
  return _JOINED[0]


def current_world() -> Optional[World]:
  """The world join_world joined, or None on the single-device path."""
  return _JOINED[0]


def leave_world() -> None:
  if _JOINED[0] is not None:
    dist.destroy_process_group()
    _JOINED[0] = None


def build_mesh(data_parallel: int = 0, model_parallel: int = 1,
               world_size: int = 1):
  """(data, model) sizes of the mesh over `world_size` processes (JAX
  build_mesh, :30-45): model_parallel <= 0 is 1, data_parallel <= 0 fills
  the world."""
  if model_parallel <= 0:
    model_parallel = 1
  if data_parallel <= 0:
    data_parallel = world_size // model_parallel
  if data_parallel * model_parallel != world_size:
    raise ValueError('mesh %dx%d does not cover %d devices'
                     % (data_parallel, model_parallel, world_size))
  return data_parallel, model_parallel


@dataclasses.dataclass
class ShardingRules:
  world: World
  shard_embeddings: bool
  mesh: tuple


def make_rules(train_config, world: World) -> ShardingRules:
  """The mesh and whether tables are row-sharded, from train_config
  (JAX make_rules, :108-125)."""
  mesh = build_mesh(int(train_config.mesh_data_parallel),
                    int(train_config.mesh_model_parallel), world.size)
  return ShardingRules(world, train_config.train_distribute in
                       SHARDING_STRATEGIES, mesh)


# ---------------------------------------------------------------- row split

@dataclasses.dataclass(frozen=True)
class RowSplit:
  """Which rank owns which rows of one table [rows, width]: rank r owns
  [r * local_rows, (r + 1) * local_rows), cut at `rows`. padded_rows is the
  JAX package's meta.rows, which sizes its exchange buffers."""
  rows: int
  local_rows: int
  world: int
  padded_rows: int

  def start(self, rank: int) -> int:
    return min(rank * self.local_rows, self.rows)

  def count(self, rank: int) -> int:
    return self.start(rank + 1) - self.start(rank)

  @property
  def live_owners(self) -> int:
    """Ranks whose block holds a row of the padded table (JAX
    `live = -(-meta.rows // local_rows)`)."""
    return -(-self.padded_rows // self.local_rows)


def row_split(rows: int, dim: int, n_parts: int, world: int) -> RowSplit:
  """The JAX package's row blocks of a table of `rows` logical rows (the
  scratch row included) whose combined row holds `n_parts` physical parts
  of `dim` (a compact Adam table 2): PackMeta(round_up(rows, 8 * world),
  dim, shards=world).local_view() holds groups / world groups of
  8 * (lcm(cc, 128) / cc) rows, cc = n_parts * dim."""
  cc = n_parts * dim
  width = cc * (128 // math.gcd(cc, 128))
  group_rows = 8 * (width // cc)
  pad = max(8 * world, 8)
  padded = -(-rows // pad) * pad
  g = padded // group_rows + 2
  quantum = 256 * world // math.gcd(256, world)
  groups = -(-g // quantum) * quantum
  return RowSplit(rows=int(rows), local_rows=groups // world * group_rows,
                  world=int(world), padded_rows=int(padded))


# ------------------------------------------- reductions over the global batch

_ACTIVE: List[Optional[World]] = [None]


@contextlib.contextmanager
def step_scope(world: Optional[World]):
  """Make the batch-wide reductions below global over `world` for the
  forward and loss of one step (a world of one rank needs none)."""
  prev = _ACTIVE[0]
  _ACTIVE[0] = world if world is not None and world.size > 1 else None
  try:
    yield
  finally:
    _ACTIVE[0] = prev


def active_world() -> Optional[World]:
  """The world of the step being run, where it has more than one rank."""
  return _ACTIVE[0]


class _AllReduceSum(torch.autograd.Function):
  """Sum over the ranks; the backward sums the ranks' gradients."""

  @staticmethod
  def forward(ctx, x, world):
    ctx.world = world
    y = x.detach().clone().contiguous()
    return world.all_reduce(y)

  @staticmethod
  def backward(ctx, g):
    return ctx.world.all_reduce(g.detach().clone().contiguous()), None


class _GatherRows(torch.autograd.Function):
  """Every rank's rows in rank order (equal row counts); the backward sums
  the ranks' gradients of this rank's rows."""

  @staticmethod
  def forward(ctx, x, world):
    ctx.world = world
    ctx.n = x.shape[0]
    return torch.cat(world.all_gather(x.detach()))

  @staticmethod
  def backward(ctx, g):
    g = ctx.world.all_reduce(g.detach().clone().contiguous())
    r = ctx.world.rank
    return g[r * ctx.n:(r + 1) * ctx.n], None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
  """`x` summed over the ranks of the active world (x itself outside one):
  a sum over this rank's rows becomes the sum over the global batch."""
  world = active_world()
  return x if world is None else _AllReduceSum.apply(x, world)


@contextlib.contextmanager
def whole_batch(*tensors):
  """Inside, the tensors (None stays None) as the global batch's rows in
  rank order, the floating ones with their gradient (gather_rows), and no
  reduction over the ranks: a loss that pairs rows of the batch computes
  on the global batch as one process would. Outside a world, the tensors
  themselves."""
  world = active_world()
  if world is None:
    yield tensors
    return
  out = tuple(t if t is None else
              _GatherRows.apply(t, world) if t.is_floating_point() else
              torch.cat(world.all_gather(t)) for t in tensors)
  _ACTIVE[0] = None
  try:
    yield out
  finally:
    _ACTIVE[0] = world


def gather_rows(x: torch.Tensor):
  """(every rank's rows of x in rank order, the first row of this rank's
  among them); (x, 0) outside a world."""
  world = active_world()
  if world is None:
    return x, 0
  return _GatherRows.apply(x, world), world.rank * x.shape[0]


def gather_ids(x: torch.Tensor) -> torch.Tensor:
  """Every rank's rows of a tensor without gradient, in rank order."""
  world = active_world()
  return x if world is None else torch.cat(world.all_gather(x))


def all_equal(world: World, tensors: Sequence[torch.Tensor]) -> bool:
  """Whether every rank holds the same bits in `tensors` (a check of the
  replicated state)."""
  mine = [hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()
          for t in tensors]
  return all(o == mine for o in world.gather_objects(mine))
