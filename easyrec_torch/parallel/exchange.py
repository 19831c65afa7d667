"""Owner-routed id and row exchange between the ranks of a world.

Counterpart of easyrec_tpu/parallel/exchange.py. A row-sharded table's rows
belong to the rank whose block holds them (mesh.RowSplit). A rank's sorted
unique ids are already grouped by owner; the ids, and the rows or
gradients beside them, travel by torch.distributed.all_to_all_single with
split sizes, which come from one small all-gather of every rank's [W] send
sizes. An owner's buffer is capacity-bounded (capacity_rows): a chunk that
would end past it is cut, identically on every rank from the all-gathered
size matrix, and the rows cut are counted (Route.overflow);
EASYREC_EXCHANGE_CAP_FACTOR=0 keeps the worst-case buffer, which cuts
nothing. The JAX package's EASYREC_PACKED_EXCHANGE modes exist for XLA
(XLA:CPU lacks the ragged all-to-all); gloo and NCCL run the real
collective, so the port has this one exchange and reads no such variable.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from easyrec_torch.parallel.mesh import World

def capacity_rows(n_loc: int, n_dev: int, live_owners: int = 0) -> int:
  """Owner-side exchange buffer rows (JAX :35-59): the worst case n_loc *
  n_dev bounded to EASYREC_EXCHANGE_CAP_FACTOR (default 2) times the
  expected load of an owner, n_loc * n_dev / live_owners, in multiples of
  8 and at least 8. A factor of 0 or less keeps the worst case."""
  factor = float(os.environ.get('EASYREC_EXCHANGE_CAP_FACTOR', '2'))
  if factor <= 0:
    return n_loc * n_dev
  live_owners = min(max(live_owners, 1), n_dev) if live_owners else n_dev
  cap = int(-(-factor * n_loc * n_dev / live_owners // 8) * 8)
  return max(8, min(cap, n_loc * n_dev))


@dataclasses.dataclass
class Route:
  """Routing of one exchange: this rank's sorted ids grouped by owner,
  every rank's per-owner sizes, and the owner buffer's capacity."""
  keep: torch.Tensor        # [n_loc] bool: my slots sent (not cut, not pad)
  sizes: np.ndarray         # [W, W] sizes[s, t]: s sends t (after the cut)
  raw: np.ndarray           # [W, W] the sizes before the cut
  me: int
  cap: int                  # owner-side buffer rows
  n_loc: int                # requester-side slots

  @property
  def send_sizes(self) -> List[int]:
    return [int(x) for x in self.sizes[self.me, :]]

  @property
  def recv_sizes(self) -> List[int]:
    return [int(x) for x in self.sizes[:, self.me]]

  @property
  def overflow(self) -> int:
    """Rows bound for this rank that the capacity cut dropped."""
    return int((self.raw[:, self.me] - self.sizes[:, self.me]).sum())


def build_route(world: World, uids_sorted: torch.Tensor, local_rows: int,
                cap: int = None) -> Route:
  """Routing for a SORTED id list whose padding sorts last with an id of at
  least world.size * local_rows (sent nowhere); JAX build_route (:109-144).
  Every sender's chunk keeps its landing offset at the owner (the sum of
  earlier senders' sizes before the cut), and a chunk that would end past
  `cap` is cut there. cap=None keeps the unbounded n_loc * W buffer."""
  n_dev, me = world.size, world.rank
  n_loc = int(uids_sorted.shape[0])
  dev = uids_sorted.device
  bounds = torch.arange(n_dev + 1, device=dev, dtype=torch.int64) * \
      local_rows
  edges = torch.searchsorted(uids_sorted, bounds)
  send = (edges[1:] - edges[:-1]).to(torch.int64)
  world.count_host_sync()
  raw = torch.stack(world.all_gather(send)).cpu().numpy()     # [W, W]
  offs = np.cumsum(raw, axis=0) - raw                         # sum s' < s
  if cap is None or cap >= n_loc * n_dev:
    cap = n_loc * n_dev
    sizes = raw
  else:
    sizes = np.clip(cap - offs, 0, raw)
  # my slots kept: within its owner's chunk, before the cut
  owner = torch.clamp(torch.bucketize(uids_sorted, bounds[1:],
                                      right=True), max=n_dev)
  start = edges[:-1]
  kept = torch.as_tensor(np.append(sizes[me, :], 0), device=dev)
  pos = torch.arange(n_loc, device=dev) - torch.cat(
      [start, start.new_zeros(1)])[owner]
  keep = (owner < n_dev) & (pos < kept[owner])
  return Route(keep=keep, sizes=sizes, raw=raw, me=me, cap=int(cap),
               n_loc=n_loc)


def _a2a(world: World, send: torch.Tensor, send_sizes, recv_sizes
         ) -> torch.Tensor:
  out = send.new_empty((int(sum(recv_sizes)),) + tuple(send.shape[1:]))
  row = send.element_size() * int(np.prod(send.shape[1:], dtype=np.int64))
  sent, recv = [row * int(n) for n in send_sizes], \
      [row * int(n) for n in recv_sizes]
  world.count_traffic('all_to_all', sum(sent), sum(recv))
  world.count_peers(sent, recv)
  dist.all_to_all_single(out, send.contiguous(), output_split_sizes=list(
      recv_sizes), input_split_sizes=list(send_sizes), group=world.group)
  return out


def send_to_owners(world: World, route: Route, values: torch.Tensor,
                   fill) -> torch.Tensor:
  """Requester -> owner leg (JAX :147-154): values [n_loc, ...] in the
  sorted-id order -> [cap, ...] at the owner, source by source; the slots
  past what arrived hold `fill`."""
  got = _a2a(world, values[route.keep], route.send_sizes, route.recv_sizes)
  out = values.new_full((route.cap,) + tuple(values.shape[1:]), fill)
  out[:got.shape[0]] = got
  return out


def return_to_requesters(world: World, route: Route,
                         values: torch.Tensor) -> torch.Tensor:
  """Owner -> requester leg (JAX :157-172): values [cap, ...] laid out as
  send_to_owners delivered them -> [n_loc, ...] in each requester's
  sorted-id order; the slots the cut dropped (and padding) stay zero."""
  n = int(sum(route.recv_sizes))
  got = _a2a(world, values[:n], route.recv_sizes, route.send_sizes)
  out = values.new_zeros((route.n_loc,) + tuple(values.shape[1:]))
  out[route.keep] = got
  return out
