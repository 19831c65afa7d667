"""The packed-v2 sparse-embedding design, measured on the card.

Counterpart of benchmarks/bench_packed_v2.py. Design under test:
  - weights and the Adam moments m and v are each stored SEPARATELY in the
    packed geometry [G*8, W] with W = lcm(dim, 128): logical row r lives
    at physical row (r // group_rows) * 8 + (r % group_rows) // pack,
    lanes [lane*dim, (lane+1)*dim) with lane = r % pack;
  - the forward gather takes physical rows, masks the row's lane and folds
    it to [N, dim] with a static 0/1 matrix product;
  - the sparse update dedups ids at the group level, gathers [8, W]
    groups, runs Adam on them with touched-row masking, and writes each
    group back with kernel K4 (ops/group_dma.py `group_push`), one push
    per array, in place.

Run (on the card unless --device cpu):

    python -m easyrec_torch.benchmarks.bench_packed_v2

Parity is checked at small scale (`check_parity`); timing at the flagship
bench shapes (26M x 16 deep and 26M x 1 wide, batch 4096 x 26 ids)
against the plain layout: dedup_sum, then lazy Adam over separate
[rows, dim] arrays (SparseAdam.update_rows).
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from easyrec_torch.device import resolve_device
from easyrec_torch.ops.group_dma import check_ids, group_push
from easyrec_torch.optim.sparse import SparseAdam, dedup_sum

_LANE = 64          # ids a row of the TPU's SMEM id pages (chunk rounding)


# ---------------------------------------------------------------- geometry

class PackMeta:

  def __init__(self, rows: int, dim: int):
    self.rows = rows
    self.dim = dim
    self.pack = 128 // math.gcd(dim, 128)
    self.width = self.pack * dim                   # lcm(dim, 128)
    self.group_rows = 8 * self.pack
    # one sacrificial group at the end for dedup padding
    self.groups = rows // self.group_rows + 2
    self.rows_padded = self.groups * self.group_rows
    self.scratch = self.rows_padded - self.group_rows
    self.scratch_gid = self.groups - 1


def pack_table_host(table: np.ndarray, meta: PackMeta) -> np.ndarray:
  """[R, dim] -> packed [G*8, width] (host-side reference)."""
  r, d = table.shape
  full = np.zeros((meta.rows_padded, d), table.dtype)
  full[:r] = table
  v = full.reshape(meta.groups, 8, meta.pack, d)
  return np.ascontiguousarray(v.reshape(meta.groups * 8, meta.width))


def phys_rows(ids, meta: PackMeta):
  g = ids // meta.group_rows
  within = ids % meta.group_rows
  return g * 8 + within // meta.pack, within % meta.pack


# ---------------------------------------------------------------- forward

def fwd_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  return table.index_select(0, ids)


def _lane_gather_matrix(meta: PackMeta, device=None) -> torch.Tensor:
  t = np.zeros((meta.width, meta.dim), np.float32)
  for j in range(meta.width):
    t[j, j % meta.dim] = 1.0
  return torch.from_numpy(t).to(device)


def fwd_packed(packed: torch.Tensor, ids: torch.Tensor, meta: PackMeta,
               tmat: torch.Tensor) -> torch.Tensor:
  """[N, dim] rows from the packed table. The 0/1 product has one nonzero
  term an output, so it is exact in f32 (TF32 would round it: callers on
  the card keep torch.backends.cuda.matmul.allow_tf32 False, its
  default)."""
  prow, lane = phys_rows(ids, meta)
  r = packed.index_select(0, prow)                         # [N, W]
  col_lane = torch.arange(meta.width, device=packed.device) // meta.dim
  mask = (col_lane[None, :] == lane[:, None]).to(r.dtype)
  return torch.matmul(r * mask, tmat.to(r.dtype))          # [N, dim]


# ---------------------------------------------------------------- update

def group_prep(uids: torch.Tensor, ug: torch.Tensor, meta: PackMeta):
  """Sorted unique logical ids + grads [n, dim] -> unique group ids [n],
  dense per-physical-row grads [n, 8, W] and the touched-row mask
  [n, 8, W] (same padding contract as dedup_sum: tail slots name the
  scratch group with zero grads). The segment sum is index_add_: every
  output cell receives at most one nonzero term, so it is exact in any
  order."""
  n = uids.shape[0]
  dev = uids.device
  gids = uids // meta.group_rows
  within = uids % meta.group_rows
  sub = within // meta.pack
  lane = within % meta.pack
  first = torch.ones(n, dtype=torch.bool, device=dev)
  first[1:] = gids[1:] != gids[:-1]
  gseg = torch.cumsum(first, 0) - 1
  ugids = torch.full((n,), meta.scratch_gid, dtype=gids.dtype,
                     device=dev).scatter_(0, gseg, gids)
  tiled = ug.to(torch.float32).repeat(1, meta.pack)          # [n, W]
  col = torch.arange(meta.width, device=dev) // meta.dim
  expanded = torch.where(col[None, :] == lane[:, None], tiled,
                         torch.zeros((), device=dev))
  flat = gseg * 8 + sub
  gg = torch.zeros((n * 8, meta.width), device=dev).index_add_(
      0, flat, expanded)
  # touched-row (lane-block) mask through the static block-diagonal
  # product, as the JAX script computes it
  block = torch.from_numpy(np.kron(
      np.eye(meta.pack, dtype=np.float32),
      np.ones((meta.dim, meta.dim), np.float32))).to(dev)
  touched = ((gg != 0.0).to(torch.float32) @ block) > 0.0
  return ugids, gg.reshape(n, 8, meta.width), \
      touched.reshape(n, 8, meta.width)


def take_groups(packed: torch.Tensor, ugids: torch.Tensor,
                meta: PackMeta) -> torch.Tensor:
  """[n] group ids -> [n, 8, W] groups of the packed [G*8, W] table."""
  return packed.view(meta.groups, 8, meta.width).index_select(0, ugids)


def pad_to_chunk(table3: torch.Tensor, ugids: torch.Tensor,
                 new_rows: torch.Tensor, scratch_gid: int):
  """(ugids, new_rows) padded to a multiple of the TPU write-back's chunk
  (at most 512 groups, about 6 MB of VMEM) with slots naming the scratch
  group and carrying its CURRENT bytes, so duplicate writes are
  identical. Hopper needs no chunk; the padding keeps the port's
  write-back slot for slot the same as the JAX prototypes'."""
  n, width = ugids.shape[0], table3.shape[-1]
  chunk = min(512, max(_LANE, (6 << 20) // (8 * width * 4)
                       // _LANE * _LANE))
  pad = (-n) % chunk
  if pad:
    ugids = torch.cat([ugids, torch.full((pad,), scratch_gid,
                                         dtype=ugids.dtype,
                                         device=ugids.device)])
    scratch_rows = table3[scratch_gid][None].expand(
        (pad,) + tuple(table3.shape[1:]))
    new_rows = torch.cat([new_rows, scratch_rows.to(new_rows.dtype)])
  return ugids, new_rows.contiguous()


def push_groups(packed: torch.Tensor, ugids: torch.Tensor,
                new_rows: torch.Tensor, meta: PackMeta) -> torch.Tensor:
  """Scattered write-back of [n, 8, W] groups into the packed [G*8, W]
  table, in place, through K4; the counterpart of push_groups_pallas.
  ugids must be unique except for scratch-group slots carrying the
  scratch group's current bytes."""
  packed3 = packed.view(meta.groups, 8, meta.width)
  group_push(packed3, *pad_to_chunk(packed3, ugids, new_rows,
                                    meta.scratch_gid))
  return packed


def adam_update_packed(w, m, v, ids, grads, meta: PackMeta, lr, step):
  """Full packed-v2 Adam: dedup -> group prep -> gather -> math -> push.
  Updates w, m and v in place and returns them."""
  uids, ug = dedup_sum(ids, grads, meta.scratch)
  ugids, gg, touched = group_prep(uids, ug, meta)
  gw = take_groups(w, ugids, meta).to(torch.float32)
  gm = take_groups(m, ugids, meta).to(torch.float32)
  gv = take_groups(v, ugids, meta).to(torch.float32)
  b1, b2, eps = 0.9, 0.999, 1e-8
  t = (step + 1).to(torch.float32)
  nm = b1 * gm + (1 - b1) * gg
  nv = b2 * gv + (1 - b2) * torch.square(gg)
  mhat = nm / (1 - torch.pow(b1, t))
  vhat = nv / (1 - torch.pow(b2, t))
  nw = gw - lr * mhat / (torch.sqrt(vhat) + eps)
  nw = torch.where(touched, nw, gw)
  nm = torch.where(touched, nm, gm)
  nv = torch.where(touched, nv, gv)
  push_groups(w, ugids, nw.to(w.dtype), meta)
  push_groups(m, ugids, nm.to(m.dtype), meta)
  push_groups(v, ugids, nv.to(v.dtype), meta)
  return w, m, v


def adam_update_plain(w, m, v, ids, grads, scratch, lr, step):
  """Plain layout: dedup_sum, then lazy Adam on [rows, dim] arrays, in
  place."""
  uids, ug = dedup_sum(ids, grads, scratch)
  nw, st = SparseAdam().update_rows(w, {'m': m, 'v': v}, uids, ug, lr, step)
  return nw, st['m'], st['v']


# ---------------------------------------------------------------- harness

def sync(x) -> None:
  """Wait for the device that holds the first tensor of `x`."""
  while isinstance(x, (tuple, list)):
    x = x[0]
  if x.is_cuda:
    torch.cuda.synchronize(x.device)


def time_threaded(fn, state, args, iters):
  """fn(*state, *args) -> new state tuple; seconds a call, final state."""
  for _ in range(3):
    state = fn(*state, *args)
  sync(state)
  t0 = time.perf_counter()
  for _ in range(iters):
    state = fn(*state, *args)
  sync(state)
  return (time.perf_counter() - t0) / iters, state


def time_simple(fn, *args, iters=20):
  for _ in range(3):
    out = fn(*args)
  sync(out)
  t0 = time.perf_counter()
  for _ in range(iters):
    out = fn(*args)
  sync(out)
  return (time.perf_counter() - t0) / iters


def check_parity(dim, device='cpu') -> bool:
  """Small-scale numerical parity: packed vs plain forward + Adam, on
  `device` (K4 on the card). Prints one line; True when the forward
  agrees within 1e-6 and Adam within 1e-5, the JAX script's limits."""
  dev = torch.device(device)
  rows, n_ids = 4096, 777
  meta = PackMeta(rows, dim)
  rng = np.random.RandomState(0)
  w_np = rng.randn(rows, dim).astype(np.float32)
  ids_np = rng.randint(0, rows, n_ids).astype(np.int32)
  g_np = rng.randn(n_ids, dim).astype(np.float32)
  # make some duplicate ids and some zero grads
  ids_np[:50] = ids_np[50:100]
  plain = torch.from_numpy(w_np).to(dev)
  packed = torch.from_numpy(pack_table_host(w_np, meta)).to(dev)
  tmat = _lane_gather_matrix(meta, dev)
  ids = torch.from_numpy(ids_np).to(dev)
  grads = torch.from_numpy(g_np).to(dev)
  f_err = float((fwd_plain(plain, ids) -
                 fwd_packed(packed, ids, meta, tmat)).abs().max())
  lr = torch.tensor(0.1, device=dev)
  step = torch.tensor(3, dtype=torch.int32, device=dev)
  pw, pm, pv = adam_update_plain(plain, torch.zeros_like(plain),
                                 torch.zeros_like(plain), ids, grads,
                                 rows - 1, lr, step)
  qw, qm, qv = adam_update_packed(
      packed, torch.zeros_like(packed), torch.zeros_like(packed), ids,
      grads, meta, lr, step)
  check_ids(dev)
  all_ids = torch.arange(rows, dtype=torch.int32, device=dev)
  u_err = max(
      float((fwd_plain(px, all_ids) -
             fwd_packed(qx, all_ids, meta, tmat)).abs().max())
      for px, qx in ((pw, qw), (pm, qm), (pv, qv)))
  ok = f_err < 1e-6 and u_err < 1e-5
  print(f'  parity dim={dim}: fwd {f_err:.2e}  adam(all rows+slots) '
        f'{u_err:.2e}  (device={dev.type}) correct={ok}', flush=True)
  return ok


def main(argv=None):
  """Parity at dims 16, 1 and 8, then the deep and wide timing phases.
  Returns {'correct': bool, 'parity': [...], 'deep': {...}, 'wide':
  {...}} with times in ms."""
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--device', default=None,
                 help="'cuda' (default) or 'cpu'")
  p.add_argument('--rows', type=int, default=26_000_000)
  p.add_argument('--ids', type=int, default=4096 * 26)
  p.add_argument('--iters', type=int, default=10)
  args = p.parse_args(argv)
  dev = resolve_device(args.device)
  rows, n_ids = args.rows, args.ids
  print('parity checks (small scale):', flush=True)
  parity = [check_parity(d, dev) for d in (16, 1, 8)]
  out = {'correct': all(parity), 'parity': parity}

  for dim, tag in ((16, 'deep'), (1, 'wide')):
    meta = PackMeta(rows, dim)
    print(f'--- {tag}: [{rows}, {dim}] pack={meta.pack} W={meta.width} '
          f'group_rows={meta.group_rows} groups={meta.groups}', flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, rows, (n_ids,), generator=gen, device=dev,
                        dtype=torch.int32)
    grads = torch.randn((n_ids, dim), generator=gen, device=dev)
    lr = torch.tensor(1e-3, device=dev)
    step = torch.tensor(10, dtype=torch.int32, device=dev)
    tmat = _lane_gather_matrix(meta, dev)

    # --- plain layout phase ------------------------------------------
    plain = torch.randn((rows, dim), generator=gen, device=dev) * 0.01
    t_f0 = time_simple(fwd_plain, plain, ids)
    print(f'  fwd plain take      : {t_f0*1e3:8.2f} ms', flush=True)
    m0, v0 = torch.zeros_like(plain), torch.zeros_like(plain)
    t_u0, st = time_threaded(
        lambda w, m, v, i, g: adam_update_plain(w, m, v, i, g, rows - 1, lr,
                                                step),
        (plain, m0, v0), (ids, grads), iters=args.iters)
    print(f'  upd plain (index ops): {t_u0*1e3:8.2f} ms', flush=True)
    del plain, m0, v0, st

    # --- packed layout phase -----------------------------------------
    packed = torch.randn((meta.groups * 8, meta.width), generator=gen,
                         device=dev) * 0.01
    t_f1 = time_simple(lambda p_, i: fwd_packed(p_, i, meta, tmat),
                       packed, ids)
    print(f'  fwd packed select   : {t_f1*1e3:8.2f} ms', flush=True)
    m_p, v_p = torch.zeros_like(packed), torch.zeros_like(packed)
    t_u1, st = time_threaded(
        lambda w, m, v, i, g: adam_update_packed(w, m, v, i, g, meta, lr,
                                                 step),
        (packed, m_p, v_p), (ids, grads), iters=args.iters)
    print(f'  upd packed (push)   : {t_u1*1e3:8.2f} ms', flush=True)
    check_ids(dev)
    del packed, m_p, v_p, st
    out[tag] = {'fwd_plain_ms': t_f0 * 1e3, 'upd_plain_ms': t_u0 * 1e3,
                'fwd_packed_ms': t_f1 * 1e3, 'upd_packed_ms': t_u1 * 1e3}
  return out


if __name__ == '__main__':
  main()
