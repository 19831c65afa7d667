"""Start a world of processes on this host and collect what each returns.

The port's own spawn, beside torchrun: `spawn('pkg.module:fn', args, n)`
starts n processes of `python -m easyrec_torch.parallel.launch`, each with
the torchrun environment of its rank (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR=localhost and a free MASTER_PORT). Each joins the world on
`device` (parallel/mesh.py join_world: NCCL on cuda:<rank>, gloo on the
CPU), calls fn(world, *args) and writes the pickled result; spawn returns
the results in rank order. Every process has the same time limit: one
that hangs (a rendezvous that never completes) or fails stops the others,
and spawn raises with the tail of each process's output.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Sequence


def free_port() -> int:
  s = socket.socket()
  s.bind(('localhost', 0))
  port = s.getsockname()[1]
  s.close()
  return port


def spawn(fn: str, args: Sequence[Any], world_size: int,
          device: str = 'cpu', timeout_s: float = 120.0,
          env: dict = None) -> List[Any]:
  """fn(world, *args) in each of `world_size` processes (fn is
  'module:function'); their results in rank order."""
  repo = os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  work = tempfile.mkdtemp(prefix='easyrec_world_')
  with open(os.path.join(work, 'args.pkl'), 'wb') as f:
    pickle.dump((fn, list(args), device), f)
  port = str(free_port())
  procs = []
  for rank in range(world_size):
    penv = dict(os.environ, **(env or {}))
    penv.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                LOCAL_RANK=str(rank), MASTER_ADDR='localhost',
                MASTER_PORT=port,
                PYTHONPATH=os.pathsep.join(
                    [repo] + [p for p in [penv.get('PYTHONPATH')] if p]))
    log = open(os.path.join(work, 'log-%d.txt' % rank), 'wb')
    procs.append((subprocess.Popen(
        [sys.executable, '-m', 'easyrec_torch.parallel.launch', work],
        env=penv, stdout=log, stderr=subprocess.STDOUT), log))
  deadline = time.time() + timeout_s
  failed = None
  while any(p.poll() is None for p, _ in procs):
    bad = [r for r, (p, _) in enumerate(procs)
           if p.poll() not in (None, 0)]
    if bad or time.time() > deadline:
      failed = ('rank %d exited with %d' % (bad[0], procs[bad[0]][0].poll())
                if bad else 'timed out after %.0f s' % timeout_s)
      break
    time.sleep(0.05)
  for p, log in procs:
    if p.poll() is None:
      p.kill()
    p.wait()
    log.close()
  if failed is None and any(p.returncode for p, _ in procs):
    failed = 'exit codes %s' % [p.returncode for p, _ in procs]
  if failed is not None:
    tails = []
    for rank in range(world_size):
      with open(os.path.join(work, 'log-%d.txt' % rank), 'rb') as f:
        tails.append('--- rank %d ---\n%s' % (
            rank, f.read()[-3000:].decode(errors='replace')))
    raise RuntimeError('world of %d (%s): %s\n%s'
                       % (world_size, fn, failed, '\n'.join(tails)))
  out = []
  for rank in range(world_size):
    with open(os.path.join(work, 'out-%d.pkl' % rank), 'rb') as f:
      out.append(pickle.load(f))
  return out


def _main(work: str) -> int:
  with open(os.path.join(work, 'args.pkl'), 'rb') as f:
    fn, args, device = pickle.load(f)
  from easyrec_torch.parallel import mesh
  world = mesh.join_world(device)
  mod, name = fn.split(':')
  result = getattr(importlib.import_module(mod), name)(world, *args)
  with open(os.path.join(work, 'out-%d.pkl' % world.rank), 'wb') as f:
    pickle.dump(result, f)
  world.barrier()
  mesh.leave_world()
  return 0


if __name__ == '__main__':
  sys.exit(_main(sys.argv[1]))
