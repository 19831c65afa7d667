"""A CLI's exit that no lingering thread can hold up.

Counterpart of easyrec_tpu/utils/proc.py. A library may leave a non-daemon
thread running when a CLI's work is done, and the interpreter's shutdown
then waits on it. `exit_after(code)` flushes stdio, gives such threads a
short grace window, logs the names of any still alive, and leaves with
os._exit, past the interpreter's joining of threads. The CLIs call it last
of all, after their results are on disk.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time

_GRACE_S = 5.0


def exit_after(code: int) -> None:
  """Flush, give non-daemon threads _GRACE_S seconds, then os._exit."""
  sys.stdout.flush()
  sys.stderr.flush()
  deadline = time.time() + _GRACE_S
  for t in threading.enumerate():
    if t is threading.current_thread() or t.daemon:
      continue
    t.join(timeout=max(0.0, deadline - time.time()))
  stragglers = [t.name for t in threading.enumerate()
                if t is not threading.current_thread() and not t.daemon and
                t.is_alive()]
  if stragglers:
    logging.warning(
        'exiting with non-daemon threads still alive (hard os._exit to '
        'avoid a shutdown-join hang): %s', stragglers)
  sys.stdout.flush()
  sys.stderr.flush()
  os._exit(code)
