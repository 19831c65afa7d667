"""Build native sources of the port into `build/easyrec_torch/` and load
them with ctypes.

Each library is named by a hash of its source, the files it includes by a
quoted path, and its compiler flags, so a changed source, header or flag
builds anew and a stale library is never loaded.
A build writes to a temporary name and renames it into place, so
concurrent processes (test workers) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import List, Optional

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), 'build',
                         'easyrec_torch')

# sm_90a: Hopper with its architecture-specific features; no fast-math, so
# sqrtf and division stay IEEE and kernels agree with their plain versions
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']
GXX_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']

_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def find_nvcc() -> str:
  for cand in (os.environ.get('CUDA_HOME', ''), '/usr/local/cuda'):
    path = os.path.join(cand, 'bin', 'nvcc') if cand else ''
    if path and os.path.exists(path):
      return path
  path = shutil.which('nvcc')
  if path is None:
    raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, '
                       '/usr/local/cuda/bin and PATH)')
  return path


def hash_sources(source: str, digest, seen=None) -> None:
  """Feed `source` and, once each, every file it includes by a quoted path
  that exists beside it (recursively) into `digest`."""
  seen = set() if seen is None else seen
  path = os.path.abspath(source)
  if path in seen:
    return
  seen.add(path)
  with open(path, 'rb') as f:
    text = f.read()
  digest.update(text)
  for name in _LOCAL_INCLUDE.findall(text):
    dep = os.path.join(os.path.dirname(path), name.decode())
    if os.path.exists(dep):
      hash_sources(dep, digest, seen)


class NativeBuild:
  """One source file compiled into one shared library."""

  def __init__(self, source: str, compiler: List[str], flags: List[str]):
    self.source = source
    self.compiler = compiler
    self.flags = list(flags)
    digest = hashlib.sha256()
    hash_sources(source, digest)
    digest.update(' '.join(self.flags).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    self.path = os.path.join(BUILD_DIR, 'lib%s-%s.so'
                             % (stem, digest.hexdigest()[:12]))
    self._proc: Optional[subprocess.Popen] = None
    self._tmp = None
    self.log = ''

  def start(self, verbose: bool = False) -> None:
    """Start the compiler unless the library exists (does not wait)."""
    if os.path.exists(self.path) and not verbose:
      return
    os.makedirs(BUILD_DIR, exist_ok=True)
    self._tmp = '%s.tmp%d' % (self.path, os.getpid())
    cmd = list(self.compiler) + self.flags + \
        (['-Xptxas', '-v'] if verbose else []) + \
        [self.source, '-o', self._tmp]
    self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)

  def wait(self) -> str:
    """Wait for a started build; raise with the compiler output on error."""
    if self._proc is None:
      return self.log
    out, _ = self._proc.communicate()
    rc = self._proc.returncode
    self._proc = None
    self.log = out
    if rc != 0:
      raise RuntimeError('building %s failed (exit %d):\n%s'
                         % (self.source, rc, out))
    os.replace(self._tmp, self.path)
    return out

  def load(self) -> ctypes.CDLL:
    self.start()
    self.wait()
    return ctypes.CDLL(self.path)
