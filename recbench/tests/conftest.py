"""The benchmark's tests run with few torch threads: the driver runs tests
in several processes at once. `root`: a root holding the benchmark's
cells and the held ones (small.bench_root)."""

import pytest
import torch

from recbench.tests.small import bench_root


@pytest.fixture(autouse=True)
def _few_threads():
  threads = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope='session')
def root(tmp_path_factory):
  return bench_root(str(tmp_path_factory.mktemp('bench')))
