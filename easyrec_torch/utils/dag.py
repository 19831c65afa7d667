"""Tiny DAG with topological sort for the backbone block graph.

The port's own copy of easyrec_tpu/utils/dag.py (whole): the backbone
orders its blocks by it, so both packages run them in one order.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Set


class DAG:
  """Directed acyclic graph over string node names."""

  def __init__(self):
    self._edges: Dict[str, Set[str]] = {}

  def add_node(self, name: str) -> None:
    self._edges.setdefault(name, set())

  def add_edge(self, src: str, dst: str) -> None:
    """src must be computed before dst."""
    self.add_node(src)
    self.add_node(dst)
    self._edges[dst].add(src)

  def nodes(self) -> List[str]:
    return list(self._edges)

  def predecessors(self, name: str) -> Set[str]:
    return set(self._edges.get(name, ()))

  def topological_sort(self) -> List[str]:
    """Kahn's algorithm; deterministic (insertion order breaks ties)."""
    indeg = {n: len(deps) for n, deps in self._edges.items()}
    consumers: Dict[str, List[str]] = {n: [] for n in self._edges}
    for node, deps in self._edges.items():
      for d in deps:
        consumers[d].append(node)
    ready = [n for n in self._edges if indeg[n] == 0]
    order: List[str] = []
    while ready:
      n = ready.pop(0)
      order.append(n)
      for c in consumers[n]:
        indeg[c] -= 1
        if indeg[c] == 0:
          ready.append(c)
    if len(order) != len(self._edges):
      cyc = sorted(set(self._edges) - set(order))
      raise ValueError('cycle in block DAG involving %s' % cyc)
    return order

  def leaf_nodes(self, candidates: Iterable[str] = None) -> List[str]:
    """Nodes no other node depends on (in insertion order)."""
    consumed: Set[str] = set()
    for deps in self._edges.values():
      consumed |= deps
    names = candidates if candidates is not None else self._edges
    return [n for n in names if n not in consumed]
