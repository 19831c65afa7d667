"""Device ms a step of the sparse update's sort: the operations launched
inside the port's span easyrec.sparse_update.sort (ops/packed_table.py),
read from the traced stretch by trace.span_reader."""

from recbench.trace import span_reader

read = span_reader('easyrec.sparse_update.sort')
