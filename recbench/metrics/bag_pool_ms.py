"""Device ms a step of the bags' pooling: the operations launched inside
the port's span easyrec.embed.pool (ops/embedding.py combine: each
feature's pulled rows reduced by its combiner) and the backward of what
they recorded, read from the traced stretch by trace.span_reader."""

from recbench.trace import span_reader

read = span_reader('easyrec.embed.pool')
