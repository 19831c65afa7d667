"""Device ms a step of the DCN-v2 cross layers: the operations launched
inside the port's span easyrec.cross (layers/interaction.py CrossNetV2)
and the backward of what they recorded, read from the traced stretch by
trace.span_reader."""

from recbench.trace import span_reader

read = span_reader('easyrec.cross')
