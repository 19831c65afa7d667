"""Parameter bridge: uniform read access over a typed config message or a
google.protobuf.Struct (the free-form `st_params`), the two ways a
backbone KerasLayer carries its parameters.

Counterpart of easyrec_tpu/layers/param.py (whole), over the port's
text_format.Message: a Struct is the message of that name in the port's
schema, its map `fields` a list of key/value entries.
"""

from __future__ import annotations

from typing import Any

from easyrec_torch.config import schema


def _struct_value(value):
  """A Value message -> a python object (integral numbers as int)."""
  kind = value.WhichOneof('kind')
  if kind == 'number_value':
    n = value.number_value
    return int(n) if float(n).is_integer() else n
  if kind == 'string_value':
    return value.string_value
  if kind == 'bool_value':
    return value.bool_value
  if kind == 'list_value':
    return [_struct_value(v) for v in value.list_value.values]
  if kind == 'struct_value':
    return struct_to_dict(value.struct_value)
  return None


def struct_to_dict(struct) -> dict:
  """A Struct message -> {key: python value}; a later entry of a key wins,
  as a protobuf map keeps the last."""
  return {e.key: _struct_value(e.value) for e in struct.fields}


class Parameter:
  """Read-only view over a config message ('pb' mode) or a Struct."""

  def __init__(self, payload: Any, is_struct: bool):
    self._payload = payload
    self._is_struct = is_struct
    if is_struct and isinstance(payload, dict):
      self._dict = dict(payload)
    elif is_struct and payload is not None:
      self._dict = struct_to_dict(payload)
    else:
      self._dict = None

  @classmethod
  def from_keras_layer(cls, keras_layer) -> 'Parameter':
    """From a KerasLayer message: its typed oneof or st_params."""
    which = keras_layer.WhichOneof('params')
    if which is None:
      return cls({}, True)
    return cls(getattr(keras_layer, which), which == 'st_params')

  @property
  def is_struct(self) -> bool:
    return self._is_struct

  def _fields(self):
    return {f.name for f in schema.MESSAGES[self._payload.type_name]}

  def has(self, name: str) -> bool:
    if self._is_struct:
      return name in self._dict
    return name in self._fields()

  def get(self, name: str, default=None):
    if self._is_struct:
      return self._dict.get(name, default)
    if name not in self._fields():
      return default
    return getattr(self._payload, name)

  def get_list(self, name: str, default=()):
    val = self.get(name, None)
    if val is None:
      return list(default)
    return list(val)

  def get_int(self, name: str, default: int = 0) -> int:
    return int(self.get(name, default) or default)

  def get_float(self, name: str, default: float = 0.0) -> float:
    v = self.get(name, None)
    return float(v) if v is not None else default

  def get_bool(self, name: str, default: bool = False) -> bool:
    v = self.get(name, None)
    return bool(v) if v is not None else default

  def get_str(self, name: str, default: str = '') -> str:
    v = self.get(name, None)
    return str(v) if v else default

  def get_pb(self, name: str):
    """Typed sub-message (its default when unset, as the JAX Parameter
    gives it for any field of the message); a Parameter over a nested
    dict in Struct mode; None when absent."""
    if self._is_struct:
      sub = self._dict.get(name)
      return Parameter(sub, True) if isinstance(sub, dict) else None
    if self.has(name):
      return getattr(self._payload, name)
    return None

  def __getattr__(self, name: str):
    if name.startswith('_'):
      raise AttributeError(name)
    return self.get(name)
