"""Protobuf's JSON form of pipeline configs, to and from `Message` objects.

The counterpart of `google.protobuf.json_format` for what the port's schema
holds (config/schema.py):

  message_to_json / message_to_dict  what `json_format.MessageToJson` /
      `MessageToDict` write: the set fields in field-number order (the
      schema's order), under lowerCamelCase names (protobuf's json_name)
      or, with preserving_proto_field_name, the proto names; enums by
      name, int64 fields as strings, floats as the shortest decimal that
      reads back as the same float32, NaN and the infinities as "NaN",
      "Infinity" and "-Infinity";
  parse / parse_dict  what `json_format.Parse(..., ignore_unknown_fields=
      True)` reads: either name form, numbers or their strings, enums by
      name; fields the schema does not list are dropped, as the text
      reader drops them.

A Struct's keys come in the config's order (protobuf writes a map in the
order of its hash table). The value of an `unported` field (text_format.Opaque) has no JSON form
here: both directions raise NotImplementedError naming the field.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, Union

import numpy as np

from easyrec_torch.config import schema
from easyrec_torch.config.text_format import Message, Opaque, _coerce


def json_name(name: str) -> str:
  """protobuf's default json_name: each '_' dropped and the letter after
  it upper-cased (`l2_regularization` -> `l2Regularization`)."""
  out, upper = [], False
  for ch in name:
    if ch == '_':
      upper = True
    elif upper:
      out.append(ch.upper())
      upper = False
    else:
      out.append(ch)
  return ''.join(out)


def _shortest_float32(value: float) -> float:
  """protobuf's type_checkers.ToShortestFloat: the fewest significant
  digits (6 to 9) that round back to the same float32."""
  f32 = np.float32(value)
  precision = 6
  rounded = float('{0:.{1}g}'.format(value, precision))
  while np.float32(rounded) != f32:
    precision += 1
    rounded = float('{0:.{1}g}'.format(value, precision))
  return rounded


def _value_to_json(spec: schema.FieldSpec, value, preserve: bool):
  if isinstance(value, Opaque):
    raise NotImplementedError('config field %s is not ported and has no '
                              'JSON form here' % spec.name)
  if isinstance(value, Message):
    return message_to_dict(value, preserve)
  kind = spec.kind
  if kind in ('float', 'double'):
    value = float(value)
    if math.isinf(value):
      return '-Infinity' if value < 0 else 'Infinity'
    if math.isnan(value):
      return 'NaN'
    return _shortest_float32(value) if kind == 'float' else value
  if kind == 'int64':
    return str(int(value))
  if kind == 'int':
    return int(value)
  if kind == 'bool':
    return bool(value)
  return str(value)                   # string, enum name


def _well_known_to_json(msg: Message, preserve: bool):
  """google.protobuf's Struct, Value and ListValue in their JSON forms: an
  object, any JSON value (an unset Value is null), an array."""
  if msg.type_name == 'Struct':
    return {e.key: _well_known_to_json(e.value, preserve)
            for e in msg.fields}
  if msg.type_name == 'ListValue':
    return [_well_known_to_json(v, preserve) for v in msg.values]
  which = msg.WhichOneof('kind')
  if which in (None, 'null_value'):
    return None
  if which in ('struct_value', 'list_value'):
    return _well_known_to_json(getattr(msg, which), preserve)
  if which == 'number_value' and not math.isfinite(msg.number_value):
    raise ValueError('Value.number_value %r has no JSON form'
                     % msg.number_value)
  return getattr(msg, which)


_WELL_KNOWN = ('Struct', 'Value', 'ListValue')


def message_to_dict(msg: Message,
                    preserving_proto_field_name: bool = False
                    ) -> Dict[str, Any]:
  """`msg` as protobuf's MessageToDict writes it."""
  if msg.type_name in _WELL_KNOWN:
    return _well_known_to_json(msg, preserving_proto_field_name)
  out: Dict[str, Any] = {}
  for spec in schema.MESSAGES[msg.type_name]:
    if spec.name not in msg._values:
      continue
    value = msg._values[spec.name]
    if spec.repeated and not value:
      continue
    key = spec.name if preserving_proto_field_name else json_name(spec.name)
    if spec.repeated:
      out[key] = [_value_to_json(spec, v, preserving_proto_field_name)
                  for v in value]
    else:
      out[key] = _value_to_json(spec, value, preserving_proto_field_name)
  return out


def message_to_json(msg: Message, preserving_proto_field_name: bool = False,
                    indent: int = 2) -> str:
  """`msg` as protobuf's MessageToJson writes it (json.dumps of the dict,
  ASCII only, keys in field order)."""
  return json.dumps(message_to_dict(msg, preserving_proto_field_name),
                    indent=indent, sort_keys=False, ensure_ascii=True)


def _value_from_json(spec: schema.FieldSpec, value, where: str):
  kind = spec.kind
  if kind == 'unported':
    raise NotImplementedError('config field %s is not ported and is not '
                              'read from JSON here' % where)
  if spec.message_type:
    if spec.message_type not in _WELL_KNOWN and not isinstance(value, dict):
      raise ValueError('%s wants a JSON object, got %r' % (where, value))
    return parse_dict(value, Message(spec.message_type), where)
  if kind in ('float', 'double'):
    if isinstance(value, str):
      special = {'NaN': float('nan'), 'Infinity': float('inf'),
                 '-Infinity': float('-inf')}
      return special[value] if value in special else float(value)
    if isinstance(value, bool) or not isinstance(value, (int, float)):
      raise ValueError('%s wants a number, got %r' % (where, value))
    return float(value)
  if kind in ('int', 'int64'):
    if isinstance(value, bool):
      raise ValueError('%s wants an integer, got %r' % (where, value))
    if isinstance(value, float):
      if not value.is_integer():
        raise ValueError('%s wants an integer, got %r' % (where, value))
      return int(value)
    return int(value)
  if kind == 'bool':
    if not isinstance(value, bool):
      raise ValueError('%s wants true or false, got %r' % (where, value))
    return value
  if spec.enum_type and not isinstance(value, str):
    raise ValueError('%s: enum %s by number is not read here, only by name'
                     % (where, spec.enum_type))
  if not isinstance(value, str):
    raise ValueError('%s wants a string, got %r' % (where, value))
  return value


def parse_dict(js: Dict[str, Any], message: Union[Message, str],
               path: str = '') -> Message:
  """Merge the JSON object `js` into `message` (a Message, or the name of
  a schema message to make); unknown names are dropped."""
  if isinstance(message, str):
    message = Message(message)
  if message.type_name in _WELL_KNOWN:
    return _well_known_from_json(js, message, path)
  by_name = {}
  for spec in schema.MESSAGES[message.type_name]:
    by_name[spec.name] = spec
    by_name.setdefault(json_name(spec.name), spec)
  for key, value in js.items():
    spec = by_name.get(key)
    if spec is None or value is None:
      continue
    where = '%s.%s' % (path, spec.name) if path else spec.name
    if spec.repeated:
      if not isinstance(value, list):
        raise ValueError('%s wants a JSON array, got %r' % (where, value))
      getattr(message, spec.name).extend(
          _coerce(spec, _value_from_json(spec, v, where)) for v in value)
    else:
      setattr(message, spec.name, _value_from_json(spec, value, where))
  return message


def _well_known_from_json(js, message: Message, path: str) -> Message:
  if message.type_name == 'Struct':
    if not isinstance(js, dict):
      raise ValueError('%s: a Struct wants a JSON object' % path)
    message.fields = []
    for key, value in js.items():
      entry = Message('StructFieldsEntry')
      entry.key = key
      entry.value = _well_known_from_json(value, Message('Value'), path)
      message.fields.append(entry)
    return message
  if message.type_name == 'ListValue':
    if not isinstance(js, list):
      raise ValueError('%s: a ListValue wants a JSON array' % path)
    message.values = [_well_known_from_json(v, Message('Value'), path)
                      for v in js]
    return message
  if isinstance(js, dict):
    message.struct_value = _well_known_from_json(js, Message('Struct'), path)
  elif isinstance(js, list):
    message.list_value = _well_known_from_json(js, Message('ListValue'),
                                               path)
  elif js is None:
    message.null_value = 'NULL_VALUE'
  elif isinstance(js, bool):
    message.bool_value = js
  elif isinstance(js, str):
    message.string_value = js
  else:
    message.number_value = js
  return message


def parse(text: str, type_name: str = 'EasyRecConfig') -> Message:
  """A Message of `type_name` from protobuf JSON `text`."""
  return parse_dict(json.loads(text), Message(type_name))
