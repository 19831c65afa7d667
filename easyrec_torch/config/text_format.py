"""Protobuf text format to and from plain Python `Message` objects.

The reader covers what pipeline configs use: scalars, strings with escapes
(adjacent literals concatenate), enum identifiers, nested messages in `{}`
or `<>`, repeated fields written once per value or as `[a, b]` lists, `#`
comments, and `,`/`;` separators. Field types, defaults and repetition come
from `schema.py`; fields that the schema does not list are parsed and
dropped. The value of an `unported` field is kept as an `Opaque`: its
tokens as written, and a canonical form to compare by.

The writer, `to_text`, is the counterpart of protobuf's
`text_format.MessageToString(..., as_utf8=True)` for what the reader
holds: set fields only (the set member of a oneof), enums as bare
identifiers, strings escaped as protobuf escapes them (non-ASCII kept as
UTF-8), repeated fields one entry per value, floats in the shortest form
that reads back as the same float32, and `Opaque` values token for token.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import re
from typing import Any, Dict, List, Tuple

import numpy as np

from easyrec_torch.config import schema


class Message:
  """One message of a known schema type.

  Reading an unset singular field gives its proto default (an empty
  message for message fields); reading a repeated field gives its list.
  """

  __slots__ = ('_type', '_values')

  def __init__(self, type_name: str):
    object.__setattr__(self, '_type', type_name)
    object.__setattr__(self, '_values', {})

  @property
  def type_name(self) -> str:
    return self._type

  def __getattr__(self, name: str):
    if name.startswith('_'):
      raise AttributeError(name)
    spec = schema.field(self._type, name)
    if spec.repeated:
      return self._values.setdefault(name, [])
    if name in self._values:
      return self._values[name]
    if spec.message_type:
      return Message(spec.message_type)
    return spec.default

  def __setattr__(self, name: str, value):
    spec = schema.field(self._type, name)
    if spec.repeated:
      value = [_coerce(spec, v) for v in value]
    else:
      value = _coerce(spec, value)
      if spec.oneof:
        for other in schema.MESSAGES[self._type]:
          if other.oneof == spec.oneof:
            self._values.pop(other.name, None)
    self._values[name] = value

  def HasField(self, name: str) -> bool:  # noqa: N802 (protobuf spelling)
    spec = schema.field(self._type, name)
    if spec.repeated:
      raise ValueError('HasField on repeated field %s' % name)
    return name in self._values

  def WhichOneof(self, oneof: str):  # noqa: N802 (protobuf spelling)
    for spec in schema.MESSAGES[self._type]:
      if spec.oneof == oneof and spec.name in self._values:
        return spec.name
    return None

  def ClearField(self, name: str) -> None:  # noqa: N802
    schema.field(self._type, name)
    self._values.pop(name, None)

  def copy(self) -> 'Message':
    return copy.deepcopy(self)

  def __deepcopy__(self, memo) -> 'Message':
    new = Message(self._type)
    object.__setattr__(new, '_values', copy.deepcopy(self._values, memo))
    return new

  def __repr__(self):
    return '%s(%s)' % (self._type, ', '.join(
        '%s=%r' % kv for kv in self._values.items()))


@dataclasses.dataclass(frozen=True)
class Opaque:
  """The value of an `unported` field as the reader found it: `tokens`,
  the source tokens of a scalar or of a `{...}` message (comments
  dropped), written back by to_text; `canon`, a canonical form (strings
  unescaped, lists flattened, messages as dicts of lists), which equality
  compares, so two spellings of one value are equal."""
  tokens: Tuple[str, ...] = dataclasses.field(compare=False)
  canon: Any


def _coerce(spec: schema.FieldSpec, value):
  kind = spec.kind
  if kind == 'string':
    if not isinstance(value, str):
      raise ValueError('field %s wants a string, got %r'
                       % (spec.name, value))
    return value
  if kind == 'bool':
    if isinstance(value, str):
      if value in ('true', 'True', 't', '1'):
        return True
      if value in ('false', 'False', 'f', '0'):
        return False
      raise ValueError('field %s wants a bool, got %r' % (spec.name, value))
    return bool(value)
  if kind == 'int':
    if isinstance(value, float) and value != int(value):
      raise ValueError('field %s wants an integer, got %r'
                       % (spec.name, value))
    return int(value)
  if kind == 'float':
    # proto float: the generated classes store float32
    return float(np.float32(float(value)))
  if kind == 'double':
    return float(value)
  if spec.enum_type:
    values = schema.ENUMS[spec.enum_type]
    if value not in values:
      raise ValueError('%r is not a value of enum %s (field %s)'
                       % (value, spec.enum_type, spec.name))
    return value
  if spec.message_type:
    if not isinstance(value, Message) or \
        value.type_name != spec.message_type:
      raise ValueError('field %s wants a %s message'
                       % (spec.name, spec.message_type))
    return value
  return value          # unported: kept as parsed


# --------------------------------------------------------------- tokenizer

_TOKEN = re.compile(r"""
  (?P<ws>\s+|\#[^\n]*)
 |(?P<string>"(?:[^"\\\n]|\\.)*"|'(?:[^'\\\n]|\\.)*')
 |(?P<number>[-+]?(?:0[xX][0-9a-fA-F]+
                   |(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?[fF]?
                   |(?:inf|infinity|nan)\b))
 |(?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
 |(?P<punct>[{}<>\[\]:,;])
""", re.VERBOSE)


class ParseError(ValueError):
  pass


def _tokenize(text: str) -> List[tuple]:
  toks, pos = [], 0
  while pos < len(text):
    m = _TOKEN.match(text, pos)
    if m is None:
      line = text.count('\n', 0, pos) + 1
      raise ParseError('line %d: unexpected %r' % (line, text[pos:pos + 20]))
    kind = m.lastgroup
    if kind != 'ws':
      toks.append((kind, m.group(kind), text.count('\n', 0, pos) + 1))
    pos = m.end()
  return toks


_SIMPLE_ESCAPES = {'n': 10, 't': 9, 'r': 13, 'a': 7, 'b': 8, 'f': 12,
                   'v': 11, '\\': 92, "'": 39, '"': 34, '?': 63}


def _unescape(body: str) -> str:
  out = bytearray()
  i, n = 0, len(body)
  while i < n:
    c = body[i]
    if c != '\\':
      out += c.encode('utf-8')
      i += 1
      continue
    e = body[i + 1]
    if e in _SIMPLE_ESCAPES:
      out.append(_SIMPLE_ESCAPES[e])
      i += 2
    elif e in '01234567':
      j = i + 1
      while j < min(i + 4, n) and body[j] in '01234567':
        j += 1
      out.append(int(body[i + 1:j], 8) & 0xFF)
      i = j
    elif e in 'xX':
      j = i + 2
      while j < min(i + 4, n) and body[j] in '0123456789abcdefABCDEF':
        j += 1
      out.append(int(body[i + 2:j], 16))
      i = j
    elif e in 'uU':
      width = 4 if e == 'u' else 8
      out += chr(int(body[i + 2:i + 2 + width], 16)).encode('utf-8')
      i += 2 + width
    else:
      raise ParseError('unknown escape \\%s' % e)
  return out.decode('utf-8')


def _number(text: str):
  t = text.lower()
  sign = -1.0 if t.startswith('-') else 1.0
  body = t.lstrip('+-')
  if body in ('inf', 'infinity'):
    return sign * float('inf')
  if body == 'nan':
    return float('nan')
  if body.startswith('0x'):
    return int(sign) * int(body, 16)
  if body.endswith('f'):
    body = body[:-1]
  if re.fullmatch(r'\d+', body):
    return int(sign) * int(body)
  return sign * float(body)


# ------------------------------------------------------------------ parser

class _Parser:

  def __init__(self, text: str):
    self.toks = _tokenize(text)
    self.i = 0

  def peek(self):
    return self.toks[self.i] if self.i < len(self.toks) else (None, None, -1)

  def take(self, value=None):
    tok = self.peek()
    if tok[0] is None:
      raise ParseError('unexpected end of input')
    if value is not None and tok[1] != value:
      raise ParseError('line %d: expected %r, got %r'
                       % (tok[2], value, tok[1]))
    self.i += 1
    return tok

  def message(self, msg: Message, close=None) -> Message:
    while True:
      kind, val, line = self.peek()
      if kind is None:
        if close is not None:
          raise ParseError('unterminated message %s' % msg.type_name)
        return msg
      if val == close:
        self.take()
        return msg
      if kind != 'ident':
        raise ParseError('line %d: expected a field name, got %r'
                         % (line, val))
      self.take()
      self.field(msg, val, line)
      if self.peek()[1] in (',', ';'):
        self.take()

  def field(self, msg: Message, name: str, line: int):
    spec = schema.field(msg.type_name, name) \
        if schema.has_field(msg.type_name, name) else None
    if self.peek()[1] == ':':
      self.take()
    if self.peek()[1] == '[':
      self.take()
      values = []
      while self.peek()[1] != ']':
        values.append(self.value_of(spec, line))
        if self.peek()[1] == ',':
          self.take()
      self.take(']')
    else:
      values = [self.value_of(spec, line)]
    if spec is None:
      return                      # not read by the port: dropped
    try:
      if spec.repeated:
        store = msg._values.setdefault(name, [])
        store.extend(_coerce(spec, v) for v in values)
      else:
        if len(values) != 1:
          raise ParseError('field %s is not repeated' % name)
        if spec.kind == 'unported':
          msg._values[name] = values[0]
        else:
          setattr(msg, name, values[0])
    except ValueError as e:
      raise ParseError('line %d: %s' % (line, e)) from None

  def value_of(self, spec, line):
    """One value of a field of `spec`: an Opaque for an unported field."""
    if spec is None or spec.kind != 'unported':
      return self.value(spec, line)
    start = self.i
    canon = self.value(None, line)
    return Opaque(tuple(t[1] for t in self.toks[start:self.i]), canon)

  def value(self, spec, line):
    """With no spec (inside an Opaque), strings and identifiers come back
    tagged, ('str', s) and ('ident', name), so they compare apart."""
    kind, val, _ = self.peek()
    if val in ('{', '<'):
      self.take()
      close = '}' if val == '{' else '>'
      if spec is not None and spec.message_type:
        return self.message(Message(spec.message_type), close)
      return self.opaque_message(close)
    if kind == 'string':
      parts = []
      while self.peek()[0] == 'string':
        parts.append(_unescape(self.take()[1][1:-1]))
      return ''.join(parts) if spec is not None else ('str', ''.join(parts))
    if kind == 'number':
      self.take()
      return _number(val)
    if kind == 'ident':
      self.take()
      return val if spec is not None else ('ident', val)
    raise ParseError('line %d: unexpected %r' % (line, val))

  def opaque_message(self, close) -> Dict[str, Any]:
    """A message of a type the port does not read: fields -> values."""
    out: Dict[str, Any] = {}
    while self.peek()[1] != close:
      kind, name, line = self.take()
      if kind != 'ident':
        raise ParseError('line %d: expected a field name, got %r'
                         % (line, name))
      if self.peek()[1] == ':':
        self.take()
      if self.peek()[1] == '[':
        self.take()
        vals = []
        while self.peek()[1] != ']':
          vals.append(self.value(None, line))
          if self.peek()[1] == ',':
            self.take()
        self.take(']')
        out.setdefault(name, []).extend(vals)
      else:
        out.setdefault(name, []).append(self.value(None, line))
      if self.peek()[1] in (',', ';'):
        self.take()
    self.take(close)
    return out


def parse(text: str, type_name: str = 'EasyRecConfig') -> Message:
  """Parse text-format `text` into a Message of `type_name`."""
  return _Parser(text).message(Message(type_name))


# ------------------------------------------------------------------ writer

# protobuf's text_encoding._str_escapes (CEscape with as_utf8 on a str):
# control characters as 3-digit octal but \t \n \r, quotes and the
# backslash escaped, everything else (non-ASCII included) as it is
_ESCAPES = {i: '\\%03o' % i for i in list(range(32)) + [127]}
_ESCAPES.update({9: '\\t', 10: '\\n', 13: '\\r', 34: '\\"', 39: "\\'",
                 92: '\\\\'})


def _escape(text: str) -> str:
  return text.translate(_ESCAPES)


_FLOAT32_MAX = float(np.finfo(np.float32).max)


def _float32_text(value: float) -> str:
  """The shortest text that reads back as the same float32, as protobuf
  writes a float field: numpy's shortest float32 form, checked by reading
  it back through a double as protobuf's reader does (which takes a
  double past the largest float32 to infinity); the double's own text
  (exact for a float32) where that check fails."""
  if math.isnan(value):
    return 'nan'
  if math.isinf(value):
    return 'inf' if value > 0 else '-inf'
  f32 = np.float32(value)
  text = str(f32)
  back = float(text)
  if np.float32(back) != f32 or abs(back) > _FLOAT32_MAX:
    text = repr(float(f32))
  return text


def _scalar_text(spec: schema.FieldSpec, value) -> str:
  kind = spec.kind
  if kind == 'string':
    return '"%s"' % _escape(value)
  if kind == 'bool':
    return 'true' if value else 'false'
  if kind == 'int':
    return str(int(value))
  if kind == 'float':
    return _float32_text(float(value))
  if kind == 'double':
    value = float(value)
    if math.isnan(value):
      return 'nan'
    if math.isinf(value):
      return 'inf' if value > 0 else '-inf'
    return repr(value)
  if spec.enum_type:
    return str(value)
  raise ValueError('field %s of kind %s is not a scalar' % (spec.name, kind))


def _write(msg: Message, indent: int, out: List[str]) -> None:
  pad = '  ' * indent
  for spec in schema.MESSAGES[msg.type_name]:
    if spec.name not in msg._values:
      continue
    value = msg._values[spec.name]
    for v in (value if spec.repeated else [value]):
      if isinstance(v, Opaque):
        sep = ' ' if v.tokens and v.tokens[0] in ('{', '<') else ': '
        out.append('%s%s%s%s\n' % (pad, spec.name, sep, ' '.join(v.tokens)))
      elif isinstance(v, Message):
        out.append('%s%s {\n' % (pad, spec.name))
        _write(v, indent + 1, out)
        out.append('%s}\n' % pad)
      else:
        out.append('%s%s: %s\n' % (pad, spec.name, _scalar_text(spec, v)))


def to_text(msg: Message) -> str:
  """`msg` in protobuf text format (the counterpart of MessageToString
  with as_utf8=True): the fields it holds, in schema order."""
  out: List[str] = []
  _write(msg, 0, out)
  return ''.join(out)


def canonical(msg: Message) -> Dict[str, Any]:
  """A plain nested dict of what `msg` holds (empty repeated fields left
  out, Opaque values by their canonical form), for comparing messages."""
  out = {}
  for spec in schema.MESSAGES[msg.type_name]:
    if spec.name not in msg._values:
      continue
    value = msg._values[spec.name]
    if spec.repeated and not value:
      continue
    items = [canonical(v) if isinstance(v, Message) else
             (v.canon if isinstance(v, Opaque) else v)
             for v in (value if spec.repeated else [value])]
    out[spec.name] = items if spec.repeated else items[0]
  return out
