"""Name -> class registries used for models, inputs and layers.

Serves the role of the reference's registry metaclass
(easy_rec/python/utils/load_class.py:203-233) with a plain decorator.
"""

from __future__ import annotations

from typing import Callable, Dict, Type


class Registry:
  """A case-insensitive name->object registry."""

  def __init__(self, kind: str):
    self._kind = kind
    self._entries: Dict[str, object] = {}

  def register(self, name: str = None) -> Callable:
    def deco(obj):
      key = (name or obj.__name__).lower()
      if key in self._entries and self._entries[key] is not obj:
        raise KeyError('%s %r already registered' % (self._kind, key))
      self._entries[key] = obj
      return obj
    return deco

  def get(self, name: str):
    key = name.lower()
    if key not in self._entries:
      raise KeyError('unknown %s %r; known: %s' %
                     (self._kind, name, sorted(self._entries)))
    return self._entries[key]

  def __contains__(self, name: str) -> bool:
    return name.lower() in self._entries

  def keys(self):
    return sorted(self._entries)


MODELS = Registry('model')
INPUTS = Registry('input')


def load_by_path(path: str):
  """Load a function/class by dotted path, e.g. 'numpy.log1p'."""
  import importlib
  if not path:
    return None
  # accept tf-style names from reference configs
  tf_compat = {
      'tf.math.log1p': 'numpy.log1p',
      'tf.math.log': 'numpy.log',
      'tf.math.exp': 'numpy.exp',
      'tf.math.sigmoid': 'scipy.special.expit',
      'tf.math.abs': 'numpy.abs',
      'tf.math.sqrt': 'numpy.sqrt',
      'log1p': 'numpy.log1p',
  }
  path = tf_compat.get(path, path)
  module_path, _, attr = path.rpartition('.')
  if not module_path:
    raise ValueError('cannot load %r: not a dotted path' % path)
  mod = importlib.import_module(module_path)
  return getattr(mod, attr)
