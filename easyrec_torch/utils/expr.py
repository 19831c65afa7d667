"""Safe expression evaluation for ExprFeature.

A copy of easyrec_tpu/utils/expr.py: a whitelisted AST interpreter over
numpy arrays (arithmetic, comparisons, the math functions, conditional
expressions), with the string functions of ops/text_ops.py over the raw
string columns. Results keep numpy's dtypes; ExprTransform casts them to
f32.
"""

from __future__ import annotations

import ast
import operator
from typing import Dict

import numpy as np

_BINOPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod,
    ast.Pow: operator.pow,
}

_UNARYOPS = {
    ast.USub: operator.neg,
    ast.UAdd: operator.pos,
}

_CMPOPS = {
    ast.Gt: operator.gt,
    ast.GtE: operator.ge,
    ast.Lt: operator.lt,
    ast.LtE: operator.le,
    ast.Eq: operator.eq,
    ast.NotEq: operator.ne,
}

_FUNCS = {
    'log': np.log,
    'log1p': np.log1p,
    'exp': np.exp,
    'abs': np.abs,
    'sqrt': np.sqrt,
    'min': np.minimum,
    'max': np.maximum,
    'sign': np.sign,
    'floor': np.floor,
    'ceil': np.ceil,
    'sigmoid': lambda x: 1.0 / (1.0 + np.exp(-x)),
}


# String feature functions (host C++ ops, ops/text_ops.py), over raw string
# columns, e.g.
#   expression: "query_common_ratio(query, title)"
def _string_funcs():
  from easyrec_torch.ops import text_ops
  return {
      'edit_distance': lambda a, b: text_ops.edit_distance(a, b)
      .astype(np.float32),
      'query_common_ratio': text_ops.query_common_ratio,
      'title_common_ratio': text_ops.title_common_ratio,
      'is_contain': text_ops.is_contain,
      'common_word': text_ops.common_word,
      'mapped_dot_product': text_ops.mapped_dot_product,
      'text_len': lambda a: np.asarray(
          [len(str(v)) for v in a], np.float32),
  }


def evaluate(expression: str, variables: Dict[str, np.ndarray],
             raw_variables: Dict[str, np.ndarray] = None):
  """Evaluate an arithmetic expression over named numpy arrays.

  String functions (edit_distance, query_common_ratio, ...) receive the
  RAW string columns from raw_variables."""
  tree = ast.parse(expression, mode='eval')
  return _eval(tree.body, variables, raw_variables or {})


def _eval(node, variables, raw_variables=None):
  if isinstance(node, ast.BinOp):
    op = _BINOPS.get(type(node.op))
    if op is None:
      raise ValueError('unsupported operator %s' % type(node.op).__name__)
    return op(_eval(node.left, variables, raw_variables),
              _eval(node.right, variables, raw_variables))
  if isinstance(node, ast.UnaryOp):
    op = _UNARYOPS.get(type(node.op))
    if op is None:
      raise ValueError('unsupported operator %s' % type(node.op).__name__)
    return op(_eval(node.operand, variables, raw_variables))
  if isinstance(node, ast.Compare):
    if len(node.ops) != 1:
      raise ValueError('chained comparisons unsupported')
    op = _CMPOPS.get(type(node.ops[0]))
    if op is None:
      raise ValueError('unsupported comparison')
    return op(_eval(node.left, variables, raw_variables),
              _eval(node.comparators[0],
                    variables, raw_variables)).astype(np.float32)
  if isinstance(node, ast.Call):
    if not isinstance(node.func, ast.Name):
      raise ValueError('unsupported function call')
    name = node.func.id
    str_funcs = _string_funcs()
    if name in str_funcs:
      args = []
      for a in node.args:
        if isinstance(a, ast.Name):
          if raw_variables and a.id in raw_variables:
            args.append(raw_variables[a.id])
          else:
            raise KeyError('unknown string variable %r' % a.id)
        elif isinstance(a, ast.Constant):
          args.append(a.value)
        else:
          raise ValueError('string functions take columns/constants only')
      return str_funcs[name](*args)
    if name not in _FUNCS:
      raise ValueError('unsupported function %r' % name)
    args = [_eval(a, variables, raw_variables) for a in node.args]
    return _FUNCS[name](*args)
  if isinstance(node, ast.Name):
    if node.id not in variables:
      raise KeyError('unknown variable %r in expression' % node.id)
    return variables[node.id]
  if isinstance(node, ast.Constant):
    if isinstance(node.value, (int, float)):
      return node.value
    raise ValueError('unsupported constant %r' % node.value)
  if isinstance(node, ast.IfExp):
    cond = _eval(node.test, variables, raw_variables)
    return np.where(cond, _eval(node.body, variables, raw_variables),
                    _eval(node.orelse, variables, raw_variables))
  raise ValueError('unsupported expression node %s' % type(node).__name__)
