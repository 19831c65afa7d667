"""Backbone DSL: declarative block-DAG composite models.

Counterpart of easyrec_tpu/models/backbone.py (whole): the config lambdas
and their `tf` shim (eval_lambda, :24-78), _apply_slice / _flatten /
_merge (:81-106), Package (:109-427: the block DAG, its inputs, the layer
kinds lambda / keras_layer / recurrent / repeat, raw_input,
embedding_layer and the enhanced input layer _input_layer_block) and
BackboneModule (:430-451, the packages, `main` and top_mlp).

flax creates a block's modules inside Package's compact call, when data
first flows through them, so their widths follow from whatever the
lambdas, slices and list merges make of the input. torch wants a module's
widths when it is made. So every module here is made at its first
encounter, by `_Scope.child`, during one build pass that the models run
in their constructor (models/backbone_model.py build): a forward in eval
mode, without gradients, on a two-row synthetic batch of the real feature
widths. The pass makes the modules in the order flax creates them (the
DAG's topological order), under the names flax gives them; after it no
module is made, and a forward that would make one raises.

Names, as the flax tree has them: `main` and `pkg_<name>` under
`backbone` (a package is made by BackboneModule and shared by every block
that calls it), `<block>_l<i>` for a block's i-th layer, `<block>_l<i>_r<j>`
for a repeat's j-th copy (a recurrent layer reuses one), `<block>_bn`,
`<block>_ln` and `<block>_variational_dropout` of an input layer,
`<block>_embed` of an embedding layer, flax's `<Class>_<n>` for the
modules the registry's adapters make in the package's own scope
(layers/keras_registry.py), then `top_mlp`.

The losses the JAX layers sow into flax's `losses` collection
(AuxiliaryLoss, VariationalDropout) are appended to the backbone's `sink`
as (flax path, value); the model returns them, in the collection's order,
as `aux_losses`, and the trainer adds them to the loss.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from easyrec_torch.layers.attention import LayerNorm
from easyrec_torch.layers.dnn import MLP, BatchNorm, Dropout, Stochastic
from easyrec_torch.layers.keras_registry import Embed, build_keras_layer
from easyrec_torch.layers.variational_dropout import VariationalDropout
from easyrec_torch.models.seq_input import build_flat_part
from easyrec_torch.utils.dag import DAG


def _dims(axis):
  return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def _reduce(fn):
  """tf.reduce_*(x, axis=None, keepdims=False) onto a torch reduction."""
  def reduce(x, axis=None, keepdims=False):
    if axis is None:
      out = fn(x)
      return out.reshape([1] * x.ndim) if keepdims else out
    return fn(x, dim=_dims(axis), keepdim=keepdims)
  return reduce


def _take(x, ids, axis=0):
  ids = torch.as_tensor(ids, device=x.device)
  axis = axis % x.ndim
  out = torch.index_select(x, axis, ids.reshape(-1).to(torch.int64))
  return out.reshape(x.shape[:axis] + ids.shape + x.shape[axis + 1:])


class _NNShim:
  """jax.nn / tf.nn names onto torch."""
  relu = staticmethod(F.relu)
  relu6 = staticmethod(F.relu6)
  sigmoid = staticmethod(torch.sigmoid)
  tanh = staticmethod(torch.tanh)
  softmax = staticmethod(lambda x, axis=-1: torch.softmax(x, dim=axis))
  log_softmax = staticmethod(
      lambda x, axis=-1: torch.log_softmax(x, dim=axis))
  gelu = staticmethod(lambda x, approximate=True: F.gelu(
      x, approximate='tanh' if approximate else 'none'))
  silu = staticmethod(F.silu)
  swish = staticmethod(F.silu)
  elu = staticmethod(F.elu)
  softplus = staticmethod(F.softplus)
  leaky_relu = staticmethod(
      lambda x, negative_slope=0.01: F.leaky_relu(x, negative_slope))


class _JnpShim:
  """The jnp names the lambdas may use, onto torch (axis= read as
  dim=)."""
  concatenate = staticmethod(
      lambda values, axis=0: torch.cat(list(values), dim=axis))
  stack = staticmethod(lambda values, axis=0: torch.stack(list(values),
                                                          dim=axis))
  expand_dims = staticmethod(lambda x, axis: torch.unsqueeze(x, axis))
  squeeze = staticmethod(lambda x, axis=None: torch.squeeze(x)
                         if axis is None else torch.squeeze(x, _dims(axis)))
  reshape = staticmethod(lambda x, shape: torch.reshape(x, tuple(shape)))
  transpose = staticmethod(
      lambda x, axes=None: x.permute(*(axes if axes is not None else
                                       reversed(range(x.ndim)))))
  sum = staticmethod(_reduce(torch.sum))
  mean = staticmethod(_reduce(torch.mean))
  max = staticmethod(_reduce(torch.amax))
  min = staticmethod(_reduce(torch.amin))
  multiply = staticmethod(torch.mul)
  add = staticmethod(torch.add)
  subtract = staticmethod(torch.sub)
  divide = staticmethod(torch.div)
  maximum = staticmethod(torch.maximum)
  minimum = staticmethod(torch.minimum)
  exp = staticmethod(torch.exp)
  log = staticmethod(torch.log)
  abs = staticmethod(torch.abs)
  square = staticmethod(torch.square)
  sqrt = staticmethod(torch.sqrt)
  tanh = staticmethod(torch.tanh)
  ones_like = staticmethod(torch.ones_like)
  zeros_like = staticmethod(torch.zeros_like)
  take = staticmethod(_take)
  split = staticmethod(lambda x, sections, axis=0: list(
      torch.tensor_split(x, sections, dim=axis)))


class _TFShim:
  """The tf.* namespace the reference's lambdas use ('lambda x:
  tf.concat(x, axis=1)'), onto torch, as the JAX _TFShim maps it onto
  jnp."""
  concat = staticmethod(lambda values, axis=-1: torch.cat(list(values),
                                                          dim=axis))
  stack = staticmethod(lambda values, axis=0: torch.stack(list(values),
                                                          dim=axis))
  expand_dims = _JnpShim.expand_dims
  squeeze = _JnpShim.squeeze
  reshape = _JnpShim.reshape
  transpose = _JnpShim.transpose
  reduce_mean = staticmethod(_reduce(torch.mean))
  reduce_sum = staticmethod(_reduce(torch.sum))
  reduce_max = staticmethod(_reduce(torch.amax))
  sigmoid = staticmethod(torch.sigmoid)
  tanh = staticmethod(torch.tanh)
  exp = staticmethod(torch.exp)
  log = staticmethod(torch.log)
  abs = staticmethod(torch.abs)
  square = staticmethod(torch.square)
  sqrt = staticmethod(torch.sqrt)
  add_n = staticmethod(lambda xs: sum(xs))
  multiply = staticmethod(torch.mul)
  unstack = staticmethod(lambda x, axis=0: list(torch.unbind(x, dim=axis)))
  divide = staticmethod(torch.div)
  split = staticmethod(lambda x, num, axis=-1: list(
      torch.tensor_split(x, num, dim=axis)))
  gather = staticmethod(_take)
  norm = staticmethod(lambda x, ord=None, axis=None, keepdims=False:
                      torch.linalg.norm(x, ord, dim=_dims(axis),
                                        keepdim=keepdims))
  ones_like = staticmethod(torch.ones_like)
  zeros_like = staticmethod(torch.zeros_like)
  stop_gradient = staticmethod(lambda x: x.detach())
  nn = _NNShim
  math = _JnpShim


class _JaxShim:
  nn = _NNShim

  class lax:  # noqa: N801 (jax.lax)
    stop_gradient = staticmethod(lambda x: x.detach())


# the JAX package's names: jnp, jax, np, tf and concatenate
_LAMBDA_ENV = {
    'jnp': _JnpShim, 'jax': _JaxShim, 'np': np, 'tf': _TFShim,
    'concatenate': _JnpShim.concatenate,
}


def eval_lambda(expression: str):
  """Evaluate a config lambda string in a restricted namespace (the JAX
  package's builtins)."""
  # the env is the lambda's GLOBALS, so its body resolves names at call
  # time (locals are not captured by lambdas created in eval)
  env = dict(_LAMBDA_ENV)
  env['__builtins__'] = {'len': len, 'sum': sum, 'min': min, 'max': max,
                         'range': range, 'abs': abs, 'list': list,
                         'tuple': tuple, 'zip': zip, 'enumerate': enumerate}
  return eval(expression, env)  # noqa: S307


def _apply_slice(value, slice_str: str):
  if not slice_str:
    return value
  return eval('__x__' + slice_str.strip(),  # noqa: S307
              {'__builtins__': {}, '__x__': value})


def _flatten(values: List[Any]) -> List[Any]:
  out = []
  for v in values:
    if isinstance(v, (list, tuple)):
      out.extend(v)
    else:
      out.append(v)
  return out


def _merge(values: List[Any], axis: int):
  if len(values) == 1:
    return values[0]
  # list-valued inputs merge into one flat LIST, not a concat: blocks like
  # Gate wrap tensors via input_fn "lambda x: [x]" and rely on it
  if any(isinstance(v, (list, tuple)) for v in values):
    return _flatten(values)
  return torch.cat(values, dim=axis)


class BuildState:
  """What the modules of one model's backbone share: the init generator
  and whether the build pass runs (only then may a module be made), and
  the sink of the losses its layers record in a forward."""

  def __init__(self, generator=None):
    self.generator = generator
    self.building = False
    self.sink: List = []

  @property
  def kw(self) -> Dict[str, Any]:
    """The arguments a module is made with: it is made on the CPU, and
    the model moved to its device after the build pass."""
    return dict(generator=self.generator)


def lazy_child(owner: torch.nn.Module, state: BuildState, name: str, make):
  """owner's submodule `name`, made by make() (in owner's mode) when the
  build pass meets it first."""
  mod = owner._modules.get(name)
  if mod is None:
    if not state.building:
      raise RuntimeError('backbone module %r was not made by the build '
                         'pass' % name)
    mod = make()
    mod.train(owner.training)
    owner.add_module(name, mod)
  return mod


class _Scope(Stochastic):
  """A flax scope the registry's layers make their modules in: child()
  by name, autoname() for flax's `<Class>_<n>` (its counter restarts at
  every call, as a compact module's does)."""

  def __init__(self, state: BuildState, path: str):
    super().__init__()
    self._state = state
    self.path = path
    self._cursor: Dict[str, int] = {}

  @property
  def kw(self) -> Dict[str, Any]:
    return self._state.kw

  @property
  def sink(self) -> List:
    return self._state.sink

  @property
  def building(self) -> bool:
    return self._state.building

  def child(self, name: str, make) -> torch.nn.Module:
    return lazy_child(self, self._state, name, make)

  def autoname(self, cls_name: str) -> str:
    n = self._cursor.get(cls_name, 0)
    self._cursor[cls_name] = n + 1
    return '%s_%d' % (cls_name, n)


class Package(_Scope):
  """One (sub-)DAG of blocks. The top-level backbone is itself a Package
  with the packages available for reference; calling one Package several
  times shares its modules."""

  def __init__(self, ctx, pkg_config, packages, state: BuildState,
               path: str):
    super().__init__(state, path)
    self.ctx = ctx
    self.pkg_config = pkg_config
    # the packages are BackboneModule's modules, not this one's
    self._packages = dict(packages or {})

  def _package_outer_deps(self, pkg_name: str, outer_blocks,
                          seen=None) -> set:
    """Outer-block names a package (transitively) reads."""
    seen = seen if seen is not None else set()
    if pkg_name in seen or pkg_name not in self._packages:
      return set()
    seen.add(pkg_name)
    cfg = self._packages[pkg_name].pkg_config
    inner = {b.name for b in cfg.blocks}
    deps = set()
    for b in cfg.blocks:
      for bi in b.inputs:
        which = bi.WhichOneof('name')
        if which == 'block_name' and bi.block_name not in inner and \
                bi.block_name in outer_blocks:
          deps.add(bi.block_name)
        elif which == 'package_name':
          deps |= self._package_outer_deps(bi.package_name, outer_blocks,
                                           seen)
          if bi.package_input:
            if bi.package_input in outer_blocks:
              deps.add(bi.package_input)
            else:
              deps |= self._package_outer_deps(bi.package_input,
                                               outer_blocks, seen)
    return deps

  def forward(self, batch, pulled, package_input=None, outer_values=None):
    self._cursor = {}
    blocks = {b.name: b for b in self.pkg_config.blocks}

    dag = DAG()
    for b in self.pkg_config.blocks:
      dag.add_node(b.name)
      for bi in b.inputs:
        which = bi.WhichOneof('name')
        if which == 'block_name' and bi.block_name in blocks:
          dag.add_edge(bi.block_name, b.name)
        elif which == 'feature_group_name' and \
                bi.feature_group_name in blocks and \
                bi.feature_group_name != b.name:
          # a block may be named after a feature group it wraps
          dag.add_edge(bi.feature_group_name, b.name)
        elif which == 'package_name':
          if bi.package_input in blocks:
            dag.add_edge(bi.package_input, b.name)
          else:
            for dep in self._package_outer_deps(bi.package_input, blocks):
              dag.add_edge(dep, b.name)
          for dep in self._package_outer_deps(bi.package_name, blocks):
            dag.add_edge(dep, b.name)

    values: Dict[str, Any] = {}
    group_cache: Dict[str, Any] = {}

    def feature_group_value(gname: str):
      if gname not in group_cache:
        group_cache[gname] = self._group_concat(batch, pulled, gname)
      return group_cache[gname]

    def resolve_input(bi, block_name: str):
      which = bi.WhichOneof('name')
      if which == 'feature_group_name':
        gname = bi.feature_group_name
        if gname in blocks and gname != block_name:
          v = values[gname]
        else:
          v = feature_group_value(gname)
      elif which == 'block_name':
        if bi.block_name in values:
          v = values[bi.block_name]
        elif outer_values is not None and bi.block_name in outer_values:
          # an inner-package block may read an outer backbone block
          v = outer_values[bi.block_name]
        else:
          v = values[bi.block_name]          # KeyError with block name
      elif which == 'package_name':
        pkg = self._packages.get(bi.package_name)
        if pkg is None:
          raise KeyError('unknown package %r' % bi.package_name)
        ov = dict(outer_values or {})
        ov.update(values)
        pkg_in = None
        if bi.package_input:
          if bi.package_input in values:
            pkg_in = values[bi.package_input]
          elif bi.package_input in self._packages:
            # package_input naming another package: run it, feed its
            # output
            pkg_in = self._packages[bi.package_input](
                batch, pulled, outer_values=ov)
          else:
            pkg_in = feature_group_value(bi.package_input)
          if bi.package_input_fn:
            pkg_in = eval_lambda(bi.package_input_fn)(pkg_in)
        v = pkg(batch, pulled, package_input=pkg_in, outer_values=ov)
      elif which == 'use_package_input':
        if package_input is None:
          raise ValueError('block %r uses package input but none was '
                           'passed' % block_name)
        v = package_input
      else:
        raise ValueError('block input needs a name (block %r)' % block_name)
      if bi.ignore_input:
        return None
      if bi.input_slice:
        v = _apply_slice(v, bi.input_slice)
      if bi.input_fn:
        v = eval_lambda(bi.input_fn)(v)
      return v

    for bname in dag.topological_sort():
      values[bname] = self._run_block(blocks[bname], resolve_input, batch,
                                      pulled)

    out_blocks = list(self.pkg_config.output_blocks)
    if out_blocks:
      outs = [values[n] for n in out_blocks]
      return outs if len(outs) > 1 else outs[0]
    concat = list(self.pkg_config.concat_blocks) or \
        dag.leaf_nodes([b.name for b in self.pkg_config.blocks])
    if len(concat) == 1 and isinstance(values[concat[0]], (list, tuple)):
      # a single list-valued output (SeqAugment's [seq, mask, ...]) keeps
      # its structure
      return list(values[concat[0]])
    outs = _flatten([values[n] for n in concat])
    outs = [o if o.ndim == 2 else o.reshape(o.shape[0], -1) for o in outs]
    return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]

  # -- feature groups ------------------------------------------------------

  def _flat_names(self, names) -> None:
    """In the build pass, the sequence combiners of `names` (flax makes
    them in this scope, seqcomb_<f>_*)."""
    if self.building:
      build_flat_part(self, self.ctx, names, **self.kw)

  def _group_concat(self, batch, pulled, gname: str):
    names = self.ctx.group_features(gname)
    self._flat_names(names)
    return self.ctx.input_layer.group_concat(pulled, batch, names,
                                             owner=self)

  # -- block evaluation ----------------------------------------------------

  def _run_block(self, block, resolve_input, batch, pulled):
    which_layer = block.WhichOneof('layer')
    if which_layer == 'input_layer':
      gname = block.inputs[0].feature_group_name \
          if block.inputs else block.name
      return self._input_layer_block(block.name, gname, block.input_layer,
                                     batch, pulled)
    if which_layer == 'raw_input':
      gname = block.inputs[0].feature_group_name \
          if block.inputs else block.name
      names = self.ctx.group_features(gname)
      return torch.cat(
          [self.ctx.input_layer.dense_feature(batch, f) for f in names
           if self.ctx.specs[f].kind == 'dense'], dim=-1)

    inputs = [resolve_input(bi, block.name) for bi in block.inputs]
    inputs = [v for v in inputs if v is not None]
    if block.merge_inputs_into_list:
      x = _flatten(inputs)
    elif len(inputs) == 1:
      x = inputs[0]
    elif inputs:
      x = _merge(inputs, int(block.input_concat_axis))
    else:
      x = None
    if block.extra_input_fn:
      x = eval_lambda(block.extra_input_fn)(x)

    if which_layer == 'embedding_layer':
      cfg = block.embedding_layer
      table = self.child('%s_embed' % block.name, lambda: Embed(
          int(cfg.vocab_size) or 10000, int(cfg.embedding_dim), **self.kw))
      emb = table(x)
      if cfg.concat and emb.ndim > 2:
        emb = emb.reshape(emb.shape[0], -1)
      return emb

    layer_protos = list(block.layers)
    if which_layer is not None:
      layer_protos = layer_protos + [(which_layer,
                                      getattr(block, which_layer))]
    for idx, lp in enumerate(layer_protos):
      if isinstance(lp, tuple):
        kind, payload = lp
      else:
        kind = lp.WhichOneof('layer')
        payload = getattr(lp, kind)
      x = self._run_layer(kind, payload, x, '%s_l%d' % (block.name, idx))
    return x

  def _run_layer(self, kind: str, payload, x, name: str):
    if kind == 'lambda':
      return eval_lambda(payload.expression)(x)
    if kind == 'keras_layer':
      return build_keras_layer(payload, name, self)(x)
    if kind == 'recurrent':
      layer = build_keras_layer(payload.keras_layer, name, self)
      fixed = None
      state = x
      if payload.HasField('fixed_input_index') and \
              isinstance(x, (list, tuple)):
        fi = int(payload.fixed_input_index)
        fixed = x[fi]
        rest = [v for i, v in enumerate(x) if i != fi]
        state = rest[0] if len(rest) == 1 else rest
      for _ in range(int(payload.num_steps)):
        state = layer([fixed, state] if fixed is not None else state)
      return state
    if kind == 'repeat':
      outs = []
      for i in range(int(payload.num_repeat)):
        xi = x
        if payload.input_slice:
          # the reference's quirk: every 'i' of the slice is replaced
          xi = _apply_slice(xi, payload.input_slice.replace('i', str(i)))
        if payload.input_fn:
          xi = eval_lambda(payload.input_fn)(xi, i) \
              if 'lambda x, i' in payload.input_fn or \
              'lambda x,i' in payload.input_fn else \
              eval_lambda(payload.input_fn)(xi)
        outs.append(build_keras_layer(payload.keras_layer,
                                      '%s_r%d' % (name, i), self)(xi))
      if payload.HasField('output_concat_axis'):
        return torch.cat(outs, dim=int(payload.output_concat_axis))
      return outs
    raise ValueError('unknown layer kind %r' % kind)

  # -- enhanced input layer ------------------------------------------------

  def _input_layer_block(self, block_name: str, gname: str, cfg, batch,
                         pulled):
    """EnhancedInputLayer: a feature group -> its (normalised) 2-D, 3-D
    or per-feature-list outputs (JAX _input_layer_block, :363-427)."""
    il = self.ctx.input_layer
    names = self.ctx.group_features(gname)
    seq_names = [f for f in names if self.ctx.specs[f].kind == 'sequence']
    flat_names = [f for f in names if f not in seq_names]

    if cfg.output_seq_and_normal_feature:
      # [seq [B, L, D], mask [B, L], normal [B, D]]
      seqs, masks = [], None
      for f in seq_names:
        s, m = il.sequence_embedding(pulled, batch, f)
        seqs.append(s)
        masks = m if masks is None else torch.maximum(masks, m)
      seq = torch.cat(seqs, dim=-1) if len(seqs) > 1 else seqs[0]
      out = [seq, masks]
      if flat_names:
        self._flat_names(flat_names)
        out.append(il.group_concat(pulled, batch, flat_names, owner=self))
      return out

    def _norm(t):
      if cfg.do_batch_norm:
        t = self.child('%s_bn' % block_name,
                       lambda: BatchNorm(t.shape[-1], momentum=0.99))(t)
      if cfg.do_layer_norm:
        t = self.child('%s_ln' % block_name,
                       lambda: LayerNorm(t.shape[-1]))(t)
      if cfg.dropout_rate > 0:
        t = self.child('%s_dropout' % block_name,
                       lambda: Dropout(cfg.dropout_rate))(t)
      return t

    self._flat_names(names)
    feature_list = il.group_embeddings(pulled, batch, names, owner=self)
    mc = self.ctx.model_config
    if mc.HasField('variational_dropout'):
      vd = mc.variational_dropout
      vd_name = '%s_variational_dropout' % block_name
      feature_list = self.child(vd_name, lambda: VariationalDropout(
          [f.shape[-1] for f in feature_list], self.sink,
          '%s/%s/variational_dropout_loss' % (self.path, vd_name),
          regularization_lambda=vd.regularization_lambda,
          embedding_wise=vd.embedding_wise_variational_dropout))(
              feature_list)
    rate = cfg.feature_dropout_rate
    if rate > 0 and self.training:
      keep = torch.rand((len(feature_list),), generator=self.rng(),
                        device=feature_list[0].device) < 1.0 - rate
      feature_list = [f * keep[i] / (1.0 - rate)
                      for i, f in enumerate(feature_list)]

    if cfg.only_output_feature_list:
      return feature_list
    if cfg.only_output_3d_tensor:
      if len({f.shape[-1] for f in feature_list}) != 1:
        raise ValueError('3d output needs equal embedding dims')
      return _norm(torch.stack(feature_list, dim=1))
    flat = torch.cat(feature_list, dim=-1) \
        if len(feature_list) > 1 else feature_list[0]
    flat = _norm(flat)
    if cfg.output_2d_tensor_and_feature_list:
      # a PAIR [2d, <list>]: input_slice '[1]' selects the whole list
      return [flat, feature_list]
    return flat


class BackboneModule(_Scope):
  """The backbone: its packages (`pkg_<name>`), the main DAG (`main`) and
  top_mlp over main's output (a list output concatenated first)."""

  def __init__(self, ctx, backbone, state: BuildState, path: str):
    super().__init__(state, path)
    self.backbone = backbone
    packages = {}
    for pkg in backbone.packages:
      name = 'pkg_%s' % pkg.name
      packages[pkg.name] = Package(ctx, pkg, None, state,
                                   '%s/%s' % (path, name))
      self.add_module(name, packages[pkg.name])
    self.main = Package(ctx, backbone, packages, state, '%s/main' % path)

  def forward(self, batch, pulled):
    out = self.main(batch, pulled)
    top = self.backbone.top_mlp
    if self.backbone.HasField('top_mlp') and len(top.hidden_units):
      if isinstance(out, (list, tuple)):
        out = torch.cat(_flatten(list(out)), dim=-1)
      out = self.child('top_mlp', lambda: MLP.from_config(
          top, out.shape[-1], **self.kw))(out)
    return out
