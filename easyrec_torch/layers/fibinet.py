"""SENet / Bilinear / FiBiNet / MaskNet feature-refinement layers.

Counterpart of easyrec_tpu/layers/fibinet.py (whole): SENet (:17-42),
Bilinear (:45-85), FiBiNet (:88-113), MaskBlock (:116-135) and MaskNet
(:138-159). The flax modules learn their input widths at their first call;
these take them as arguments ([B, F, D] fields as num_fields and dim).
Parameter and submodule names follow the flax tree: Bilinear's `w` keeps
flax's layout ([d, d], [F, d, d] or [pairs, d, d]), so convert.py carries
it as it is.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from easyrec_torch.layers.attention import LayerNorm
from easyrec_torch.layers.dnn import MLP, Dense, flax_init


class SENet(nn.Module):
  """Squeeze-and-excitation over fields: [B, F, D] -> reweighted
  [B, F * D] (group squeeze by mean and max, skip connection and output
  LayerNorm where set)."""

  def __init__(self, num_fields: int, dim: int, reduction_ratio: int = 4,
               num_squeeze_group: int = 2, use_skip_connection: bool = True,
               use_output_layer_norm: bool = True,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    if dim % num_squeeze_group:
      raise ValueError('embedding dim must divide num_squeeze_group')
    self.groups = num_squeeze_group
    self.use_skip_connection = use_skip_connection
    z = num_fields * num_squeeze_group * 2
    reduction = max(1, z // reduction_ratio)
    self.squeeze = Dense(z, reduction, **kw)
    self.excite = Dense(reduction, num_fields * dim, **kw)
    if use_output_layer_norm:
      self.ln = LayerNorm(num_fields * dim, device=device)
    self.out_features = num_fields * dim

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, f, d = x.shape
    g = self.groups
    grouped = x.reshape(b, f, g, d // g)
    z = torch.cat([grouped.mean(dim=-1), grouped.amax(dim=-1)],
                  dim=-1).reshape(b, f * g * 2)
    a = F.relu(self.excite(F.relu(self.squeeze(z))))
    flat = x.reshape(b, f * d)
    out = flat * a
    if self.use_skip_connection:
      out = out + flat
    if hasattr(self, 'ln'):
      out = self.ln(out)
    return out


class Bilinear(nn.Module):
  """Bilinear field interaction of every pair i < j (row-major, as
  jnp.triu_indices orders them): type 'all' (one [d, d] matrix), 'each'
  (one per field) or 'interaction' (one per pair, with use_plus the
  product, else the sum, with field j); flattened, through `out` to
  num_output_units where set."""

  def __init__(self, num_fields: int, dim: int, type: str = 'interaction',
               use_plus: bool = True, num_output_units: int = 0,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    self.type = type
    self.use_plus = use_plus
    rows, cols = torch.triu_indices(num_fields, num_fields, 1)
    self.register_buffer('rows', rows, persistent=False)
    self.register_buffer('cols', cols, persistent=False)
    pairs = rows.numel()
    if type == 'all':
      w = flax_init((dim, dim), 'glorot_uniform', generator)
    else:
      # one glorot fan per matrix (flax's batch_axis=0)
      w = flax_init((num_fields if type == 'each' else pairs, dim, dim),
                    'glorot_uniform', generator, batch_axis=(0,))
    self.w = nn.Parameter(w.to(device))
    self.out_features = pairs * dim
    if num_output_units:
      self.out = Dense(pairs * dim, num_output_units, generator, device)
      self.out_features = num_output_units

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b = x.shape[0]
    if self.type == 'all':
      left = torch.einsum('bfd,de->bfe', x, self.w)[:, self.rows]
      inter = left * x[:, self.cols]
    elif self.type == 'each':
      left = torch.einsum('bfd,fde->bfe', x, self.w)[:, self.rows]
      inter = left * x[:, self.cols]
    else:
      left = torch.einsum('bpd,pde->bpe', x[:, self.rows], self.w)
      inter = left * x[:, self.cols] if self.use_plus else \
          left + x[:, self.cols]
    out = inter.reshape(b, -1)
    return self.out(out) if hasattr(self, 'out') else out


class FiBiNet(nn.Module):
  """SENet, and Bilinear over the raw and the SE fields, concatenated,
  then the MLP where mlp_hidden_units are set."""

  def __init__(self, num_fields: int, dim: int,
               senet_reduction_ratio: int = 4,
               senet_num_squeeze_group: int = 2,
               bilinear_type: str = 'interaction',
               bilinear_output_units: int = 0,
               mlp_hidden_units: Sequence[int] = (),
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.senet = SENet(num_fields, dim, senet_reduction_ratio,
                       senet_num_squeeze_group, **kw)
    self.bilinear_raw = Bilinear(num_fields, dim, bilinear_type,
                                 num_output_units=bilinear_output_units, **kw)
    self.bilinear_se = Bilinear(num_fields, dim, bilinear_type,
                                num_output_units=bilinear_output_units, **kw)
    width = 2 * self.bilinear_raw.out_features
    if mlp_hidden_units:
      self.mlp = MLP(width, mlp_hidden_units, **kw)
      width = self.mlp.out_features
    self.out_features = width

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    se = self.senet(x).reshape(x.shape)
    out = torch.cat([self.bilinear_raw(x), self.bilinear_se(se)], dim=-1)
    return self.mlp(out) if hasattr(self, 'mlp') else out


class MaskBlock(nn.Module):
  """MaskNet block: an instance-guided mask (mask_hidden, relu, mask_out)
  from mask_input times the (layer-normed) input, projected by `proj` and
  relu(out_ln(.))."""

  def __init__(self, in_features: int, mask_features: int, output_size: int,
               reduction_factor: float = 0.0, aggregation_size: int = 0,
               input_layer_norm: bool = False,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    if input_layer_norm:
      self.input_ln = LayerNorm(in_features, device=device)
    agg = aggregation_size or int(mask_features * (reduction_factor or 1.0))
    self.mask_hidden = Dense(mask_features, agg, **kw)
    self.mask_out = Dense(agg, in_features, **kw)
    self.proj = Dense(in_features, output_size, use_bias=False, **kw)
    self.out_ln = LayerNorm(output_size, device=device)
    self.out_features = output_size

  def forward(self, x: torch.Tensor,
              mask_input: torch.Tensor) -> torch.Tensor:
    if hasattr(self, 'input_ln'):
      x = self.input_ln(x)
    mask = self.mask_out(F.relu(self.mask_hidden(mask_input)))
    return F.relu(self.out_ln(self.proj(x * mask)))


class MaskNet(nn.Module):
  """MaskBlocks in parallel (each on the input, concatenated) or in series
  (each on the previous output, masked by the input), then the MLP."""

  def __init__(self, in_features: int, block_output_sizes: Sequence[int],
               block_reduction_factors: Sequence[float] = (),
               use_parallel: bool = True,
               mlp_hidden_units: Sequence[int] = (),
               input_layer_norm: bool = True,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.use_parallel = use_parallel
    if input_layer_norm:
      self.input_ln = LayerNorm(in_features, device=device)
    reds = list(block_reduction_factors) or [1.0] * len(block_output_sizes)
    self.n_blocks = len(block_output_sizes)
    width = in_features
    for i, sz in enumerate(block_output_sizes):
      self.add_module('block_%d' % i, MaskBlock(
          in_features if use_parallel else width, in_features, int(sz),
          reduction_factor=reds[i], **kw))
      width = int(sz)
    width = sum(int(s) for s in block_output_sizes) if use_parallel \
        else width
    if mlp_hidden_units:
      self.mlp = MLP(width, mlp_hidden_units, **kw)
      width = self.mlp.out_features
    self.out_features = width

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    inp = self.input_ln(x) if hasattr(self, 'input_ln') else x
    blocks = [getattr(self, 'block_%d' % i) for i in range(self.n_blocks)]
    if self.use_parallel:
      out = torch.cat([blk(inp, inp) for blk in blocks], dim=-1)
    else:
      out = inp
      for blk in blocks:
        out = blk(out, inp)
    return self.mlp(out) if hasattr(self, 'mlp') else out
