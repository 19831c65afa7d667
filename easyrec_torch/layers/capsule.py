"""Behaviour-to-interest dynamic routing for MIND.

Counterpart of easyrec_tpu/layers/capsule.py: squash (:15-20) and
CapsuleLayer (:23-80). The routing logits start from a random draw of
stddev routing_logits_stddev: in training from the generator
set_generator gives the model (the trainer's, seeded from random_seed),
in eval from a fresh generator seeded 11 on the input's device, so an
eval, export or served forward is a function of its inputs. The JAX
package draws them from its `routing` rng in training and from
PRNGKey(11) in eval; torch cannot draw flax's numbers, so the two
packages agree on the distribution of the draw and not on the draw
(`init_logits` takes a given draw instead, as the tests hand in the JAX
one).
"""

from __future__ import annotations

from typing import Optional

import torch

from easyrec_torch.layers.dnn import Stochastic, flax_init

EVAL_ROUTING_SEED = 11


def squash(x: torch.Tensor, pow: float = 1.0, dim: int = -1
           ) -> torch.Tensor:
  """The capsule nonlinearity x * (|x|^2 / (1 + |x|^2))^pow / |x|."""
  sq_norm = torch.sum(torch.square(x), dim=dim, keepdim=True)
  scale = torch.pow(sq_norm / (1.0 + sq_norm), pow) * torch.rsqrt(
      sq_norm + 1e-9)
  return x * scale


class CapsuleLayer(Stochastic):
  """seq [B, L, D], mask [B, L] -> (interests [B, K, high_dim], interest
  mask [B, K]): a bilinear map shared across behaviours (`bilinear`, [D,
  high_dim], glorot uniform), ceil(log2(valid length)) interests clipped
  to [1, max_k] a user unless const_caps_num, and num_iters rounds of
  routing whose softmax runs over the interests; only the last round's
  interests carry gradient to the behaviours."""

  def __init__(self, in_features: int, max_k: int = 5, high_dim: int = 64,
               num_iters: int = 3, routing_logits_scale: float = 20.0,
               routing_logits_stddev: float = 1.0, squash_pow: float = 1.0,
               const_caps_num: bool = False,
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    self.max_k = int(max_k)
    self.num_iters = int(num_iters)
    self.routing_logits_scale = float(routing_logits_scale)
    self.routing_logits_stddev = float(routing_logits_stddev)
    self.squash_pow = float(squash_pow)
    self.const_caps_num = bool(const_caps_num)
    self.bilinear = torch.nn.Parameter(flax_init(
        (in_features, high_dim), 'glorot_uniform', generator).to(device))
    self.out_features = int(high_dim)

  def draw_logits(self, b: int, l: int, device) -> torch.Tensor:
    """[B, K, L] initial routing logits (see the module docstring)."""
    shape = (b, self.max_k, l)
    if self.training:
      gen = self.rng()
    else:
      gen = torch.Generator(device=device).manual_seed(EVAL_ROUTING_SEED)
    return self.routing_logits_stddev * torch.randn(
        shape, generator=gen, device=device)

  def forward(self, seq: torch.Tensor, mask: torch.Tensor,
              init_logits: Optional[torch.Tensor] = None):
    b, l, _ = seq.shape
    k = self.max_k
    u = torch.einsum('bld,de->ble', seq, self.bilinear)
    if self.const_caps_num:
      n_caps = torch.full((b,), float(k), device=seq.device)
    else:
      seq_len = torch.clamp(mask.sum(dim=1), min=1.0)
      n_caps = torch.clamp(torch.log2(seq_len), 1.0, float(k))
    cap_mask = (torch.arange(k, device=seq.device)[None, :] <
                torch.ceil(n_caps)[:, None]).to(seq.dtype)
    logits = init_logits if init_logits is not None else \
        self.draw_logits(b, l, seq.device)
    u_stop = u.detach()
    interests = None
    for it in range(self.num_iters):
      last = it == self.num_iters - 1
      masked = torch.where(cap_mask[:, :, None] > 0,
                           logits * self.routing_logits_scale,
                           torch.full_like(logits, -1e9))
      w = torch.softmax(masked, dim=1) * mask[:, None, :]
      z = torch.einsum('bkl,ble->bke', w, u if last else u_stop)
      interests = squash(z, pow=self.squash_pow)
      if not last:
        logits = logits + torch.einsum('bke,ble->bkl', interests.detach(),
                                       u_stop)
    return interests * cap_mask[:, :, None], cap_mask
