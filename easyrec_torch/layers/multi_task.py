"""Multi-task layers: batched experts, MMoE gates and PLE's CGC layer.

Counterpart of easyrec_tpu/layers/multi_task.py: BatchedExperts (:18),
MMoE (:51) and CGCLayer (:76). The parameters keep flax's layout and
names: an expert stack's layer i is `w_i` [E, D, U] and `b_i` [E, U], each
expert's kernel drawn by he_uniform over its own fan_in D
(variance_scaling(2, 'fan_in', 'uniform', batch_axis=0), :35-36), so
convert.py carries them without a transpose. The gates are flax Dense
layers, `gate_<t>`, `task_gate_<t>` and `share_gate`.

The JAX package repeats x to [B, E, D] and runs one einsum per layer; here
the first layer is one broadcast matmul of x against every expert's
kernel and the rest batched matmuls over the experts, with the hidden
state kept expert-major ([E, B, U]): the same products, added in another
order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from easyrec_torch.layers.dnn import Dense, get_activation


class BatchedExperts(nn.Module):
  """num_expert parallel dense stacks: [B, D] -> [E, B, U]."""

  def __init__(self, in_features: int, num_expert: int,
               hidden_units: Sequence[int], activation: str = 'relu',
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    self.act = get_activation(activation)
    self.num_expert = num_expert
    self.n_layers = len(hidden_units)
    width = in_features
    for i, units in enumerate(hidden_units):
      limit = (6.0 / width) ** 0.5          # he_uniform, fan_in = width
      w = torch.empty((num_expert, width, units), device=device)
      with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)
      self.register_parameter('w_%d' % i, nn.Parameter(w))
      self.register_parameter('b_%d' % i, nn.Parameter(
          torch.zeros((num_expert, units), device=device)))
      width = units
    self.out_features = width

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    h = x if self.n_layers else x.expand(self.num_expert, *x.shape)
    for i in range(self.n_layers):
      w, b = getattr(self, 'w_%d' % i), getattr(self, 'b_%d' % i)
      # layer 0: [B, D] @ [E, D, U] broadcasts to [E, B, U]
      h = self.act(torch.baddbmm(b[:, None, :], h, w) if i else
                   torch.matmul(h, w) + b[:, None, :])
    return h


def _mix(gate_logits: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
  """softmax(gate) [B, E] weighting experts [E, B, U] -> [B, U]."""
  gate = torch.softmax(gate_logits, dim=-1)
  return torch.einsum('be,ebu->bu', gate, experts)


class MMoE(nn.Module):
  """Multi-gate mixture of experts: one softmax gate per task over shared
  experts (`experts`, `gate_<t>`)."""

  def __init__(self, in_features: int, num_task: int, num_expert: int,
               expert_hidden_units: Sequence[int],
               expert_activation: str = 'relu',
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.num_task = num_task
    self.experts = BatchedExperts(in_features, num_expert,
                                  expert_hidden_units, expert_activation,
                                  **kw)
    for t in range(num_task):
      self.add_module('gate_%d' % t, Dense(in_features, num_expert, **kw))
    self.out_features = self.experts.out_features

  def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
    experts = self.experts(x)
    return [_mix(getattr(self, 'gate_%d' % t)(x), experts)
            for t in range(self.num_task)]


class CGCLayer(nn.Module):
  """One PLE extraction layer: per-task experts `task_experts_<t>` and
  shared experts `share_experts`, each task gated over its own and the
  shared ones (`task_gate_<t>`), and, unless it is the final layer, the
  shared output gated over all of them (`share_gate`)."""

  def __init__(self, task_features: Sequence[int], share_features: int,
               expert_num_per_task: int, share_num: int,
               task_hidden_units: Sequence[int],
               share_hidden_units: Sequence[int], final_layer: bool = False,
               activation: str = 'relu',
               generator: Optional[torch.Generator] = None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.num_task = len(task_features)
    self.final_layer = final_layer
    for t, d in enumerate(task_features):
      self.add_module('task_experts_%d' % t, BatchedExperts(
          d, expert_num_per_task, task_hidden_units, activation, **kw))
    self.share_experts = BatchedExperts(share_features, share_num,
                                        share_hidden_units, activation, **kw)
    for t, d in enumerate(task_features):
      self.add_module('task_gate_%d' % t,
                      Dense(d, expert_num_per_task + share_num, **kw))
    if not final_layer:
      self.share_gate = Dense(share_features,
                              self.num_task * expert_num_per_task +
                              share_num, **kw)
    self.out_features = self.share_experts.out_features

  def forward(self, task_inputs: Sequence[torch.Tensor],
              shared_input: torch.Tensor
              ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    task_experts = [getattr(self, 'task_experts_%d' % t)(task_inputs[t])
                    for t in range(self.num_task)]
    shared = self.share_experts(shared_input)
    task_outs = [
        _mix(getattr(self, 'task_gate_%d' % t)(task_inputs[t]),
             torch.cat([task_experts[t], shared], dim=0))
        for t in range(self.num_task)]
    if self.final_layer:
      return task_outs, None
    return task_outs, _mix(self.share_gate(shared_input),
                           torch.cat(task_experts + [shared], dim=0))
