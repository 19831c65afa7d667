"""Device resolution: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
  """`device` (default 'cuda') as a torch.device.

  Raises RuntimeError when CUDA is asked for and absent: the port never
  carries on on the CPU in place of the card.
  """
  dev = torch.device('cuda' if device is None else device)
  if dev.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        'device %s was asked for but torch.cuda.is_available() is False; '
        "pass device='cpu' (CLI: --device cpu) to run on the CPU" % dev)
  if dev.type not in ('cuda', 'cpu'):
    raise ValueError('unsupported device %s' % dev)
  return dev
