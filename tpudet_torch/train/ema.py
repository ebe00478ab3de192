"""EMA over the full train state (params and BN statistics): port of
``tpudet/train/ema.py`` (the reference's StateEMAHook).

- ``ema = m_t * ema + (1 - m_t) * online`` with the warm-up momentum
  ``m_t = momentum * (1 - exp(-step / (warm_up * interval)))``;
- tensors that are not floating point (``num_batches_tracked``) are copied,
  not blended;
- one update every ``interval`` iterations.

The update works in place on the EMA tensors.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def ema_momentum(step, momentum: float = 0.9999, warm_up: int = 2000,
                 interval: int = 1) -> torch.Tensor:
    """Warm-up-scaled EMA momentum at ``step`` (0-based), fp32."""
    step = torch.as_tensor(step)
    return momentum * (1 - torch.exp(-step / (warm_up * interval)))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], online: Dict[str, torch.Tensor],
               momentum_t) -> Dict[str, torch.Tensor]:
    """One EMA fold of ``online`` into ``ema``, in place; float tensors are
    blended in fp32, the others copied."""
    floats = [k for k, v in ema.items() if v.is_floating_point()]
    for k, v in ema.items():
        if not v.is_floating_point():
            v.copy_(online[k])
    if floats:
        e = [ema[k] for k in floats]
        torch._foreach_mul_(e, momentum_t)
        torch._foreach_add_(e, torch._foreach_mul(
            [online[k].detach() for k in floats], 1 - momentum_t))
    return ema


def ema_interval(nominal_batch_size, samples_per_step) -> int:
    """interval = ceil(nominal / actual global batch)."""
    if nominal_batch_size is None:
        return 1
    return max(1, math.ceil(nominal_batch_size / samples_per_step))
