"""The device an entry point runs on."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``. Entry points default to ``cuda``;
    with no GPU that raises rather than runs on the CPU, which the caller
    asks for with ``device='cpu'``."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            'CPU')
    return device


def to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device``. A host array
    bound for a GPU goes through pinned memory without blocking: a copy
    from pageable memory would wait for every kernel queued on the stream
    before it."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == 'cuda' and x.device.type == 'cpu':
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)
