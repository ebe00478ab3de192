"""The device an entry point runs on."""
from __future__ import annotations

from typing import Union

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
