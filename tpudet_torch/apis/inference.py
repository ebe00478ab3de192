"""Inference API: counterpart of ``tpudet/apis/inference.py``
(``init_detector``, ``Detector``) for an already normalized image batch.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
with no GPU they raise rather than run on the CPU. Image loading, the test
pipeline and checkpoint files come with later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..config import Config
from ..core.nms import NMSResult
from ..models.builder import build_detector
from ..utils.flax_import import load_flax_variables, random_flax_variables


def _device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            'detector on the CPU')
    return device


class Detector:
    """A built detector on its device, in eval mode."""

    def __init__(self, model, cfg: Optional[Config] = None):
        self.model = model.eval()
        self.cfg = cfg
        self.device = next(model.parameters()).device

    def forward(self, img) -> tuple:
        """Raw pred maps of an image batch (B, H, W, 3)."""
        with torch.inference_mode():
            return self.model(torch.as_tensor(img, device=self.device))

    def __call__(self, img, scale_factor=None) -> NMSResult:
        """Detections of a normalized image batch (B, H, W, 3), H and W
        multiples of 32. ``scale_factor`` (B, 4) maps boxes back to the
        original images."""
        with torch.inference_mode():
            pred_maps = self.model(torch.as_tensor(img, device=self.device))
            return self.model.get_bboxes(pred_maps,
                                         scale_factors=scale_factor)


def init_detector(config: Union[str, Config, Dict],
                  variables: Optional[Dict] = None,
                  device: Union[str, torch.device] = 'cuda',
                  dtype: torch.dtype = torch.bfloat16) -> Detector:
    """Build a detector from a config file, ``Config`` or model dict, load
    tpudet ``variables`` (``{'params', 'batch_stats'}`` numpy tree) into it
    or, without them, tpudet's init drawn from numpy seed 0, and put it on
    ``device`` in compute dtype ``dtype``."""
    device = _device(device)
    if isinstance(config, str):
        config = Config.fromfile(config)
    cfg = config if isinstance(config, Config) else Config(dict(model=config))
    model = build_detector(cfg['model'])
    if variables is None:
        variables = random_flax_variables(model, seed=0)
    load_flax_variables(model, variables)
    model.set_dtype(dtype)
    model.to(device=device, memory_format=torch.channels_last)
    return Detector(model, cfg)
