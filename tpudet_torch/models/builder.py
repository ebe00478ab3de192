"""Config -> model builders: port of ``tpudet/models/builder.py`` for
the single-stage, two-stage and proposal detectors."""
from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from ..registry import MODELS, build_from_cfg


def _build(cfg: Dict):
    return build_from_cfg(copy.deepcopy(dict(cfg)), MODELS)


def build_detector(cfg, train_cfg: Optional[Dict] = None,
                   test_cfg: Optional[Dict] = None,
                   dtype: Optional[torch.dtype] = None):
    """Build a detector from a reference-shaped config dict
    (``backbone``/``neck`` and ``bbox_head``, or ``rpn_head`` and / or
    ``roi_head`` (``tpudet/models/builder.py:86-91``), + ``train_cfg``/
    ``test_cfg``).
    ``dtype`` sets the compute dtype, as tpudet's ``_flagship_model``
    passes ``dtype`` to every module."""
    cfg = copy.deepcopy(dict(cfg))
    det_type = cfg.pop('type')
    det_cls = MODELS.get(det_type)
    if det_cls is None:
        raise KeyError(f'{det_type} is not a registered detector')
    train_cfg = cfg.pop('train_cfg', None) if train_cfg is None else train_cfg
    test_cfg = cfg.pop('test_cfg', None) if test_cfg is None else test_cfg
    neck_cfg = cfg.pop('neck', None)
    heads = {name: _build(cfg.pop(name))
             for name in ('rpn_head', 'roi_head') if name in cfg}
    if not heads:
        heads['bbox_head'] = _build(cfg.pop('bbox_head'))
    model = det_cls(
        backbone=_build(cfg.pop('backbone')),
        neck=None if neck_cfg is None else _build(neck_cfg),
        train_cfg=dict(train_cfg) if train_cfg else None,
        test_cfg=dict(test_cfg) if test_cfg else None,
        **heads, **cfg)
    if dtype is not None:
        model.set_dtype(dtype)
    return model
