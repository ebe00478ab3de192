"""Config -> model builders: port of ``tpudet/models/builder.py`` for
the single-stage, two-stage, Mask R-CNN-based and proposal detectors, and
the teacher of a knowledge-distillation detector."""
from __future__ import annotations

import copy
import os.path as osp
from typing import Dict, Optional

import torch
from torch import nn

from ..registry import MODELS, build_from_cfg


# a relative ``teacher_config`` names a file of the repo (the checkout that
# holds ``tpudet_torch/``)
REPO_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def _build(cfg: Dict):
    return build_from_cfg(copy.deepcopy(dict(cfg)), MODELS)


class ChainedNeck(nn.Module):
    """A sequence of necks, each fed the last one's outputs
    (``tpudet/models/necks/fpn.py:135-145``; Libra R-CNN's FPN -> BFP).
    The necks are ``necks_0``, ``necks_1``, ..., as flax names them."""

    def __init__(self, necks):
        super().__init__()
        self.num_necks = len(necks)
        for i, neck in enumerate(necks):
            self.add_module(f'necks_{i}', neck)

    def forward(self, x):
        for i in range(self.num_necks):
            x = getattr(self, f'necks_{i}')(x)
        return x


def _build_neck(cfg):
    """A neck, or a chain of them for a list (``tpudet/models/
    builder.py:48-53``)."""
    if isinstance(cfg, (list, tuple)):
        return ChainedNeck([_build_neck(c) for c in cfg])
    return _build(cfg)


def _build_teacher(path: str) -> Dict[str, nn.Module]:
    """A KD detector's frozen teacher (``tpudet/models/builder.py:66-82``):
    ``teacher_backbone``, ``teacher_neck`` and ``teacher_bbox_head`` of
    the detector config at ``path`` (relative to the repo root). Its
    weights come with the detector's variables, not from
    ``teacher_ckpt``."""
    from ..config import Config
    if not osp.isabs(path):
        path = osp.join(REPO_ROOT, path)
    tcfg = Config.fromfile(path)['model']
    teacher = {'teacher_backbone': _build(tcfg['backbone']),
               'teacher_bbox_head': _build(tcfg['bbox_head'])}
    if tcfg.get('neck') is not None:
        teacher['teacher_neck'] = _build_neck(tcfg['neck'])
    return teacher


def build_detector(cfg, train_cfg: Optional[Dict] = None,
                   test_cfg: Optional[Dict] = None,
                   dtype: Optional[torch.dtype] = None):
    """Build a detector from a reference-shaped config dict
    (``backbone``/``neck`` and ``bbox_head``, or ``rpn_head`` and / or
    ``roi_head`` (``tpudet/models/builder.py:86-91``), + ``train_cfg``/
    ``test_cfg``; a ``teacher_config`` builds the teacher's modules and
    ``teacher_ckpt`` is dropped).
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
    if 'teacher_config' in cfg:
        cfg.pop('teacher_ckpt', None)
        heads.update(_build_teacher(cfg.pop('teacher_config')))
    model = det_cls(
        backbone=_build(cfg.pop('backbone')),
        neck=None if neck_cfg is None else _build_neck(neck_cfg),
        train_cfg=dict(train_cfg) if train_cfg else None,
        test_cfg=dict(test_cfg) if test_cfg else None,
        **heads, **cfg)
    if dtype is not None:
        model.set_dtype(dtype)
    return model
