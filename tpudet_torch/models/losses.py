"""Losses of the YOLO head: port of the part of ``tpudet/models/losses.py``
that ``YOLOCSPHead.loss`` uses (``:23-64``). The rest of tpudet's loss zoo
comes with the models that use it."""
from __future__ import annotations

from typing import Optional

import torch

from ..core.bbox import bbox_overlaps_aligned


def reduce_loss(loss, reduction: str = 'mean', weight=None,
                avg_factor: Optional[torch.Tensor] = None):
    """Weight, then reduce. With ``weight`` and ``reduction='mean'`` the
    sum is divided by ``avg_factor`` (or the weight sum), not the element
    count: the masked mean over positives."""
    if weight is not None:
        loss = loss * weight
    if reduction == 'none':
        return loss
    if reduction == 'sum':
        return loss.sum()
    if reduction == 'mean':
        if avg_factor is None:
            if weight is None:
                return loss.mean()
            avg_factor = torch.as_tensor(weight).sum()
        return loss.sum() / torch.clamp_min(
            torch.as_tensor(avg_factor, dtype=loss.dtype,
                            device=loss.device), 1e-12)
    raise ValueError(f'unknown reduction {reduction}')


def binary_cross_entropy_with_logits(pred, target):
    """Elementwise BCE with logits, the stable log-sum-exp form:
    ``max(p, 0) - p t + log1p(exp(-|p|))``."""
    return (torch.maximum(pred, pred.new_zeros(())) - pred * target +
            torch.log1p(torch.exp(-pred.abs())))


def giou_loss(pred, target, weight=None, reduction: str = 'mean',
              avg_factor=None, loss_weight: float = 1.0, eps: float = 1e-7):
    """``1 - GIoU`` of aligned xyxy boxes."""
    loss = 1.0 - bbox_overlaps_aligned(pred, target, mode='giou', eps=eps)
    return loss_weight * reduce_loss(loss, reduction, weight, avg_factor)
