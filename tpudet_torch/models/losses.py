"""Losses: port of the part of ``tpudet/models/losses.py`` that the ported
heads use (``reduce_loss``, the BCE with logits, ``bce_loss``,
``giou_loss``, ``smooth_l1_loss``, ``l1_loss``, ``sigmoid_focal_loss``).
The rest of tpudet's loss zoo comes with the models that use it.

Every loss takes an optional ``weight`` and ``avg_factor``, so padded
slots add nothing and a mean over the positives is a sum divided by
their count."""
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


def bce_loss(pred, target, weight=None, reduction: str = 'mean',
             avg_factor=None, loss_weight: float = 1.0):
    """The sigmoid ``CrossEntropyLoss`` (``use_sigmoid=True``):
    elementwise BCE with logits, then ``reduce_loss``."""
    loss = binary_cross_entropy_with_logits(pred, target)
    return loss_weight * reduce_loss(loss, reduction, weight, avg_factor)


def giou_loss(pred, target, weight=None, reduction: str = 'mean',
              avg_factor=None, loss_weight: float = 1.0, eps: float = 1e-7):
    """``1 - GIoU`` of aligned xyxy boxes."""
    loss = 1.0 - bbox_overlaps_aligned(pred, target, mode='giou', eps=eps)
    return loss_weight * reduce_loss(loss, reduction, weight, avg_factor)


def smooth_l1_loss(pred, target, beta: float = 1.0, weight=None,
                   reduction: str = 'mean', avg_factor=None,
                   loss_weight: float = 1.0):
    """Huber form: ``0.5 d^2 / beta`` below ``beta``, ``d - 0.5 beta``
    above."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return loss_weight * reduce_loss(loss, reduction, weight, avg_factor)


def l1_loss(pred, target, weight=None, reduction: str = 'mean',
            avg_factor=None, loss_weight: float = 1.0):
    loss = (pred - target).abs()
    return loss_weight * reduce_loss(loss, reduction, weight, avg_factor)


def sigmoid_focal_loss(pred, target, gamma: float = 2.0, alpha: float = 0.25,
                       weight=None, reduction: str = 'mean', avg_factor=None,
                       loss_weight: float = 1.0):
    """Focal loss on one-hot ``target`` (no background column): the stable
    BCE with logits times ``(alpha t + (1 - alpha)(1 - t)) pt^gamma``,
    ``pt = (1 - p) t + p (1 - t)``; the focal weight carries gradient, as
    in tpudet."""
    pred_sigmoid = torch.sigmoid(pred)
    pt = (1 - pred_sigmoid) * target + pred_sigmoid * (1 - target)
    focal_weight = (alpha * target + (1 - alpha) * (1 - target)) * pt**gamma
    loss = binary_cross_entropy_with_logits(pred, target) * focal_weight
    return loss_weight * reduce_loss(loss, reduction, weight, avg_factor)
