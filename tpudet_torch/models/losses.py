"""Losses: port of the part of ``tpudet/models/losses.py`` that the ported
heads use (``reduce_loss``, the BCE with logits, ``bce_loss``,
``giou_loss``, ``smooth_l1_loss``, ``l1_loss``, ``sigmoid_focal_loss``;
the ATSS family's ``varifocal_loss``, ``quality_focal_loss``,
``distribution_focal_loss`` and ``kd_kl_div_loss``). The rest of
tpudet's loss zoo comes with the models that use it.

Every loss takes an optional ``weight`` and ``avg_factor``, so padded
slots add nothing and a mean over the positives is a sum divided by
their count."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


def one_hot(labels, num_classes: int, dtype):
    """``jax.nn.one_hot``: a zero row for a label outside [0, C)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(dtype)


def varifocal_loss(pred, target, alpha: float = 0.75, gamma: float = 2.0,
                   iou_weighted: bool = True, weight=None,
                   reduction: str = 'mean', avg_factor=None,
                   loss_weight: float = 1.0):
    """VarifocalNet's loss (``tpudet/models/losses.py:161-175``): BCE with
    logits to the soft ``target`` (an IoU at the gt class, 0 elsewhere),
    weighted by the target itself at positives (1 without
    ``iou_weighted``) and by ``alpha |sigmoid(pred) - target|^gamma`` at
    negatives; the weight carries gradient."""
    pred_sigmoid = torch.sigmoid(pred)
    pos = (target > 0).to(pred.dtype)
    neg_weight = alpha * (pred_sigmoid - target).abs().pow(gamma) * (1 - pos)
    focal_weight = (target * pos if iou_weighted else pos) + neg_weight
    loss = binary_cross_entropy_with_logits(pred, target) * focal_weight
    return loss_weight * reduce_loss(loss, reduction, weight, avg_factor)


def quality_focal_loss(pred, target_label, target_score, beta: float = 2.0,
                       weight=None, reduction: str = 'mean', avg_factor=None,
                       loss_weight: float = 1.0):
    """GFL's quality focal loss (``losses.py:178-194``): BCE with logits to
    the quality ``target_score`` (N,) at the class ``target_label`` (N,)
    (``num_classes`` is the background: a zero row), times
    ``|sigmoid(pred) - target|^beta``."""
    onehot = one_hot(target_label, pred.shape[-1], pred.dtype) * \
        target_score[..., None]
    modulating = (torch.sigmoid(pred) - onehot).abs().pow(beta)
    loss = binary_cross_entropy_with_logits(pred, onehot) * modulating
    return loss_weight * reduce_loss(loss, reduction, weight, avg_factor)


def distribution_focal_loss(pred, target, weight=None,
                            reduction: str = 'mean', avg_factor=None,
                            loss_weight: float = 1.0):
    """GFL's distribution focal loss (``losses.py:197-212``): the cross
    entropy of the (..., n_bins) logits to the two bins around the
    continuous ``target``, weighted by the distances to them; the bin
    indices are clipped into [0, n_bins - 1]."""
    disl = torch.floor(target).long()
    disr = disl + 1
    wl = disr.to(pred.dtype) - target
    wr = target - disl.to(pred.dtype)
    logp = F.log_softmax(pred, dim=-1)
    n_bins = pred.shape[-1]
    ll = torch.gather(logp, -1, disl.clamp(0, n_bins - 1)[..., None])[..., 0]
    lr = torch.gather(logp, -1, disr.clamp(0, n_bins - 1)[..., None])[..., 0]
    loss = -(ll * wl + lr * wr)
    return loss_weight * reduce_loss(loss, reduction, weight, avg_factor)


def kd_kl_div_loss(pred, soft_label, T: float = 10.0, weight=None,
                   reduction: str = 'mean', avg_factor=None,
                   loss_weight: float = 1.0, detach_target: bool = True):
    """The knowledge-distillation KL loss (``losses.py:311-322``): the mean
    over the last axis of ``KL(softmax(soft_label / T) || softmax(pred /
    T))``, the target clipped at 1e-12 inside its log, times ``T^2``."""
    target = F.softmax(soft_label / T, dim=-1)
    if detach_target:
        target = target.detach()
    logp = F.log_softmax(pred / T, dim=-1)
    kl = target * (torch.log(torch.clamp_min(target, 1e-12)) - logp)
    loss = kl.mean(dim=-1) * (T * T)
    return loss_weight * reduce_loss(loss, reduction, weight, avg_factor)
