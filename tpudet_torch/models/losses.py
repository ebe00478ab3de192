"""Losses: port of the part of ``tpudet/models/losses.py`` that the ported
heads use (``reduce_loss``, the BCE with logits, ``bce_loss``,
``giou_loss``, ``iou_loss``, ``bounded_iou_loss``, ``smooth_l1_loss``,
``l1_loss``, ``sigmoid_focal_loss``;
the ATSS family's ``varifocal_loss``, ``quality_focal_loss``,
``distribution_focal_loss`` and ``kd_kl_div_loss``; Libra R-CNN's
``balanced_l1_loss`` and GHM's ``ghm_c_loss`` and ``ghm_r_loss``). The
rest of tpudet's loss zoo comes with the models that use it.

Every loss takes an optional ``weight`` and ``avg_factor``, so padded
slots add nothing and a mean over the positives is a sum divided by
their count."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.bbox import bbox_overlaps_aligned
from ..parallel.mesh import global_sum


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


def iou_loss(pred, target, weight=None, reduction: str = 'mean',
             avg_factor=None, loss_weight: float = 1.0, eps: float = 1e-6,
             linear: bool = False):
    """``-log(IoU)``, or ``1 - IoU`` with ``linear``, of aligned xyxy
    boxes, the IoU clipped below at ``eps`` (``tpudet/models/losses.py:
    67-73``)."""
    ious = torch.clamp_min(
        bbox_overlaps_aligned(pred, target, mode='iou', eps=eps), eps)
    loss = (1 - ious) if linear else -torch.log(ious)
    return loss_weight * reduce_loss(loss, reduction, weight, avg_factor)


def bounded_iou_loss(pred, target, beta: float = 0.2, weight=None,
                     reduction: str = 'mean', avg_factor=None,
                     loss_weight: float = 1.0, eps: float = 1e-3):
    """Bounded IoU loss (``tpudet/models/losses.py:76-100``): per
    coordinate, ``1 - max((t - 2d) / (t + 2d + eps), 0)`` of the centre
    shift ``d`` and ``1 - min(t / (p + eps), p / (t + eps))`` of each side,
    through a smooth-L1 envelope at ``beta``; the target is held constant.
    ``reduction='none'`` gives the (..., 4) terms."""
    pcx = (pred[..., 0] + pred[..., 2]) * 0.5
    pcy = (pred[..., 1] + pred[..., 3]) * 0.5
    pw = pred[..., 2] - pred[..., 0]
    ph = pred[..., 3] - pred[..., 1]
    t = target.detach()
    tcx = (t[..., 0] + t[..., 2]) * 0.5
    tcy = (t[..., 1] + t[..., 3]) * 0.5
    tw = t[..., 2] - t[..., 0]
    th = t[..., 3] - t[..., 1]
    # |d| with jnp.abs's gradient at 0 (+1, where torch's abs gives 0): a
    # centre that sits on the target's still gets the centre terms' pull
    dx = torch.where(tcx >= pcx, tcx - pcx, pcx - tcx)
    dy = torch.where(tcy >= pcy, tcy - pcy, pcy - tcy)
    zero = pred.new_zeros(())
    loss_dx = 1 - torch.maximum((tw - 2 * dx) / (tw + 2 * dx + eps), zero)
    loss_dy = 1 - torch.maximum((th - 2 * dy) / (th + 2 * dy + eps), zero)
    loss_dw = 1 - torch.minimum(tw / (pw + eps), pw / (tw + eps))
    loss_dh = 1 - torch.minimum(th / (ph + eps), ph / (th + eps))
    comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], dim=-1)
    loss = torch.where(comb < beta, 0.5 * comb * comb / beta,
                       comb - 0.5 * beta)
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


def balanced_l1_loss(pred, target, beta: float = 1.0, alpha: float = 0.5,
                     gamma: float = 1.5, weight=None, reduction: str = 'mean',
                     avg_factor=None, loss_weight: float = 1.0):
    """Libra R-CNN's balanced L1 (``losses.py:147-159``): below ``beta``,
    ``alpha / b (b d + 1) log(b d / beta + 1) - alpha d``, above it
    ``gamma d + gamma / b - alpha beta``, ``b = e^(gamma / alpha) - 1`` a
    Python float as in tpudet."""
    diff = (pred - target).abs()
    b = math.e**(gamma / alpha) - 1
    loss = torch.where(
        diff < beta,
        alpha / b * (b * diff + 1) * torch.log(b * diff / beta + 1) -
        alpha * diff,
        gamma * diff + gamma / b - alpha * beta)
    return loss_weight * reduce_loss(loss, reduction, weight, avg_factor)


def unit_edges(bins: int, dtype, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, bins + 1)`` bit for bit: XLA multiplies the
    iota by the rounded reciprocal ``1 / bins``, then appends 1."""
    step = torch.tensor(1.0, dtype=dtype) / bins
    return torch.cat([torch.arange(bins, dtype=dtype) * step,
                      torch.ones(1, dtype=dtype)]).to(device)


def ghm_c_loss(pred, target, label_weight=None, bins: int = 10,
               loss_weight: float = 1.0):
    """Gradient-harmonized classification loss, stateless (tpudet's
    ``momentum`` 0, which it never reads; ``losses.py:215-239``): each
    valid element's BCE with logits is weighted by ``tot / (count of its
    bin)`` over the count of non-empty bins, the bins splitting ``g =
    |sigmoid(pred) - target|`` (no gradient) at ``unit_edges``, the last
    bin closed by ``+1e-6``; the sum over ``tot``, the valid count. ``tot`` and the bins' counts are exact
    integers made floats where tpudet divides by them (fp32, or float64
    for a float64 ``pred``: past 2^24 they round as tpudet's do). With a
    process group they are summed over the ranks, so that each rank's loss
    is its share of the loss of the whole batch."""
    g = (torch.sigmoid(pred) - target).abs().detach()
    if label_weight is None:
        label_weight = torch.ones_like(pred)
    valid = label_weight > 0
    edges = unit_edges(bins, torch.promote_types(pred.dtype, torch.float32),
                       pred.device)
    edges[-1] += 1e-6  # rounded in the edges' dtype, as tpudet's
    # bin i holds edges[i] <= g < edges[i + 1]; a NaN lands past the last
    bin_id = torch.searchsorted(edges, g.contiguous(), right=True) - 1
    inside = valid & (bin_id < bins)
    counts = global_sum(torch.cat([
        valid.sum()[None],
        torch.bincount(torch.where(inside, bin_id, bins).reshape(-1),
                       minlength=bins + 1)[:bins]]))
    tot = torch.clamp_min(counts[0].to(edges.dtype), 1.0)
    counts = counts[1:]
    n = counts[bin_id.clamp_max(bins - 1)]
    weights = torch.where(inside & (n > 0),
                          tot / torch.clamp_min(n.to(edges.dtype), 1.0),
                          torch.zeros((), dtype=edges.dtype,
                                      device=pred.device))
    nonempty = (counts > 0).sum().float()
    weights = weights / torch.clamp_min(nonempty, 1.0)
    loss = binary_cross_entropy_with_logits(pred, target) * weights
    return loss_weight * loss.sum() / tot


def ghm_r_loss(pred, target, label_weight=None, mu: float = 0.02,
               bins: int = 10, loss_weight: float = 1.0):
    """Gradient-harmonized regression loss, stateless (``losses.py:242-
    274``): the authentic smooth L1 ``sqrt(d^2 + mu^2) - mu``, each valid
    element weighted by ``tot / (count of its bin)`` over the count of
    non-empty bins, its bin ``min(int(g bins), bins - 1)`` of the gradient
    length ``g = |d| / sqrt(d^2 + mu^2)`` (no gradient); the sum over
    ``tot``, the label weights' fp32 sum. The weights are fp32 as
    tpudet's; with a process group ``tot`` and the counts are summed over
    the ranks, as ``ghm_c_loss``'s."""
    diff = pred - target
    root = torch.sqrt(diff * diff + mu * mu)
    asl1 = root - mu
    g = (diff.abs() / root).detach()
    if label_weight is None:
        label_weight = torch.ones_like(pred)
    valid = label_weight > 0
    bin_id = torch.clamp_max((g * bins).to(torch.int32), bins - 1).long()
    counts = global_sum(torch.cat([
        label_weight.float().sum()[None],
        torch.bincount(torch.where(valid, bin_id, bins).reshape(-1),
                       minlength=bins + 1)[:bins].float()]))
    tot = torch.clamp_min(counts[0], 1.0)
    nonempty = torch.clamp_min((counts[1:] > 0).float().sum(), 1.0)
    w = torch.where(valid, tot / torch.clamp_min(counts[1:][bin_id], 1.0),
                    torch.zeros((), device=pred.device)) / nonempty
    return loss_weight * (asl1 * w).sum() / tot
