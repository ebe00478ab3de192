"""PAA head: port of ``tpudet/models/dense_heads/paa_head.py``.

Probabilistic anchor assignment on the ATSS head (``atss_centerness`` is
PAA's IoU branch):

1. loose candidates: every anchor MaxIoU-assigned at 0.1 / 0.1 (no
   minimum for the low-quality claim);
2. each candidate's loss, without gradient: the focal loss summed over
   the classes plus ``loss_bbox_weight`` x (1 - GIoU) of its decoded box;
3. per image and gt, the ``paa_topk`` lowest-loss candidates of each level
   (ties by index), sorted by loss (a stable sort), a two-component 1-D
   Gaussian mixture fitted to their losses (``gmm_em_1d``), and the sorted
   prefix up to the best-scoring sample of the lower-mean component kept
   positive; a gt with fewer than 2 candidates keeps none;
4. losses: focal over every anchor (over ``max(num_pos, images)``), GIoU
   of the positives weighted by their IoU target (over its sum) and BCE
   of the IoU branch to that target (over ``num_pos``). Every denominator
   counts every rank's batch.

``get_bboxes``: ``sqrt(class probability x IoU probability)``, the top
``nms_pre`` of each level by their best score (ties by index), the deltas
decoded (not clipped, as tpudet's), then ``batched_nms`` of the top 2048
(box, class) pairs.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ...core.assigners import max_iou_assign_batch
from ...core.bbox import bbox_overlaps_aligned
from ...parallel.mesh import global_count, global_sum
from ...registry import HEADS
from .. import losses as L
from .atss_head import (ATSSHead, finish_bboxes, flat, matched_boxes,
                        num_gts, topk_levels)

INF = 1e8
EPS = 1e-8
# the EM loop reads its active mask on the host once in this many
# iterations: one sync a few iterations instead of one each
EM_CHECK_EVERY = 4


class GMMResult(NamedTuple):
    means: torch.Tensor       # (..., 2), the lower mean first
    assign: torch.Tensor      # (..., K) int64, 0 = the lower-mean component
    score: torch.Tensor       # (..., K) the mixture's log-likelihood
    iterations: torch.Tensor  # (...,) int64, EM iterations run


def gmm_em_1d(x, valid, iters: int = 100, tol: float = 1e-3,
              reg_covar: float = 1e-6) -> GMMResult:
    """Two-component 1-D EM on masked data, batched over the leading axes
    of ``x`` and ``valid`` (..., K), as tpudet's ``gmm_em_1d``
    (``paa_head.py:35-87``) runs under ``vmap``: sklearn's
    ``GaussianMixture`` as tpudet writes it. Means start at the valid
    min and max, variances at 1, weights at 0.5; ``reg_covar`` is added
    to each M-step variance; an element stops once its mean log-likelihood
    moves by less than ``tol``, after at most ``iters`` iterations (at
    least 2: the bounds start at +inf and -inf), or at a NaN bound, and
    keeps its state while the others iterate. The active mask is read on
    the host every ``EM_CHECK_EVERY`` iterations, so up to that many
    iterations run with every element stopped. Component 0 is the one of
    lower mean (on a tie the first)."""
    v = valid.to(x.dtype)
    n = torch.clamp_min(v.sum(-1), 1.0)
    inf = torch.full_like(x, INF)
    mean = torch.stack([torch.where(valid, x, inf).amin(-1),
                        torch.where(valid, x, -inf).amax(-1)], -1)
    var = torch.ones_like(mean)
    w = torch.full_like(mean, 0.5)
    lb_prev = torch.full_like(n, math.inf)
    lb_cur = torch.full_like(n, -math.inf)
    it = torch.zeros(n.shape, dtype=torch.long, device=x.device)
    xs = x[..., None]

    def e_logp(mean, var, w):  # (..., K, 2)
        mean, var, w = mean[..., None, :], var[..., None, :], w[..., None, :]
        return (-0.5 * (xs - mean)**2 / var -
                0.5 * torch.log(2 * math.pi * var) +
                torch.log(torch.clamp_min(w, EPS)))

    def running():
        return (it < iters) & ((lb_cur - lb_prev).abs() >= tol)

    active = running()
    for step in range(iters):
        if step % EM_CHECK_EVERY == 0 and not bool(active.any()):
            break
        logp = e_logp(mean, var, w)
        lb_new = (torch.logsumexp(logp, -1) * v).sum(-1) / n
        r = F.softmax(logp, -1) * v[..., None]
        nk = torch.clamp_min(r.sum(-2), EPS)
        new_mean = (r * xs).sum(-2) / nk
        new_var = (r * (xs - new_mean[..., None, :])**2).sum(-2) / nk + \
            reg_covar
        a = active[..., None]
        mean = torch.where(a, new_mean, mean)
        var = torch.where(a, new_var, var)
        w = torch.where(a, nk / n[..., None], w)
        lb_prev = torch.where(active, lb_cur, lb_prev)
        lb_cur = torch.where(active, lb_new, lb_cur)
        it = it + active.long()
        active = active & running()
    logp = e_logp(mean, var, w)
    swap = mean[..., 0] > mean[..., 1]  # argsort of the two, stable
    logp = torch.where(swap[..., None, None], logp.flip(-1), logp)
    mean = torch.where(swap[..., None], mean.flip(-1), mean)
    return GMMResult(mean, logp.argmax(-1), torch.logsumexp(logp, -1), it)


@HEADS.register_module()
class PAAHead(ATSSHead):
    """The keyword arguments are tpudet's fields (``paa_head.py:90-98``):
    the ATSS head's, with the published recipe's loss weights (box 1.3,
    IoU 0.5), the candidates' MaxIoU threshold and the candidates a
    level."""

    def __init__(self, num_classes: int, loss_bbox_weight: float = 1.3,
                 loss_iou_weight: float = 0.5,
                 pos_iou_thr_init: float = 0.1, paa_topk: int = 9,
                 **kwargs):
        super().__init__(num_classes, loss_bbox_weight=loss_bbox_weight,
                         **kwargs)
        self.loss_iou_weight = loss_iou_weight
        self.pos_iou_thr_init = pos_iou_thr_init
        self.paa_topk = paa_topk

    def candidate_losses(self, cls_flat, pred_boxes, anchors, gt_bboxes,
                         gt_labels, gt_valid):
        """The loose assignment and each anchor's candidate loss:
        (assigned (B, A) codes, their labels, their gts' boxes, the loss
        (B, A) without gradient)."""
        thr = self.pos_iou_thr_init
        assigned = max_iou_assign_batch(anchors, gt_bboxes, gt_valid, thr,
                                        thr, 0.0, True)
        cand = assigned >= 0
        gt_idx = assigned.clamp_min(0)
        matched = matched_boxes(gt_bboxes, gt_idx)
        lab = torch.gather(gt_labels.long(), 1, gt_idx)
        with torch.no_grad():
            el_cls = L.sigmoid_focal_loss(
                cls_flat, L.one_hot(lab, self.num_classes, cls_flat.dtype),
                gamma=self.focal_gamma, alpha=self.focal_alpha,
                reduction='none').sum(-1)
            el_box = self.loss_bbox_weight * (1.0 - bbox_overlaps_aligned(
                pred_boxes, torch.where(cand[..., None], matched, pred_boxes),
                mode='giou'))
        return assigned, lab, matched, el_cls + el_box

    def positives(self, loss, assigned, counts: Sequence[int],
                  num_gts_padded: int):
        """PAA's positives (B, A) from the candidates' losses (B, A) and
        the loose codes (``paa_head.py:150-172``), and the EM's
        ``GMMResult`` over (B, G)."""
        b, _ = loss.shape
        k = self.paa_topk
        gts = torch.arange(num_gts_padded, device=loss.device)
        mine = assigned[:, None, :] == gts[None, :, None]  # (B, G, A)
        masked = torch.where(mine, loss[:, None, :],
                             torch.full_like(loss, INF)[:, None, :])
        losses, idxs = [], []
        start = 0
        for count in counts:  # the k lowest of each level, ties by index
            vals, order = torch.sort(masked[..., start:start + count],
                                     dim=-1, stable=True)
            losses.append(vals[..., :k])
            idxs.append(order[..., :k] + start)
            start += count
        losses, idxs = torch.cat(losses, -1), torch.cat(idxs, -1)
        valid = losses < INF / 2
        s_losses, order = torch.sort(
            torch.where(valid, losses, torch.full_like(losses, INF)), dim=-1,
            stable=True)
        s_valid = torch.gather(valid, -1, order)
        s_idxs = torch.gather(idxs, -1, order)
        gmm = gmm_em_1d(torch.where(s_valid, s_losses,
                                    torch.zeros_like(s_losses)), s_valid)
        comp0 = (gmm.assign == 0) & s_valid
        best = torch.where(comp0, gmm.score,
                           torch.full_like(gmm.score, -INF)).argmax(-1)
        rank = torch.arange(comp0.shape[-1], device=loss.device)
        keep = (comp0 & (rank <= best[..., None]) &
                comp0.any(-1, keepdim=True) &
                (valid.sum(-1, keepdim=True) >= 2))
        # an amax scatter: the slots of a level short of k candidates
        # repeat indices, with keep False
        pos = torch.zeros_like(loss).scatter_reduce(
            1, s_idxs.reshape(b, -1), keep.reshape(b, -1).to(loss.dtype),
            'amax')
        return pos > 0, gmm

    def assign(self, preds, gt_bboxes, gt_labels, gt_valid):
        """The flattened fp32 maps and PAA's assignment: ``(cls_flat (B,
        A, C), iou_flat (B, A), pred_boxes (B, A, 4), pos (B, A), the
        candidates' labels (B, A), their gts' boxes (B, A, 4), the EM's
        GMMResult over (B, G))``."""
        cls_scores, bbox_preds, iou_preds = preds
        _, anchors, counts = self._anchors(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        cls_flat = flat([c.float() for c in cls_scores], b, nc)
        reg_flat = flat([r.float() for r in bbox_preds], b, 4)
        iou_flat = flat([c.float() for c in iou_preds], b, 1)[..., 0]
        gt_bboxes = gt_bboxes.float()
        pred_boxes = self.bbox_coder.decode(anchors[None], reg_flat)
        assigned, lab, matched, cand_loss = self.candidate_losses(
            cls_flat, pred_boxes, anchors, gt_bboxes, gt_labels, gt_valid)
        # the EM in the model's dtype: fp32, or float64 in a float64 model,
        # as tpudet's runs in its default float (float64 under x64)
        pos, gmm = self.positives(
            cand_loss.to(torch.promote_types(self.scales.dtype,
                                             torch.float32)),
            assigned, counts, gt_bboxes.shape[1])
        return cls_flat, iou_flat, pred_boxes, pos, lab, matched, gmm

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """``loss_cls``, ``loss_bbox``, ``loss_iou`` and ``num_gts``
        (``paa_head.py:100-192``), in fp32 or wider. gt_bboxes (B, G, 4)
        zero-padded xyxy, gt_labels (B, G), gt_valid (B, G)."""
        cls_flat, iou_flat, pred_boxes, pos, lab, matched, _ = self.assign(
            preds, gt_bboxes, gt_labels, gt_valid)
        b, nc = cls_flat.shape[0], self.num_classes
        num_pos = torch.clamp_min(global_sum(pos.float().sum()), 1.0)
        labels = torch.where(pos, lab, nc)
        loss_cls = L.sigmoid_focal_loss(
            cls_flat, L.one_hot(labels, nc, cls_flat.dtype),
            gamma=self.focal_gamma, alpha=self.focal_alpha,
            avg_factor=torch.maximum(num_pos, global_count(b, pos.device)))
        target = torch.where(pos[..., None], matched, pred_boxes)
        iou_tgt = torch.clamp_min(bbox_overlaps_aligned(pred_boxes, target),
                                  EPS).detach() * pos
        loss_bbox = L.giou_loss(
            pred_boxes, target, weight=iou_tgt,
            avg_factor=torch.clamp_min(global_sum(iou_tgt.sum()), EPS),
            loss_weight=self.loss_bbox_weight)
        loss_iou = L.bce_loss(iou_flat, iou_tgt, weight=pos.float(),
                              avg_factor=num_pos,
                              loss_weight=self.loss_iou_weight)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_iou=loss_iou, num_gts=num_gts(gt_valid))

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.6, max_per_img: int = 100,
                   nms_pre: int = 1000, with_nms: bool = True, **kwargs):
        """Decode and NMS (``paa_head.py:195-244``), batched, in fp32; the
        boxes are not clipped (``img_shape`` is ignored, as tpudet ignores
        it). Returns NMSResult, or with ``with_nms=False`` ``(boxes (B, N,
        4), scores (B, N, C))``."""
        cls_scores, bbox_preds, iou_preds = preds
        levels, _, _ = self._anchors(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        all_boxes, all_scores = [], []
        for lvl, anchors in enumerate(levels):
            scores = torch.sigmoid(cls_scores[lvl].reshape(b, -1, nc).float())
            iou_p = torch.sigmoid(iou_preds[lvl].reshape(b, -1).float())
            scores = torch.sqrt(torch.clamp(scores * iou_p[..., None], 0., 1.))
            deltas = bbox_preds[lvl].reshape(b, -1, 4).float()
            n = scores.shape[1]
            k = min(nms_pre, n) if with_nms else 0
            if 0 < k < n:
                scores, deltas, lvl_anchors = topk_levels(scores, k, deltas,
                                                          anchors)
            else:
                lvl_anchors = anchors[None].expand(b, -1, -1)
            all_boxes.append(self.bbox_coder.decode(lvl_anchors, deltas))
            all_scores.append(scores)
        return finish_bboxes(all_boxes, all_scores, scale_factors, score_thr,
                             iou_thr, max_per_img, with_nms)
