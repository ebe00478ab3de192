"""FreeAnchor's RetinaNet head: port of
``tpudet/models/dense_heads/free_anchor_retina_head.py``.

``RetinaHead``'s towers, anchors and decode with the recipe's coder stds
(0.1, 0.1, 0.2, 0.2), and the learning-to-match loss (``:40-114``), an
image at a time:

- each gt's bag: the ``pre_anchor_topk`` anchors of highest IoU with it
  (ties to the lower index: a stable sort, as ``lax.top_k``'s order);
  the bag's probability is the mean-max (weights ``1 / (1 - p)``) of
  ``p = P(class) * exp(-0.75 smooth_l1(delta - encode(anchor, gt)))``;
  the positive loss ``-alpha log`` of it, over the count of gts;
- every (anchor, class) is a negative of probability ``P(class) (1 -
  P(anchor in A+))``, the latter the largest over the gts of that class of
  a saturated-linear map of the decoded box's IoU (held constant), with the
  focal modulation ``(1 - alpha) p^gamma``, over ``gts * topk``.

tpudet takes that largest value as a max over a (G, A, C) product of the
(G, A) IoU map and the gts' one-hot classes: 13 GB of fp32 an image at
1344^2 with 120 gts and 80 classes. The port scatters each gt's (A,) row
into its class with ``scatter_reduce(..., 'amax')`` instead, a (C, A)
buffer: the same maximum, value for value.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from ...core.bbox import bbox_overlaps
from ...core.nms import topk_scores
from ...parallel.mesh import global_count, global_sum
from ...registry import HEADS
from .retina_head import RetinaHead

EPS = 1e-12


@HEADS.register_module()
class FreeAnchorRetinaHead(RetinaHead):
    """``RetinaHead``'s keyword arguments (its coder's stds default to the
    recipe's) and tpudet's bag fields (``free_anchor_retina_head.py:
    30-39``)."""

    def __init__(self, num_classes: int, pre_anchor_topk: int = 50,
                 bbox_thr: float = 0.6, bag_gamma: float = 2.0,
                 bag_alpha: float = 0.5, smooth_l1_beta: float = 0.11,
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 **kwargs):
        super().__init__(num_classes, target_stds=target_stds, **kwargs)
        self.pre_anchor_topk = pre_anchor_topk
        self.bbox_thr = bbox_thr
        self.bag_gamma = bag_gamma
        self.bag_alpha = bag_alpha
        self.smooth_l1_beta = smooth_l1_beta

    def _image_loss(self, cls_p, reg_p, anchors, gts, labels, valid, k):
        """One image: (positive bag loss summed over its gts, negative loss
        summed over its (anchor, class) pairs)."""
        nc = self.num_classes
        labels = labels.clamp(0, nc - 1)  # padding: jnp's clamped gather
        with torch.no_grad():
            boxes = self.bbox_coder.decode(anchors, reg_p)
            iou = bbox_overlaps(gts, boxes)  # (G, A)
            iou = torch.where(valid[:, None], iou, torch.zeros_like(iou))
            t1 = self.bbox_thr
            t2 = torch.clamp_min(iou.amax(dim=1, keepdim=True), t1 + EPS)
            obj = torch.clamp((iou - t1) / (t2 - t1), 0., 1.)
            obj = torch.where(valid[:, None], obj, torch.zeros_like(obj))
            image_box_prob = torch.zeros(
                (nc, obj.shape[1]), dtype=obj.dtype,
                device=obj.device).scatter_reduce_(
                0, labels[:, None].expand_as(obj), obj, 'amax').t()
            _, matched = topk_scores(bbox_overlaps(gts, anchors), k)  # (G, K)

        m_cls_prob = cls_p[matched, labels[:, None]]  # (G, K)
        m_anchors = anchors[matched]
        # padded gts are empty: encode against the anchor itself (delta 0)
        gt_safe = torch.where(valid[:, None, None], gts[:, None, :].expand_as(
            m_anchors), m_anchors)
        diff = (reg_p[matched] - self.bbox_coder.encode(m_anchors, gt_safe)
                ).abs()
        beta = self.smooth_l1_beta
        sl1 = torch.where(diff < beta, 0.5 * diff * diff / beta,
                          diff - 0.5 * beta).sum(-1) * 0.75
        m_prob = m_cls_prob * torch.exp(-sl1)
        w = 1.0 / torch.clamp_min(1.0 - m_prob, EPS)
        w = w / w.sum(dim=1, keepdim=True)
        bag = (w * m_prob).sum(dim=1)
        pos = -self.bag_alpha * torch.log(torch.clamp(bag, EPS, 1 - EPS))
        pos = torch.where(valid, pos, torch.zeros_like(pos)).sum()

        prob = torch.clamp(cls_p * (1 - image_box_prob), EPS, 1 - EPS)
        neg = (1 - self.bag_alpha) * prob ** self.bag_gamma * (
            -torch.log1p(-prob))
        return pos, neg.sum()

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """``positive_bag_loss``, ``negative_bag_loss`` and ``num_gts``, in
        fp32 or wider. gt_bboxes (B, G, 4) zero-padded xyxy, gt_labels (B,
        G), gt_valid (B, G)."""
        cls_scores, bbox_preds = preds
        _, anchors = self._anchors(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        k = min(self.pre_anchor_topk, anchors.shape[0])
        cls_prob = torch.sigmoid(torch.cat(
            [c.reshape(b, -1, nc).float() for c in cls_scores], dim=1))
        reg_flat = torch.cat([r.reshape(b, -1, 4).float()
                              for r in bbox_preds], dim=1)
        gts = gt_bboxes.to(reg_flat.dtype)
        anchors = anchors.to(gts.dtype)
        pos, neg = zip(*(self._image_loss(
            cls_prob[i], reg_flat[i], anchors, gts[i], gt_labels[i].long(),
            gt_valid[i], k) for i in range(b)))
        n_gt = gt_valid.to(gts.dtype).sum()
        num_pos = torch.clamp_min(global_sum(n_gt), 1.0)
        return dict(positive_bag_loss=sum(pos) / num_pos,
                    negative_bag_loss=sum(neg) / (num_pos * k),
                    num_gts=n_gt / global_count(b, gts.device))
