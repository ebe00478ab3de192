"""FSAF head: port of ``tpudet/models/dense_heads/fsaf_head.py``.

RetinaNet-style towers (``cls_conv{i}``, ``reg_conv{i}``), ``retina_cls``
(C outputs, the 0.01 prior bias) and ``retina_reg`` (bias 0.25), every
conv N(0, 0.01^2); the regression leaves through a ReLU (TBLR distances
are positive). One "anchor" a cell, a square of the level's stride; the
TBLR coder (``normalizer`` 4).

``loss`` (``fsaf_head.py:120-227``), the center-region assignment at every
level: an anchor whose centre lies strictly inside a gt and whose IoF with
the gt's ``pos_scale`` core exceeds 0.01 is a candidate positive of that
gt, the least-area candidate winning (the first on a tie); the gt's other
anchors of IoF over 0.01 with its ``neg_scale`` box, and the lost
candidates, shadow the gt's class there (ignored), and a winner whose own
class another gt shadows falls back to background. Online level
selection: each gt's anchors' elementwise loss (focal over the classes
not shadowed, plus ``-log(IoU)`` of the decoded box) is averaged per
level, and the gt keeps only the level of least mean (``argmin``, the
first on a tie); its positives elsewhere lose their box loss and their
class's focal term. Both losses are sums over the kept positives' count
(the negatives' if none), over every rank's batch.

``get_bboxes``: RetinaNet's per-level top ``nms_pre`` (ties by index),
the TBLR decode clipped to ``img_shape``, then ``batched_nms`` of the top
2048 pairs; ``with_nms=False`` adds a zero background column, as
tpudet's.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import AnchorGenerator
from ...core.bbox import (TBLRBBoxCoder, bbox_overlaps,
                          bbox_overlaps_aligned)
from ...parallel.mesh import global_count, global_sum
from ...registry import HEADS
from .. import losses as L
from .atss_head import (PRIOR_BIAS, LevelAnchors, anchor_centers,
                        finish_bboxes, flat, head_conv, no_dtype, num_gts,
                        topk_levels)
from .fcos_head import smallest_area_gt

MIN_POS_IOF = 0.01  # CenterRegionAssigner's min_pos_iof


def scale_box(gts, scale: float):
    """(..., 4) boxes shrunk about their centres to ``scale`` of their
    sides."""
    cx = (gts[..., 0] + gts[..., 2]) * 0.5
    cy = (gts[..., 1] + gts[..., 3]) * 0.5
    w = (gts[..., 2] - gts[..., 0]) * 0.5 * scale
    h = (gts[..., 3] - gts[..., 1]) * 0.5 * scale
    return torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)


@HEADS.register_module()
class FSAFHead(nn.Module):
    """The keyword arguments are tpudet's fields (``fsaf_head.py:38-49``)
    with its defaults."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 pos_scale: float = 0.2, neg_scale: float = 0.2,
                 normalizer: float = 4.0, focal_gamma: float = 2.0,
                 focal_alpha: float = 0.25, dtype=None):
        super().__init__()
        no_dtype('FSAFHead', dtype)
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.pos_scale = pos_scale
        self.neg_scale = neg_scale
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.bbox_coder = TBLRBBoxCoder(normalizer=normalizer)
        # one anchor a cell, as wide as the stride
        self.anchor_generator = AnchorGenerator(
            strides=list(self.strides), ratios=[1.0], octave_base_scale=1,
            scales_per_octave=1)
        self._anchors = LevelAnchors(self.anchor_generator)
        self.stacked_convs = stacked_convs
        for branch in ('cls', 'reg'):
            cin = in_channels
            for i in range(stacked_convs):
                self.add_module(f'{branch}_conv{i}',
                                head_conv(cin, feat_channels))
                cin = feat_channels
        self.retina_cls = head_conv(feat_channels, num_classes,
                                    bias_init=PRIOR_BIAS)
        self.retina_reg = head_conv(feat_channels, 4, bias_init=0.25)

    def forward(self, feats):
        """NCHW features -> (class logits, TBLR distances), per-level (B, H,
        W, attrib) tuples."""
        cls_out, reg_out = [], []
        for feat in feats:
            c = r = feat
            for i in range(self.stacked_convs):
                c = F.relu(getattr(self, f'cls_conv{i}')(c))
                r = F.relu(getattr(self, f'reg_conv{i}')(r))
            cls_out.append(self.retina_cls(c).permute(0, 2, 3, 1))
            reg_out.append(F.relu(self.retina_reg(r)).permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(reg_out)

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """``loss_cls``, ``loss_bbox``, ``num_pos`` (kept positives an
        image) and ``num_gts``, in fp32 or wider. gt_bboxes (B, G, 4)
        zero-padded xyxy, gt_labels (B, G), gt_valid (B, G)."""
        cls_scores, bbox_preds = preds
        _, anchors, counts = self._anchors(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        cls_flat = flat([c.float() for c in cls_scores], b, nc)
        reg_flat = torch.clamp_min(flat([r.float() for r in bbox_preds], b,
                                        4), 1e-4)
        gts = gt_bboxes.to(reg_flat.dtype)
        anchors = anchors.to(gts.dtype)
        valid = gt_valid[:, None, :]
        g = gts.shape[1]
        level = torch.repeat_interleave(
            torch.arange(len(counts), device=gts.device),
            torch.tensor(counts, device=gts.device))  # (A,)

        ctr = anchor_centers(anchors)
        cx, cy = ctr[None, :, 0, None], ctr[None, :, 1, None]
        in_gt = ((cx > gts[:, None, :, 0]) & (cx < gts[:, None, :, 2]) &
                 (cy > gts[:, None, :, 1]) & (cy < gts[:, None, :, 3]))
        iof_core = bbox_overlaps(anchors[None], scale_box(gts, self.pos_scale),
                                 mode='iof')  # (B, A, G)
        iof_shadow = bbox_overlaps(anchors[None],
                                   scale_box(gts, self.neg_scale), mode='iof')
        core = in_gt & (iof_core > MIN_POS_IOF) & valid
        shadow = (iof_shadow > MIN_POS_IOF) & ~core & valid
        area = (gts[..., 2] - gts[..., 0]) * (gts[..., 3] - gts[..., 1])
        win, pos = smallest_area_gt(core, area)  # (B, A)
        winner = F.one_hot(win, g).bool() & pos[..., None]
        # candidates that lost the contest shadow their gt's class too
        shadow = shadow | (core & ~winner)
        labels = L.one_hot(gt_labels.long(), nc, gts.dtype)  # (B, G, C)
        shadow_cls = torch.bmm(shadow.to(gts.dtype), labels) > 0  # (B, A, C)
        lab = torch.gather(gt_labels.long(), 1, win)
        # the override rule: a positive whose class another gt shadows is
        # background with that class ignored
        own = torch.gather(shadow_cls, 2, lab.clamp(0, nc - 1)[..., None])
        pos = pos & ~own[..., 0]

        onehot = L.one_hot(lab, nc, gts.dtype) * pos[..., None]
        cls_el = L.sigmoid_focal_loss(cls_flat, onehot,
                                      gamma=self.focal_gamma,
                                      alpha=self.focal_alpha,
                                      reduction='none')  # (B, A, C)
        cls_w = (~shadow_cls).to(gts.dtype)
        decoded = self.bbox_coder.decode(anchors[None], reg_flat)
        tgt = torch.gather(gts, 1, win[..., None].expand(-1, -1, 4))
        ious = bbox_overlaps_aligned(
            decoded, torch.where(pos[..., None], tgt, decoded))
        iou_el = torch.where(pos, -torch.log(torch.clamp_min(ious, 1e-6)),
                             torch.zeros_like(ious))

        # each gt's mean loss per level -> its best level
        per_gt = F.one_hot(win, g).to(gts.dtype) * pos[..., None]  # (B,A,G)
        lvl = F.one_hot(level, len(counts)).to(gts.dtype)  # (A, L)
        per_anchor = (cls_el * cls_w).sum(-1) + iou_el  # (B, A)
        num = torch.einsum('al,bag,ba->blg', lvl, per_gt, per_anchor)
        cnt = torch.einsum('al,bag->blg', lvl, per_gt)
        mean = torch.where(cnt > 0, num / torch.clamp_min(cnt, 1.),
                           torch.full_like(num, 1e6))
        best = mean.argmin(dim=1)  # (B, G), the first level on a tie
        keep = pos & (torch.gather(best, 1, win) == level)
        demoted = pos & ~keep
        cls_w = torch.where(demoted[..., None] & (onehot > 0),
                            torch.zeros_like(cls_w), cls_w)
        iou_el = torch.where(keep, iou_el, torch.zeros_like(iou_el))
        kept = keep.to(gts.dtype).sum()
        num_pos = global_sum(kept)
        n_neg = global_sum((~pos).to(gts.dtype).sum())
        avg = torch.clamp_min(torch.where(num_pos > 0, num_pos, n_neg), 1.0)
        return dict(loss_cls=(cls_el * cls_w).sum() / avg,
                    loss_bbox=iou_el.sum() / avg,
                    num_pos=kept / global_count(b, gts.device),
                    num_gts=num_gts(gt_valid))

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.5, max_per_img: int = 100,
                   nms_pre: int = 1000, img_shape=None, with_nms: bool = True,
                   **kwargs):
        """Decode and NMS (``fsaf_head.py:230-259``), batched, in fp32.
        ``img_shape`` is ``(h, w)``: numbers or per-image (B, 1) columns.
        Returns NMSResult, or with ``with_nms=False`` ``(boxes (B, N, 4),
        scores (B, N, C + 1))``."""
        cls_scores, bbox_preds = preds
        levels, _, _ = self._anchors(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        all_boxes, all_scores = [], []
        for lvl, anchors in enumerate(levels):
            scores = torch.sigmoid(cls_scores[lvl].reshape(b, -1, nc).float())
            reg = bbox_preds[lvl].reshape(b, -1, 4).float()
            n = scores.shape[1]
            k = min(nms_pre, n) if with_nms else 0
            if 0 < k < n:
                scores, reg, anchors = topk_levels(scores, k, reg, anchors)
            else:
                anchors = anchors[None].expand(b, -1, -1)
            all_boxes.append(self.bbox_coder.decode(anchors, reg,
                                                    max_shape=img_shape))
            all_scores.append(scores)
        out = finish_bboxes(all_boxes, all_scores, scale_factors, score_thr,
                            iou_thr, max_per_img, with_nms)
        return out if with_nms else (out[0], F.pad(out[1], (0, 1)))
