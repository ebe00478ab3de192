"""RepPoints head: port of ``tpudet/models/dense_heads/reppoints_head.py``
(``RepPointsHead``).

Towers of ``stacked_convs`` bias-free 3x3 convs (N(0, 0.01^2)), flax's
``GroupNorm(32)`` (eps 1e-6) and ReLU (``cls{i}_conv``, ``cls{i}_gn``,
``reg{i}_...``). On the regression tower ``pts_init_conv`` (3x3) and
``pts_init_out`` (1x1) predict the 9 init points, y-first offsets in
strides, rounded to fp32. Their ``gradient_mul`` mix (0.1 of the gradient
reaches the init points) less the regular 3x3 grid drives two v1
deformable convs (``ops/deform_conv.DeformConv2d``, fp32): ``cls_dcn`` on
the class tower, then ``cls_out`` (the 0.01 prior bias), and
``refine_dcn`` on the regression tower, then ``refine_out``, whose points
add to the detached init points.

Each point set becomes a box by the moment transform: the points' mean
plus and minus their unbiased std (1e-12 inside the sqrt) times
``exp(moment_transfer)``, the learned (2,) leaf (0 at tpudet's init) of
which ``moment_mul`` of the gradient flows. The forward returns the
per-level class logits (B, H, W, C) and both stages' boxes in image
pixels, (B, H W, 4), in the promotion of fp32 and the leaf's dtype.

``loss`` (``reppoints_head.py:216-269``): the init boxes are assigned by
the point assigner (``core/assigners.point_assign_batch``), the refined
ones by MaxIoU over the detached init boxes (0.5 / 0.4, every gt's best
box claimed); each stage's smooth L1 (beta 0.11) of boxes divided by
``point_base_scale * stride`` over its positives (weights 0.5 and 1),
the focal loss over the refine stage's positives and negatives, each
count summed over the ranks.

``get_bboxes``: sigmoid scores, the refined boxes clipped to
``img_shape`` where given, the top ``nms_pre`` of each level by the best
class (ties by index), then ``batched_nms`` of the top 2048 pairs.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import (NEGATIVE, max_iou_assign_batch,
                               point_assign_batch)
from ...core.bbox import _clip_to
from ...ops.deform_conv import DeformConv2d
from ...parallel.mesh import global_sum
from ...registry import HEADS
from .. import losses as L
from ..layers import Conv
from ..plugins import GroupNorm
from .atss_head import (finish_bboxes, flat, matched_boxes, no_dtype,
                        num_gts, topk_levels)

GN_GROUPS, GN_EPS = 32, 1e-6  # flax's nn.GroupNorm defaults


def _normal_conv(cin, cout, k, bias=True, bias_init=0.):
    return Conv(cin, cout, k, 1, k // 2, bias=bias,
                kernel_init=('normal', 0.01), bias_init=bias_init)


@HEADS.register_module()
class RepPointsHead(nn.Module):
    """The keyword arguments are tpudet's fields
    (``reppoints_head.py:41-63``) with its defaults."""

    flax_leaves = {'moment_transfer': ('moment_transfer', '')}

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, num_points: int = 9,
                 gradient_mul: float = 0.1, point_base_scale: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 moment_mul: float = 0.01, init_pos_num: int = 1,
                 init_assign_scale: int = 4, refine_pos_iou: float = 0.5,
                 refine_neg_iou: float = 0.4, focal_gamma: float = 2.0,
                 focal_alpha: float = 0.25, loss_init_weight: float = 0.5,
                 loss_refine_weight: float = 1.0,
                 smooth_l1_beta: float = 0.11, dtype=None):
        super().__init__()
        no_dtype('RepPointsHead', dtype)
        self.num_classes = num_classes
        self.num_points = num_points
        self.gradient_mul = gradient_mul
        self.point_base_scale = point_base_scale
        self.strides = tuple(strides)
        self.moment_mul = moment_mul
        self.init_pos_num = init_pos_num
        self.init_assign_scale = init_assign_scale
        self.refine_pos_iou = refine_pos_iou
        self.refine_neg_iou = refine_neg_iou
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.loss_init_weight = loss_init_weight
        self.loss_refine_weight = loss_refine_weight
        self.smooth_l1_beta = smooth_l1_beta
        self.stacked_convs = stacked_convs
        k = self.dcn_kernel = int(np.sqrt(num_points))
        for branch in ('cls', 'reg'):
            cin = in_channels
            for i in range(stacked_convs):
                self.add_module(f'{branch}{i}_conv', _normal_conv(
                    cin, feat_channels, 3, bias=False))
                self.add_module(f'{branch}{i}_gn', GroupNorm(
                    GN_GROUPS, feat_channels, eps=GN_EPS))
                cin = feat_channels
        self.pts_init_conv = _normal_conv(feat_channels, point_feat_channels,
                                          3)
        self.pts_init_out = _normal_conv(point_feat_channels, 2 * num_points,
                                         1)
        self.cls_dcn = DeformConv2d(feat_channels, point_feat_channels, k)
        self.cls_out = _normal_conv(point_feat_channels, num_classes, 1,
                                    bias_init=float(-math.log(0.99 / 0.01)))
        self.refine_dcn = DeformConv2d(feat_channels, point_feat_channels, k)
        self.refine_out = _normal_conv(point_feat_channels, 2 * num_points, 1)
        self.moment_transfer = nn.Parameter(torch.zeros(2))
        # the regular grid's (dy, dx) a tap, row-major (reppoints_head.py:
        # 65-73)
        pad = (k - 1) // 2
        base = np.arange(-pad, pad + 1, dtype=np.float32)
        self.register_buffer('base_offset', torch.tensor(np.stack(
            [np.repeat(base, k), np.tile(base, k)], 1).reshape(-1)),
            persistent=False)
        self._grids: Dict = {}

    def _tower(self, branch, x):
        for i in range(self.stacked_convs):
            x = F.relu(getattr(self, f'{branch}{i}_gn')(
                getattr(self, f'{branch}{i}_conv')(x)))
        return x

    def points2bbox(self, pts, moment):
        """(..., 2P) y-first offsets -> (..., 4) moment boxes."""
        pts = pts.to(torch.promote_types(pts.dtype, moment.dtype))
        p = pts.unflatten(-1, (self.num_points, 2))
        py, px = p[..., 0], p[..., 1]
        my = py.mean(-1, keepdim=True)
        mx = px.mean(-1, keepdim=True)
        n1 = float(self.num_points - 1)
        sy = torch.sqrt((py - my).square().sum(-1, keepdim=True) / n1 + 1e-12)
        sx = torch.sqrt((px - mx).square().sum(-1, keepdim=True) / n1 + 1e-12)
        hw = sx * torch.exp(moment[0])
        hh = sy * torch.exp(moment[1])
        return torch.cat([mx - hw, my - hh, mx + hw, my + hh], dim=-1)

    def forward(self, feats):
        """NCHW features -> (per-level class logits (B, H, W, C), init
        boxes (B, H W, 4), refined boxes (B, H W, 4))."""
        m = self.moment_transfer
        moment = m * self.moment_mul + m.detach() * (1 - self.moment_mul)
        gm = self.gradient_mul
        base = self.base_offset.view(1, -1, 1, 1)
        cls_scores, init_boxes, refine_boxes = [], [], []
        for lvl, x in enumerate(feats):
            s = self.strides[lvl]
            b, _, h, w = x.shape
            c = self._tower('cls', x)
            r = self._tower('reg', x)
            pts_init = self.pts_init_out(F.relu(self.pts_init_conv(r))
                                         ).float()  # (B, 2P, H, W)
            dcn_off = (1 - gm) * pts_init.detach() + gm * pts_init - base
            cls = self.cls_out(F.relu(self.cls_dcn(c, dcn_off)).to(c.dtype))
            pts_refine = self.refine_out(F.relu(self.refine_dcn(
                r, dcn_off)).to(r.dtype)).float() + pts_init.detach()
            cls_scores.append(cls.permute(0, 2, 3, 1))
            center = self._center(h, w, s, x.device)
            for out, pts in ((init_boxes, pts_init),
                             (refine_boxes, pts_refine)):
                flat_pts = pts.permute(0, 2, 3, 1).reshape(b, h * w, -1)
                out.append(self.points2bbox(flat_pts, moment) * s + center)
        return tuple(cls_scores), tuple(init_boxes), tuple(refine_boxes)

    def _center(self, h, w, s, device):
        """(H W, 4) fp32 (x, y, x, y) of each cell's corner in pixels."""
        cx = torch.arange(w, dtype=torch.float32, device=device).repeat(h) * s
        cy = torch.arange(h, dtype=torch.float32,
                          device=device).repeat_interleave(w) * s
        return torch.stack([cx, cy, cx, cy], dim=-1)

    def _points(self, cls_scores):
        """All levels' points (P, 2), their level ids log2(stride) (P,) and
        strides (P,), on the maps' device (cached)."""
        sizes = tuple(tuple(c.shape[1:3]) for c in cls_scores)
        dev = cls_scores[0].device
        key = (sizes, dev)
        if key not in self._grids:
            pts, lvls, strides = [], [], []
            for (h, w), s in zip(sizes, self.strides):
                pts.append(np.stack([np.tile(np.arange(w, dtype=np.float32),
                                             h) * s,
                                     np.repeat(np.arange(h, dtype=np.float32),
                                               w) * s], -1))
                lvls.append(np.full(h * w, int(np.log2(s)), np.int64))
                strides.append(np.full(h * w, s, np.float32))
            self._grids[key] = tuple(torch.from_numpy(np.concatenate(a)).to(
                dev) for a in (pts, lvls, strides))
        return self._grids[key]

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """The two stages' box losses and the focal loss
        (``reppoints_head.py:216-269``)."""
        cls_scores, init_boxes, refine_boxes = preds
        points, lvl_ids, strides = self._points(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        cls_flat = flat([c.float() for c in cls_scores], b, nc)
        bi_flat = torch.cat(init_boxes, dim=1)
        br_flat = torch.cat(refine_boxes, dim=1)
        gt_bboxes = gt_bboxes.float()
        norm = (self.point_base_scale * strides)[None, :, None]
        a_init = point_assign_batch(
            points, lvl_ids, gt_bboxes, gt_valid,
            int(np.log2(self.strides[0])), int(np.log2(self.strides[-1])),
            self.init_assign_scale, self.init_pos_num)
        a_refine = max_iou_assign_batch(bi_flat.detach(), gt_bboxes, gt_valid,
                                        self.refine_pos_iou,
                                        self.refine_neg_iou, 0.0, True)

        def stage_loss(assigned, box_pred, weight):
            pos = assigned >= 0
            num_pos = torch.clamp_min(global_sum(pos.float().sum()), 1.0)
            tgt = torch.where(pos[..., None],
                              matched_boxes(gt_bboxes, assigned.clamp_min(0)),
                              box_pred)
            return L.smooth_l1_loss(
                box_pred / norm, tgt / norm, beta=self.smooth_l1_beta,
                weight=pos[..., None].float(), avg_factor=num_pos,
                loss_weight=weight), num_pos

        loss_init, _ = stage_loss(a_init, bi_flat, self.loss_init_weight)
        loss_refine, num_pos_r = stage_loss(a_refine, br_flat,
                                            self.loss_refine_weight)
        pos_r = a_refine >= 0
        neg_r = a_refine == NEGATIVE
        labels = torch.gather(gt_labels.long(), 1, a_refine.clamp_min(0))
        onehot = L.one_hot(labels, nc, torch.float32) * pos_r[..., None]
        loss_cls = L.sigmoid_focal_loss(
            cls_flat, onehot, gamma=self.focal_gamma, alpha=self.focal_alpha,
            weight=(pos_r | neg_r)[..., None].float(), avg_factor=num_pos_r)
        return dict(loss_cls=loss_cls, loss_pts_init=loss_init,
                    loss_pts_refine=loss_refine, num_gts=num_gts(gt_valid))

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.5, max_per_img: int = 100,
                   nms_pre: int = 1000, img_shape=None, with_nms: bool = True,
                   **kwargs):
        """NMS over the refined boxes (``reppoints_head.py:272-307``);
        ``img_shape`` is ``(h, w)``: numbers or per-image (B, 1) columns.
        Returns NMSResult, or with ``with_nms=False`` ``(boxes, scores (B,
        N, C))``."""
        cls_scores, _, refine_boxes = preds
        b = cls_scores[0].shape[0]
        all_boxes, all_scores = [], []
        for cls, boxes in zip(cls_scores, refine_boxes):
            scores = torch.sigmoid(cls.reshape(b, -1, self.num_classes).float())
            if img_shape is not None:
                h, w = img_shape
                boxes = torch.stack([_clip_to(boxes[..., 0], w),
                                     _clip_to(boxes[..., 1], h),
                                     _clip_to(boxes[..., 2], w),
                                     _clip_to(boxes[..., 3], h)], dim=-1)
            n = scores.shape[1]
            k = min(nms_pre, n) if with_nms else 0
            if 0 < k < n:
                scores, boxes = topk_levels(scores, k, boxes)
            all_boxes.append(boxes)
            all_scores.append(scores)
        return finish_bboxes(all_boxes, all_scores, scale_factors, score_thr,
                             iou_thr, max_per_img, with_nms)
