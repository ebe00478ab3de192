"""AutoAssign head and detector: port of
``tpudet/models/dense_heads/autoassign_head.py`` (``AutoAssignHead``,
``AutoAssign``).

Towers of ``stacked_convs`` bias-free 3x3 convs (N(0, 0.01^2)), flax's
``GroupNorm(32)`` (eps 1e-6) and ReLU (``cls{i}_conv``, ``cls{i}_gn``,
``reg{i}_...``); ``conv_cls`` (the 0.02 prior bias), ``conv_reg`` (bias
4: large boxes at the start) and ``conv_objectness`` on the regression
tower. The distances are ``relu(scales[lvl] * x) * stride`` in fp32; the
learned per-class centre prior (``center_mean`` (C, 2) at 0,
``center_sigma`` (C, 2) at 1, in strides) leaves the head with the pred
maps, in fp32, so that the loss reaches it.

``loss`` (``autoassign_head.py:134-246``), over every point (at ``i *
stride``, no half-stride offset) and gt: the Gaussian prior of the gt's
class at the point, kept inside the gt; the positive loss of a gt is
``-log`` of the confidence-weighted mean of ``p_cls * exp(-5 (1 -
GIoU))`` over the points, weighted ``exp(3 p) * prior``; the negative loss
is ``z^2 (-log(1 - z))`` of every (point, class) with ``z`` the joint
probability times ``1 - discount``, the discount the min-max normalised
``1 / (1 - IoU)`` (held constant; the IoU is the point's largest over the
gts) of the highest-indexed gt of that class that contains the point (a
rank scatter-max, as tpudet's); the centre loss ``num_gt / sum(prior)`` an
image. Weights 0.25, 0.75, 0.75; the positive loss over the count of gts,
the negative over the prior's sum (through which the gradient flows, on
every rank: ``global_sum_with_grad``), the centre loss a mean over the
images.

``get_bboxes``: class probability times objectness, the top ``nms_pre``
of each level (ties by index), the distances decoded (not clipped), then
``batched_nms`` of the top 2048 pairs; no ``with_nms=False`` path, as
tpudet's.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox import bbox_overlaps_aligned
from ...parallel.mesh import global_count, global_sum, global_sum_with_grad
from ...registry import DETECTORS, HEADS
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv
from ..plugins import GroupNorm
from .atss_head import finish_bboxes, flat, head_conv, no_dtype, topk_levels
from .fcos_head import PointCache, distance_boxes

EPS = 1e-12
GN_GROUPS, GN_EPS = 32, 1e-6  # flax's nn.GroupNorm defaults


def corner_points(featmap_size, stride) -> np.ndarray:
    """(H*W, 2) fp32 points at ``i * stride`` (AutoAssign removes FCOS's
    half-stride offset), x fastest."""
    h, w = featmap_size
    xs = np.arange(w, dtype=np.float32) * stride
    ys = np.arange(h, dtype=np.float32) * stride
    return np.stack([np.tile(xs, h), np.repeat(ys, w)], axis=-1)


@HEADS.register_module()
class AutoAssignHead(nn.Module):
    """The keyword arguments are tpudet's fields
    (``autoassign_head.py:37-47``) with its defaults."""

    flax_leaves = {'scales': ('scales', ''),
                   'center_mean': ('center_mean', ''),
                   'center_sigma': ('center_sigma', '')}
    leaf_init = {'scales': 1.0, 'center_mean': 0.0, 'center_sigma': 1.0}

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 pos_loss_weight: float = 0.25, neg_loss_weight: float = 0.75,
                 center_loss_weight: float = 0.75,
                 reg_loss_weight: float = 5.0, dtype=None):
        super().__init__()
        no_dtype('AutoAssignHead', dtype)
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.pos_loss_weight = pos_loss_weight
        self.neg_loss_weight = neg_loss_weight
        self.center_loss_weight = center_loss_weight
        self.reg_loss_weight = reg_loss_weight
        self.stacked_convs = stacked_convs
        self._points = PointCache(
            self.strides, corner_points,
            extras=lambda i, n: np.full((n, 1), self.strides[i], np.float32))
        for branch in ('cls', 'reg'):
            cin = in_channels
            for i in range(stacked_convs):
                self.add_module(f'{branch}{i}_conv', Conv(
                    cin, feat_channels, 3, 1, 1, bias=False,
                    kernel_init=('normal', 0.01)))
                self.add_module(f'{branch}{i}_gn', GroupNorm(
                    GN_GROUPS, feat_channels, eps=GN_EPS))
                cin = feat_channels
        self.conv_cls = head_conv(feat_channels, num_classes, bias_init=float(
            -math.log((1 - 0.02) / 0.02)))
        self.conv_reg = head_conv(feat_channels, 4, bias_init=4.0)
        self.conv_objectness = head_conv(feat_channels, 1)
        self.scales = nn.Parameter(torch.ones(len(self.strides)))
        self.center_mean = nn.Parameter(torch.zeros(num_classes, 2))
        self.center_sigma = nn.Parameter(torch.ones(num_classes, 2))

    def _tower(self, branch, x):
        for i in range(self.stacked_convs):
            x = F.relu(getattr(self, f'{branch}{i}_gn')(
                getattr(self, f'{branch}{i}_conv')(x)))
        return x

    def forward(self, feats):
        """NCHW features -> (class logits, distances (fp32), objectness
        logits, (center_mean, center_sigma) in fp32), the maps per-level
        (B, H, W, attrib) tuples."""
        cls_out, reg_out, obj_out = [], [], []
        for lvl, x in enumerate(feats):
            c, r = self._tower('cls', x), self._tower('reg', x)
            cls_out.append(self.conv_cls(c).permute(0, 2, 3, 1))
            reg = self.conv_reg(r).float()
            reg = reg.to(torch.promote_types(reg.dtype, self.scales.dtype))
            reg_out.append((F.relu(reg * self.scales[lvl]) *
                            self.strides[lvl]).permute(0, 2, 3, 1))
            obj_out.append(self.conv_objectness(r).permute(0, 2, 3, 1))
        return (tuple(cls_out), tuple(reg_out), tuple(obj_out),
                (self.center_mean.float(), self.center_sigma.float()))

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """``loss_pos``, ``loss_neg``, ``loss_center`` and ``num_gts``, in
        fp32 or wider. gt_bboxes (B, G, 4) zero-padded xyxy, gt_labels (B,
        G), gt_valid (B, G)."""
        cls_scores, bbox_preds, objectnesses, (center_mean,
                                               center_sigma) = preds
        _, points, strides = self._points(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        cls_flat = flat([c.float() for c in cls_scores], b, nc)
        reg_flat = flat([r.float() for r in bbox_preds], b, 4)
        obj_flat = flat([o.float() for o in objectnesses], b, 1)[..., 0]
        gts = gt_bboxes.to(reg_flat.dtype)
        points, strides = points.to(gts.dtype), strides[:, 0].to(gts.dtype)
        joint = torch.sigmoid(cls_flat) * torch.sigmoid(obj_flat)[..., None]
        boxes = distance_boxes(points[None], reg_flat)  # (B, P, 4)
        p, g = points.shape[0], gts.shape[1]
        labels = gt_labels.long().clamp(0, nc - 1)  # jnp's clamped gather

        px, py = points[None, :, 0, None], points[None, :, 1, None]
        inside = ((px > gts[:, None, :, 0]) & (px < gts[:, None, :, 2]) &
                  (py > gts[:, None, :, 1]) & (py < gts[:, None, :, 3]) &
                  gt_valid[:, None, :])  # (B, P, G)
        g_cx = (gts[..., 0] + gts[..., 2]) / 2
        g_cy = (gts[..., 1] + gts[..., 3]) / 2
        mean, sigma = center_mean[labels], center_sigma[labels]  # (B, G, 2)
        st = strides[None, :, None]
        dx = (px - g_cx[:, None]) / st - mean[:, None, :, 0]
        dy = (py - g_cy[:, None]) / st - mean[:, None, :, 1]
        prior = (torch.exp(-dx ** 2 / (2 * sigma[:, None, :, 0] ** 2)) *
                 torch.exp(-dy ** 2 / (2 * sigma[:, None, :, 1] ** 2)))
        prior = torch.where(inside, prior, torch.zeros_like(prior))

        pairs = (boxes[:, :, None].expand(-1, -1, g, -1),
                 gts[:, None].expand(-1, p, -1, -1))
        giou = bbox_overlaps_aligned(*pairs, mode='giou')  # (B, P, G)
        ious = bbox_overlaps_aligned(*pairs)

        # the positive loss of each gt
        p_loc = torch.exp(-self.reg_loss_weight * (1.0 - giou))
        p_cls = torch.gather(joint, 2, labels[:, None, :].expand(-1, p, -1))
        p_pos = p_cls * p_loc
        conf_w = torch.exp(p_pos * 3) * prior
        conf_w = conf_w / torch.clamp_min(conf_w.sum(dim=1, keepdim=True),
                                          EPS)
        rew = (p_pos * conf_w).sum(dim=1)  # (B, G)
        pos_loss = -torch.log(torch.clamp(rew, EPS, 1.0)) * gt_valid

        # the negative weights: constant, +-inf outside the gts
        valid = gt_valid[:, None, :]
        iou_pt = torch.where(valid, ious, torch.zeros_like(ious)).amax(
            dim=2, keepdim=True).detach()  # (B, P, 1)
        t = (1.0 / torch.clamp_min(1.0 - iou_pt, EPS)).expand_as(inside)
        inf = torch.full_like(t, math.inf)
        tmin = torch.where(inside, t, inf).amin(dim=1, keepdim=True)
        tmax = torch.where(inside, t, -inf).amax(dim=1, keepdim=True)
        tn = torch.where(inside.any(dim=1, keepdim=True),
                         (t - tmin + EPS) / (tmax - tmin + EPS),
                         torch.zeros_like(t))
        tn = torch.where(inside, tn, torch.zeros_like(tn))
        # the highest-indexed gt of each (point, class) that holds the point
        rank = torch.arange(1, g + 1, device=gts.device)
        rank_key = torch.where(inside, rank, 0)
        sel = torch.zeros((b, p, nc), dtype=rank.dtype,
                          device=gts.device).scatter_reduce_(
            2, labels[:, None, :].expand(-1, p, -1), rank_key, 'amax')
        discount = torch.where(
            sel > 0, torch.gather(tn, 2, (sel - 1).clamp_min(0)),
            torch.zeros_like(joint))
        z = joint * (1.0 - discount)
        neg_loss = z ** 2 * (-torch.log(torch.clamp_min(1 - z, EPS)))

        n_gt = gt_valid.to(gts.dtype).sum(dim=1)  # (B,)
        prior_sum = prior.sum(dim=(1, 2))
        center = torch.where(prior_sum > 0,
                             n_gt / torch.clamp_min(prior_sum, EPS),
                             torch.zeros_like(prior_sum))
        num_gt = torch.clamp_min(global_sum(n_gt.sum()), 1.0)
        neg_avg = torch.clamp_min(global_sum_with_grad(prior_sum.sum()), 1.0)
        images = global_count(b, gts.device)
        return dict(
            loss_pos=self.pos_loss_weight * pos_loss.sum() / num_gt,
            loss_neg=self.neg_loss_weight * neg_loss.sum() / neg_avg,
            loss_center=self.center_loss_weight * center.sum() / images,
            num_gts=n_gt.sum() / images)

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.6, max_per_img: int = 100,
                   nms_pre: int = 1000, **kwargs):
        """Decode and NMS (``autoassign_head.py:249-284``), batched, in
        fp32; other keywords (``img_shape``, ``with_nms``) are ignored, as
        tpudet ignores them."""
        cls_scores, bbox_preds, objectnesses = preds[:3]
        levels, _, _ = self._points(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        all_boxes, all_scores = [], []
        for lvl, pts in enumerate(levels):
            scores = torch.sigmoid(cls_scores[lvl].reshape(b, -1, nc).float())
            obj = torch.sigmoid(objectnesses[lvl].reshape(b, -1).float())
            scores = scores * obj[..., None]
            ltrb = bbox_preds[lvl].reshape(b, -1, 4).float()
            k = min(nms_pre, scores.shape[1])
            if 0 < k < scores.shape[1]:
                scores, ltrb, pts = topk_levels(scores, k, ltrb, pts)
            else:
                pts = pts[None].expand(b, -1, -1)
            all_boxes.append(distance_boxes(pts, ltrb))
            all_scores.append(scores)
        return finish_bboxes(all_boxes, all_scores, scale_factors, score_thr,
                             iou_thr, max_per_img, True)


@DETECTORS.register_module()
class AutoAssign(SingleStageDetector):
    """AutoAssign (reference mmdet/models/detectors/autoassign.py): the
    NMS IoU defaults to 0.6."""
    default_iou_thr = 0.6
