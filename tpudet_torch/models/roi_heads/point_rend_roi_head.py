"""PointRend: port of ``tpudet/models/roi_heads/point_rend_roi_head.py``
(``point_sample_map``, ``_hash_uniform``, ``CoarseMaskHead``,
``MaskPointHead``, ``PointRendRoIHead``, ``PointRend``).

- ``CoarseMaskHead``: P2-only 14 x 14 RoIAlign features (no roi masked)
  -> a 2x2 stride-2 conv with ReLU -> two FCs -> (N, 7, 7, C) coarse
  logits; its loss is ``MaskRoIHead``'s at 7 x 7;
- ``MaskPointHead``: an MLP over each point's [fine P2 feature || coarse
  logits], the coarse logits concatenated again after every layer;
- training: up to ``max_num_point_rois`` positive slots an image
  (positives first, index order), 3x oversampled candidate points hashed
  from each roi's coordinates and its image's row in the global batch
  (``hash_uniform``: ``frac(sin(key x 12.9898 + i x salt) x
  43758.5453)`` in the key's dtype), the
  ``importance_sample_ratio`` share with the most uncertain sampled coarse
  logit (``-|logit|`` at the label; ties by index) and the rest hashed
  again; the point loss is the BCE against the gt-frame mask sampled at
  the points, over the positives;
- inference (``refine_masks``): ``subdivision_steps`` rounds of a
  bilinear 2x upsample (``ops/resize.resize_bilinear``, jax's semantics)
  of the predicted class's logits, the ``subdivision_num_points`` most
  uncertain pixels (ties by index) re-predicted by the point head and
  written back: (B, D, 224, 224) probabilities at the config's 5 rounds,
  the test flow's ``'roi_labels'`` mode.

Every point sampler is ``point_sample_map``: tpudet's four-tap bilinear
sample at normalized coordinates (``grid_sample``'s ``align_corners=
False``), a tap outside the map 0, in tpudet's order of operations. The
point head computes in the features' dtype (tpudet's module ``dtype``);
the sampled values are fp32 or wider before it, as tpudet's.

The hash's ``sin`` takes arguments of 1e4-1e5 on real rois, where two
libraries' fp32 ``sin`` may part by an ulp that the x 43758.5453 makes a
visible shift of a point; ``point_train`` takes its points from a caller
(``points``) so that the rest of the branch can be held to tpudet's on
tpudet's points.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import max_iou_assign_batch
from ...core.nms import topk_scores
from ...ops.resize import resize_bilinear
from ...ops.roi_align import batched_roi_align
from ...parallel.mesh import global_count, global_sum, process_index
from ...registry import DETECTORS, HEADS
from .. import losses as L
from ..layers import Conv, Dense
from .mask_head import MaskRCNN, MaskRoIHead, class_channel

KEY_WEIGHTS = (1.7, 2.3, 3.1, 4.7)


def point_sample_map(feat, xy):
    """Bilinear samples of NHWC maps ``feat`` (N, H, W, C) at normalized
    [0, 1]^2 coordinates ``xy`` (N, P, 2) (x, y): (N, P, C)."""
    n, h, w, c = feat.shape
    x = xy[..., 0] * w - 0.5
    y = xy[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = feat.reshape(n, h * w, c)
    rows = torch.arange(n, device=feat.device)[:, None]

    def tap(yy, xx):
        yi = yy.clamp(0, h - 1).long()
        xi = xx.clamp(0, w - 1).long()
        v = flat[rows, yi * w + xi]
        inb = ((yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1))
        return v * inb[..., None]

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01) +
            fy * ((1 - fx) * v10 + fx * v11))


def hash_uniform(key_vals, n: int, salt: float):
    """(..., R) keys -> (..., R, n) pseudo-uniforms in [0, 1)
    (``_hash_uniform``; ``i x salt`` in fp32, as tpudet's, whatever the
    keys' dtype)."""
    i = torch.arange(1, n + 1, dtype=torch.float32, device=key_vals.device)
    s = torch.sin(key_vals[..., None] * 12.9898 + i * salt) * 43758.5453
    return s - torch.floor(s)


@HEADS.register_module()
class CoarseMaskHead(nn.Module):

    def __init__(self, num_classes: int, in_channels: int = 256,
                 conv_out_channels: int = 256, fc_out_channels: int = 1024,
                 num_fcs: int = 2, roi_feat_size: int = 14,
                 downsample_factor: int = 2):
        super().__init__()
        d = downsample_factor
        self.num_classes = num_classes
        self.num_fcs = num_fcs
        self.downsample_factor = d
        self.output_size = roi_feat_size // d
        cin = in_channels
        if d > 1:
            self.downsample_conv = Conv(in_channels, conv_out_channels, d, d)
            cin = conv_out_channels
        cin = cin * (roi_feat_size // d) ** 2
        for i in range(num_fcs):
            self.add_module(f'fc{i}', Dense(cin, fc_out_channels))
            cin = fc_out_channels
        self.fc_logits = Dense(cin, num_classes * self.output_size ** 2,
                               kernel_init=('normal', 0.001))

    def forward(self, roi_feats):
        """(N, 14, 14, C) -> (N, 7, 7, num_classes) coarse logits."""
        x = roi_feats
        if self.downsample_factor > 1:
            x = F.relu(self.downsample_conv(x.permute(0, 3, 1, 2))
                       ).permute(0, 2, 3, 1)
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fcs):
            x = F.relu(getattr(self, f'fc{i}')(x))
        out = self.output_size
        return self.fc_logits(x).reshape(x.shape[0], out, out,
                                         self.num_classes)


@HEADS.register_module()
class MaskPointHead(nn.Module):

    def __init__(self, num_classes: int, in_channels: int = 256,
                 fc_channels: int = 256, num_fcs: int = 3,
                 coarse_pred_each_layer: bool = True):
        super().__init__()
        self.num_fcs = num_fcs
        self.coarse_pred_each_layer = coarse_pred_each_layer
        cin = in_channels + num_classes
        for i in range(num_fcs):
            self.add_module(f'fc{i}', Dense(cin, fc_channels,
                                            kernel_init='he_normal'))
            cin = fc_channels + (num_classes if coarse_pred_each_layer
                                 else 0)
        self.fc_logits = Dense(cin, num_classes,
                               kernel_init=('normal', 0.001))

    def forward(self, fine_feats, coarse_feats):
        """fine (..., Cf) + coarse (..., C) -> (..., C) point logits."""
        x = torch.cat([fine_feats, coarse_feats], dim=-1)
        for i in range(self.num_fcs):
            x = F.relu(getattr(self, f'fc{i}')(x))
            if self.coarse_pred_each_layer:
                x = torch.cat([x, coarse_feats], dim=-1)
        return self.fc_logits(x)


@HEADS.register_module()
class PointRendRoIHead(MaskRoIHead):
    """``StandardRoIHead``'s keyword arguments and tpudet's fields
    ``num_points``, ``oversample_ratio``, ``importance_sample_ratio``,
    ``subdivision_steps``, ``subdivision_num_points``, ``scale_factor``,
    ``max_num_point_rois``, ``point_roi_size``, ``mask_size`` (the coarse
    targets' side)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 num_points: int = 196, oversample_ratio: int = 3,
                 importance_sample_ratio: float = 0.75,
                 subdivision_steps: int = 5,
                 subdivision_num_points: int = 784, scale_factor: int = 2,
                 max_num_point_rois: int = 96, point_roi_size: int = 14,
                 mask_size: int = 7, **kwargs):
        super().__init__(num_classes, in_channels, mask_size=mask_size,
                         **kwargs)
        self.num_points = num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
        self.subdivision_steps = subdivision_steps
        self.subdivision_num_points = subdivision_num_points
        self.scale_factor = scale_factor
        self.max_num_point_rois = max_num_point_rois
        self.point_roi_size = point_roi_size
        self.mask_head = CoarseMaskHead(num_classes, in_channels,
                                        roi_feat_size=point_roi_size)
        self.point_head = MaskPointHead(num_classes, in_channels)

    # the coarse branch

    def mask_forward(self, feats, rois, roi_valid):
        """P2-only RoIAlign at ``point_roi_size`` (every roi, valid or not)
        -> the coarse head: (B, P, 7, 7, C)."""
        pooled = batched_roi_align(feats[0].permute(0, 2, 3, 1), rois,
                                   self.point_roi_size,
                                   1.0 / self.featmap_strides[0])
        b, p = pooled.shape[:2]
        logits = self.mask_head(pooled.reshape((b * p,) + pooled.shape[2:]))
        return logits.reshape((b, p) + logits.shape[1:])

    # the point branch

    @staticmethod
    def roi_points_to_img(rois, pts):
        """roi-relative [0, 1]^2 points (..., R, P, 2) of rois (..., R, 4)
        -> image coordinates."""
        x1, y1 = rois[..., None, 0], rois[..., None, 1]
        w = rois[..., None, 2] - x1
        h = rois[..., None, 3] - y1
        return torch.stack([x1 + pts[..., 0] * w, y1 + pts[..., 1] * h], -1)

    def sample_fine(self, p2, rois, pts):
        """P2 (B, C, H, W) sampled at roi-relative points (B, R, P, 2) of
        rois (B, R, 4): (B, R, P, C)."""
        b, r, p = pts.shape[:3]
        img_pts = self.roi_points_to_img(rois, pts)
        stride = self.featmap_strides[0]
        hw = torch.tensor([p2.shape[3] * stride, p2.shape[2] * stride],
                          dtype=torch.float32, device=pts.device)
        norm = img_pts / hw
        out = point_sample_map(p2.permute(0, 2, 3, 1), norm.reshape(b, -1, 2))
        return out.reshape(b, r, p, -1)

    @staticmethod
    def sample_coarse(coarse, pts):
        """Per-roi coarse maps (B, R, 7, 7, C) sampled at (B, R, P, 2):
        (B, R, P, C)."""
        b, r = coarse.shape[:2]
        out = point_sample_map(coarse.reshape((b * r,) + coarse.shape[2:]),
                               pts.reshape((b * r,) + pts.shape[2:]))
        return out.reshape((b, r) + out.shape[1:])

    def select_point_rois(self, pos):
        """The slot order of the point branch: positives first, index
        order, ``max_num_point_rois`` at most (B, K)."""
        k = min(self.max_num_point_rois, pos.shape[1])
        return torch.argsort((~pos).to(torch.int32), dim=1, stable=True
                             )[:, :k]

    def train_points(self, rois_k, labels_k, coarse_k):
        """The training points (B, K, num_points, 2) of the selected
        slots: the most uncertain of the hashed candidates, then more
        hashed points; no gradient."""
        b = rois_k.shape[0]
        n_over = self.num_points * self.oversample_ratio
        n_imp = int(self.importance_sample_ratio * self.num_points)
        n_rand = self.num_points - n_imp
        key = torch.zeros_like(rois_k[..., 0])
        for j, wt in enumerate(KEY_WEIGHTS):  # tpudet's sum, in order
            key = key + rois_k[..., j] * wt
        # the image's row of the global batch, as tpudet's SPMD batch
        # lays the processes' shards out (process order)
        img_id = torch.arange(b, dtype=torch.float32, device=key.device) + \
            float(process_index() * b)
        key = key + img_id[:, None] * 17.0
        cand = torch.stack([hash_uniform(key, n_over, 78.233),
                            hash_uniform(key, n_over, 37.719)], -1)
        lc = class_channel(self.sample_coarse(coarse_k.detach(), cand),
                           labels_k, self.num_classes)
        _, top = topk_scores(-lc.abs(), n_imp)
        imp = torch.gather(cand, 2, top[..., None].expand(top.shape + (2,)))
        rand = torch.stack([hash_uniform(key + 3.33, n_rand, 78.233),
                            hash_uniform(key + 3.33, n_rand, 37.719)], -1)
        return torch.cat([imp, rand], dim=2).detach()

    def point_train(self, feats, rois, pos, labels, targets, coarse_logits,
                    points: Optional[torch.Tensor] = None):
        """The point head on the selected slots' points (``points`` (B, K,
        num_points, 2) where given, else ``train_points``): ``(point
        logits (B, K, P, C), points, rois_k, gt boxes of the slots (from
        their targets), labels_k, pos_k)``."""
        order = self.select_point_rois(pos)

        def sel(t):
            return torch.gather(t, 1, order.reshape(
                order.shape + (1,) * (t.dim() - 2)).expand(
                    order.shape + t.shape[2:]))
        pos_k, rois_k, labels_k = sel(pos), sel(rois), sel(labels)
        coarse_k = sel(coarse_logits)
        gt_k = self.bbox_coder.decode(rois_k, sel(targets))
        pts = self.train_points(rois_k, labels_k, coarse_k) \
            if points is None else points
        dt = feats[0].dtype
        fine = self.sample_fine(feats[0], rois_k, pts)
        coarse_pt = self.sample_coarse(coarse_k, pts)
        logits = self.point_head(fine.to(dt), coarse_pt.to(dt))
        return logits, pts, rois_k, gt_k, labels_k, pos_k

    def point_loss(self, point_logits, pts, rois_k, gt_k, labels_k, pos_k,
                   gt_idx_k, gt_frame_masks) -> Dict[str, torch.Tensor]:
        """``loss_point``: the BCE of the label's point logits against the
        matched gt-frame mask sampled at the points, over the positive
        slots, / (max(positives, 1) x points)."""
        b, k, p = point_logits.shape[:3]
        dtype = torch.promote_types(point_logits.dtype, torch.float32)
        img_pts = self.roi_points_to_img(rois_k, pts)
        gx1, gy1 = gt_k[..., None, 0], gt_k[..., None, 1]
        gw = torch.clamp_min(gt_k[..., None, 2] - gx1, 1e-3)
        gh = torch.clamp_min(gt_k[..., None, 3] - gy1, 1e-3)
        norm = torch.stack([(img_pts[..., 0] - gx1) / gw,
                            (img_pts[..., 1] - gy1) / gh], -1)
        batch = torch.arange(b, device=pts.device)[:, None]
        masks = gt_frame_masks[batch, gt_idx_k.clamp_min(0)].to(dtype)
        s = masks.shape[-1]
        tgt = point_sample_map(masks.reshape(b * k, s, s, 1),
                               norm.reshape(b * k, p, 2)).reshape(b, k, p)
        lg = class_channel(point_logits.to(dtype), labels_k,
                           self.num_classes)
        bce = L.binary_cross_entropy_with_logits(lg, tgt.clamp(0., 1.))
        w = pos_k[..., None].to(dtype)
        n = torch.clamp_min(global_sum(w.sum()), 1.0) * p
        return dict(loss_point=(bce * w).sum() / n)

    # subdivision inference

    def refine_masks(self, feats, det_bboxes, det_valid, det_labels,
                     coarse_logits):
        """The predicted class's coarse logits (B, D, 7, 7) refined by
        ``subdivision_steps`` rounds of upsampling and point re-prediction:
        (B, D, R, R) probabilities, R = 7 x ``scale_factor`` **
        ``subdivision_steps``, 0 at invalid detections."""
        p2 = feats[0]
        cur = class_channel(coarse_logits.float(), det_labels,
                            self.num_classes)
        b, d = cur.shape[:2]
        for _ in range(self.subdivision_steps):
            hh = cur.shape[-1] * self.scale_factor
            cur = resize_bilinear(cur, (b, d, hh, hh))
            npts = min(self.subdivision_num_points, hh * hh)
            flat = cur.reshape(b, d, -1)
            _, idx = topk_scores(-flat.abs(), npts)
            py = torch.div(idx, hh, rounding_mode='floor').float()
            px = (idx % hh).float()
            pts = torch.stack([(px + 0.5) / hh, (py + 0.5) / hh], -1)
            fine = self.sample_fine(p2, det_bboxes, pts)
            coarse_pt = self.sample_coarse(coarse_logits, pts)
            logits = self.point_head(fine.to(p2.dtype),
                                     coarse_pt.to(p2.dtype))
            lg = class_channel(logits, det_labels, self.num_classes)
            cur = flat.scatter(2, idx, lg.to(flat.dtype)).reshape(b, d, hh,
                                                                  hh)
        return torch.sigmoid(cur) * det_valid[..., None, None]


@DETECTORS.register_module()
class PointRend(MaskRCNN):
    """Mask R-CNN whose mask branch is the coarse head and the point head
    (``point_rend_roi_head.py:320-373``)."""

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid,
                      gt_frame_masks) -> Dict[str, torch.Tensor]:
        head = self.roi_head
        feats = self.extract_feat(img)
        losses, proposals, prop_valid = self.train_proposals(
            feats, img, gt_bboxes, gt_labels, gt_valid)
        gt_bboxes = torch.as_tensor(gt_bboxes).float()
        rois, sampled, labels, targets, pos = head.sample_rois(
            proposals, prop_valid, gt_bboxes, gt_labels, gt_valid)
        cls_logits, deltas = head(feats, rois, sampled)
        losses.update(head.loss(cls_logits, deltas, labels, targets, pos,
                                sampled, rois=rois))
        gt_idx = max_iou_assign_batch(rois, gt_bboxes, gt_valid, 0.5, 0.5,
                                      0.5, True)
        coarse = head.mask_forward(feats, rois, sampled)
        losses.update(head.mask_loss(coarse, rois, pos, gt_idx, gt_bboxes,
                                     gt_frame_masks, labels))
        point_logits, pts, rois_k, gt_k, labels_k, pos_k = head.point_train(
            feats, rois, pos, labels, targets, coarse)
        gt_idx_k = torch.gather(gt_idx.clamp_min(0), 1,
                                head.select_point_rois(pos))
        losses.update(head.point_loss(point_logits, pts, rois_k, gt_k,
                                      labels_k, pos_k, gt_idx_k,
                                      gt_frame_masks))
        losses['num_gts'] = (gt_valid.float().sum() / global_count(
            gt_valid.shape[0], gt_valid.device))
        return losses

    def predict_masks(self, img, det_bboxes, det_valid, det_labels,
                      feats: Optional[list] = None) -> torch.Tensor:
        """Subdivision-refined (B, D, R, R) probabilities of detections
        (network input frame) of their labels; ``feats`` of the same call
        are reused where given."""
        if feats is None:
            feats = self.extract_feat(img)
        coarse = self.roi_head.mask_forward(feats, det_bboxes, det_valid)
        return self.roi_head.refine_masks(feats, det_bboxes, det_valid,
                                          det_labels, coarse)
