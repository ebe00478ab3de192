"""Grid R-CNN: port of ``tpudet/models/roi_heads/grid_roi_head.py``
(``GridHead``, ``GridRoIHead``, ``GridRCNN``).

``GridHead`` (``:46-158``) on (N, 14, 14, C) RoI features:

- 8 x (3x3 conv to 9 x 64 channels, flax's GroupNorm of 36 groups, eps
  1e-6, ReLU); the first conv has stride 2 and flax's ``'SAME'`` padding,
  (0, 1) on an even side, so 14^2 becomes 7^2;
- first- and second-order fusion: each point's 64 channels plus, for each
  neighbour on the 3 x 3 grid, a transition (5x5 depthwise, then 1x1) of
  the neighbour's channels (``fo{i}_{j}``) or of its first-order fusion
  (``so{i}_{j}``): 48 transitions;
- two grouped (9 groups) 2x transposed convs, 4x4 stride 2 padding 1,
  with a GroupNorm of 9 groups (eps 1e-6) and ReLU between them: (N, 28,
  28, 9) logits; ``unfused`` runs the plain features through the same
  transposed convs in training.

tpudet writes each transposed conv as a convolution of the input dilated
by 2 and padded by 2 with its raw HWIO kernel ``deconv{1,2}_kernel`` (4,
4, Cin / 9, Cout) as it stands; ``F.conv_transpose2d(stride=2,
padding=1, groups=9)`` is that with the kernel flipped in both spatial
axes and laid out (Cin, Cout / 9, 4, 4). The port keeps tpudet's kernel
as a conv weight (Cout, Cin / 9, 4, 4) (``utils/flax_import``'s conv
kind) and regroups and flips it at the call. Both run in fp32 (the raw
kernels are fp32 params, and tpudet casts the input to them), the rest
in the compute dtype.

``get_targets`` (``:166-199``) marks the circles of ``pos_radius`` around
each gt grid point on the 28 x 28 sub-region grids of the 2x-expanded roi
(a point's cell is the ``floor`` of its place on the 56-wide map), all 0
for a roi whose expanded side is at most 3; ``refine_bboxes``
(``:201-238``) votes each side from the heatmaps' argmaxes (the first
maximum), weighted by their scores.

``GridRoIHead`` (``:241-326``) is ``StandardRoIHead`` (its 2-FC head
still carries ``fc_reg``; the loss is classification only) with the grid
branch: ``grid_train`` takes the first ``max_num_grid`` slots an image,
positives first (a stable ``argsort``), recovers each one's gt by decoding
its delta targets, jitters the positives (tpudet's ``sin`` hash of the box,
amplitude 0.15), pools them 14 x 14 and returns the heatmaps and targets;
``grid_loss`` is the BCE of both heatmaps times 15 over the positives'
points and pixels, the positive count over every rank's batch.

``GridRCNN``: ``forward_train`` adds the grid loss; ``get_bboxes`` scores
the proposals themselves (zero deltas) under ``test_cfg.rcnn``, as
tpudet's; ``refine_boxes`` refines detections by the grid head's voting,
clipped to the canvas. tpudet's API and test CLI evaluate the unrefined
boxes (nothing in tpudet calls ``refine_boxes``), and so do the port's.
tpudet's ``refine_boxes`` runs the backbone again; the port's takes the
call's features where given (``feats``), as ``predict_masks`` does.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import same_padding
from ...parallel.mesh import global_count, global_sum
from ...registry import DETECTORS, HEADS
from .. import losses as L
from ..detectors.two_stage import TwoStageDetector
from ..layers import Conv
from ..plugins import GroupNorm
from .standard_roi_head import StandardRoIHead

GN_EPS = 1e-6  # flax's nn.GroupNorm default (grid_roi_head.py:110, 149)
JITTER_SEED = (12.9898, 78.233, 37.719, 9.151)  # grid_roi_head.py:260


def grouped_deconv2x(x, weight, bias, groups: int):
    """tpudet's ``_grouped_deconv2x`` plus the bias: ``weight`` is its
    HWIO kernel as a conv weight (Cout, Cin / groups, 4, 4)."""
    cout, cin_g = weight.shape[:2]
    w = weight.reshape(groups, cout // groups, cin_g, 4, 4).transpose(1, 2)
    w = w.reshape(groups * cin_g, cout // groups, 4, 4).flip(-2, -1)
    return F.conv_transpose2d(x, w, bias, stride=2, padding=1,
                              groups=groups)


@HEADS.register_module()
class GridHead(nn.Module):
    """The keyword arguments are tpudet's fields (``grid_roi_head.py:
    48-53``) with its defaults, and the input's channels. ``forward``
    takes (N, 14, 14, C) and returns (fused, unfused) (N, 28, 28, P) fp32
    logits (``unfused`` is ``fused`` outside training)."""

    flax_leaves = {'deconv1_kernel': ('deconv1_kernel', 'conv'),
                   'deconv1_bias': ('deconv1_bias', ''),
                   'deconv2_kernel': ('deconv2_kernel', 'conv'),
                   'deconv2_bias': ('deconv2_bias', '')}
    leaf_init = {'deconv1_kernel': ('normal', 0.001),
                 'deconv2_kernel': ('normal', 0.001),
                 'deconv2_bias': -math.log(99.)}

    def __init__(self, in_channels: int = 256, grid_points: int = 9,
                 num_convs: int = 8, roi_feat_size: int = 14,
                 point_feat_channels: int = 64, gn_groups: int = 36):
        super().__init__()
        self.grid_points, self.num_convs = grid_points, num_convs
        self.roi_feat_size = roi_feat_size
        self.grid_size = int(np.sqrt(grid_points))
        self.whole_map_size = roi_feat_size * 4
        self.half_size = self.whole_map_size // 4 * 2
        g, c = grid_points, point_feat_channels
        self.point_feat_channels = c
        cin = in_channels
        for i in range(num_convs):
            self.add_module(f'conv{i}', Conv(cin, g * c, 3, 2 if i == 0 else
                                             1, 0 if i == 0 else 1))
            self.add_module(f'gn{i}', GroupNorm(gn_groups, g * c, GN_EPS))
            cin = g * c
        self.neighbors = self.neighbor_points()
        for order in ('fo', 'so'):
            for i, nbs in enumerate(self.neighbors):
                for j in range(len(nbs)):
                    self.add_module(f'{order}{i}_{j}_dw',
                                    Conv(c, c, 5, 1, 2, groups=c))
                    self.add_module(f'{order}{i}_{j}_pw', Conv(c, c, 1))
        self.deconv1_kernel = nn.Parameter(torch.zeros(g * c, c, 4, 4))
        self.deconv1_bias = nn.Parameter(torch.zeros(g * c))
        self.deconv2_kernel = nn.Parameter(torch.zeros(g, c, 4, 4))
        self.deconv2_bias = nn.Parameter(torch.full((g,), -math.log(99.)))
        self.dgn = GroupNorm(g, g * c, GN_EPS)

    def sub_regions(self):
        """Per-point (x1, y1) sub-region offsets (``grid_roi_head.py:
        67-80``)."""
        gs, whole, half = self.grid_size, self.whole_map_size, self.half_size

        def off(idx):
            if idx == 0:
                return 0
            if idx == gs - 1:
                return half
            return max(int((idx / (gs - 1) - 0.25) * whole), 0)
        return [(off(i // gs), off(i % gs)) for i in range(self.grid_points)]

    def neighbor_points(self):
        """Each point's neighbours on the grid, above, left, right, below
        (``grid_roi_head.py:82-97``)."""
        gs = self.grid_size
        out = []
        for i in range(gs):
            for j in range(gs):
                nb = []
                if i > 0:
                    nb.append((i - 1) * gs + j)
                if j > 0:
                    nb.append(i * gs + j - 1)
                if j < gs - 1:
                    nb.append(i * gs + j + 1)
                if i < gs - 1:
                    nb.append((i + 1) * gs + j)
                out.append(tuple(nb))
        return out

    def _trans(self, name, t):
        return getattr(self, f'{name}_pw')(getattr(self, f'{name}_dw')(t))

    def _head(self, feat, dtype):
        k32 = self.deconv1_kernel.dtype
        h = grouped_deconv2x(feat.to(k32), self.deconv1_kernel,
                             self.deconv1_bias, self.grid_points)
        h = F.relu(self.dgn(h)).to(dtype).to(k32)
        return grouped_deconv2x(h, self.deconv2_kernel, self.deconv2_bias,
                                self.grid_points)

    def forward(self, x):
        dtype = x.dtype
        x = x.permute(0, 3, 1, 2)
        pads = [same_padding(n, 3, 2) for n in x.shape[-2:]]
        x = F.pad(x, (*pads[1], *pads[0]))
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f'gn{i}')(getattr(self, f'conv{i}')(x)))
        c = self.point_feat_channels
        pt = [x[:, i * c:(i + 1) * c] for i in range(self.grid_points)]
        x_fo = []
        for i, nbs in enumerate(self.neighbors):
            acc = pt[i]
            for j, p in enumerate(nbs):
                acc = acc + self._trans(f'fo{i}_{j}', pt[p])
            x_fo.append(acc)
        x_so = []
        for i, nbs in enumerate(self.neighbors):
            acc = pt[i]
            for j, p in enumerate(nbs):
                acc = acc + self._trans(f'so{i}_{j}', x_fo[p])
            x_so.append(acc)
        fused = self._head(torch.cat(x_so, dim=1), dtype)
        unfused = self._head(x, dtype) if self.training else fused
        return fused.permute(0, 2, 3, 1), unfused.permute(0, 2, 3, 1)

    def _factors(self, like):
        gs = self.grid_size
        return like.new_tensor(
            [[1 - (j // gs) / (gs - 1), 1 - (j % gs) / (gs - 1)]
             for j in range(self.grid_points)])

    def get_targets(self, pos_rois, gt_boxes, pos_radius: float = 1.0):
        """Circle targets (``grid_roi_head.py:166-199``): rois and gts
        (..., 4) -> (..., half, half, P) in {0, 1}."""
        whole, half = self.whole_map_size, self.half_size
        w = pos_rois[..., 2] - pos_rois[..., 0]
        h = pos_rois[..., 3] - pos_rois[..., 1]
        x1e = pos_rois[..., 0] - w / 2
        y1e = pos_rois[..., 1] - h / 2
        we, he = 2 * w, 2 * h
        fac = self._factors(pos_rois)  # (P, 2)
        gx = fac[:, 0] * gt_boxes[..., None, 0] + \
            (1 - fac[:, 0]) * gt_boxes[..., None, 2]  # (..., P)
        gy = fac[:, 1] * gt_boxes[..., None, 1] + \
            (1 - fac[:, 1]) * gt_boxes[..., None, 3]
        cx = torch.floor((gx - x1e[..., None]) /
                         torch.clamp_min(we[..., None], 1e-6) * whole)
        cy = torch.floor((gy - y1e[..., None]) /
                         torch.clamp_min(he[..., None], 1e-6) * whole)
        subs = pos_rois.new_tensor(self.sub_regions())
        xs = torch.arange(half, dtype=pos_rois.dtype, device=pos_rois.device)
        full_x = xs[None, :] + subs[:, 0:1]  # (P, half)
        full_y = xs[None, :] + subs[:, 1:2]
        dx2 = (full_x - cx[..., None]) ** 2  # (..., P, half)
        dy2 = (full_y - cy[..., None]) ** 2
        inside = (dy2[..., :, None] + dx2[..., None, :]) <= pos_radius ** 2
        big = (we > self.grid_size) & (he > self.grid_size)
        t = (inside & big[..., None, None, None]).to(pos_rois.dtype)
        return t.movedim(-3, -1)

    def refine_bboxes(self, boxes, heatmap):
        """Score-weighted voting (``grid_roi_head.py:201-238``): boxes
        (..., 4), heatmaps (..., half, half, P) logits -> (..., 4)."""
        g, gs, half = self.grid_points, self.grid_size, self.half_size
        prob = torch.sigmoid(heatmap.float())
        flat = prob.movedim(-1, -3).reshape(prob.shape[:-3] +
                                            (g, half * half))
        score = flat.amax(dim=-1)
        pos_idx = flat.argmax(dim=-1)  # the first maximum
        subs = flat.new_tensor(self.sub_regions())
        xs = (pos_idx % half).float() + subs[:, 0]
        ys = (pos_idx // half).float() + subs[:, 1]
        w = (boxes[..., 2] - boxes[..., 0])[..., None]
        h = (boxes[..., 3] - boxes[..., 1])[..., None]
        x1e = boxes[..., 0][..., None] - w / 2
        y1e = boxes[..., 1][..., None] - h / 2
        abs_x = (xs + 0.5) / half * w + x1e
        abs_y = (ys + 0.5) / half * h + y1e

        def vote(coord, inds):
            s = score[..., inds]
            return (coord[..., inds] * s).sum(-1) / torch.clamp_min(
                s.sum(-1), 1e-6)
        return torch.stack([
            vote(abs_x, list(range(gs))),
            vote(abs_y, [i * gs for i in range(gs)]),
            vote(abs_x, [g - gs + i for i in range(gs)]),
            vote(abs_y, [(i + 1) * gs - 1 for i in range(gs)])], -1)


def jitter(boxes, amplitude: float = 0.15):
    """tpudet's ``GridRoIHead._jitter`` (``grid_roi_head.py:256-269``):
    offsets hashed from each box's coordinates by ``sin`` (..., 4) ->
    (..., 4)."""
    seed = torch.sin(boxes * boxes.new_tensor(JITTER_SEED))
    u = torch.remainder(seed.sum(-1, keepdim=True) * 43758.5453, 1.0)
    off = (torch.cat([u, torch.remainder(u * 7.13, 1.0),
                      torch.remainder(u * 3.77, 1.0),
                      torch.remainder(u * 1.93, 1.0)], -1) * 2 - 1) * \
        amplitude
    cxcy = (boxes[..., 2:] + boxes[..., :2]) / 2
    wh = (boxes[..., 2:] - boxes[..., :2]).abs()
    new_c = cxcy + wh * off[..., :2]
    new_wh = wh * (1 + off[..., 2:])
    return torch.cat([new_c - new_wh / 2, new_c + new_wh / 2], -1)


@HEADS.register_module()
class GridRoIHead(StandardRoIHead):
    """``StandardRoIHead``'s keyword arguments and tpudet's fields
    (``grid_roi_head.py:243-248``) with its defaults."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 grid_roi_size: int = 14, grid_points: int = 9,
                 pos_radius: float = 1.0, max_num_grid: int = 96,
                 jitter_amplitude: float = 0.15,
                 loss_grid_weight: float = 15.0, **kwargs):
        super().__init__(num_classes, in_channels, **kwargs)
        self.grid_roi_size = grid_roi_size
        self.pos_radius = pos_radius
        self.max_num_grid = max_num_grid
        self.jitter_amplitude = jitter_amplitude
        self.loss_grid_weight = loss_grid_weight
        self.grid_head = GridHead(in_channels, grid_points=grid_points,
                                  roi_feat_size=grid_roi_size)

    def grid_forward(self, feats, rois, roi_valid):
        """14 x 14 pooling and the grid head: (fused, unfused) (B, P, 28,
        28, 9)."""
        pooled = self.extract(feats, rois, roi_valid,
                              out_size=self.grid_roi_size)
        b, p = pooled.shape[:2]
        fused, unfused = self.grid_head(pooled.flatten(0, 1))
        return fused.unflatten(0, (b, p)), unfused.unflatten(0, (b, p))

    def grid_train(self, feats, rois, pos, labels, targets):
        """The grid branch of a training batch (``grid_roi_head.py:
        284-305``): ``(fused, unfused, targets, positives)`` of the first
        ``max_num_grid`` slots an image, positives first."""
        k = min(self.max_num_grid, pos.shape[1])
        order = torch.argsort((~pos).to(torch.int32), dim=1,
                              stable=True)[:, :k]
        pos_k = torch.gather(pos, 1, order)
        idx = order[..., None].expand(-1, -1, 4)
        rois_k = torch.gather(rois, 1, idx)
        gt_k = self.bbox_coder.decode(rois_k, torch.gather(targets, 1, idx))
        jit_k = torch.where(pos_k[..., None],
                            jitter(rois_k, self.jitter_amplitude),
                            rois_k).detach()
        fused, unfused = self.grid_forward(feats, jit_k, pos_k)
        grid_targets = self.grid_head.get_targets(jit_k, gt_k,
                                                  self.pos_radius)
        return fused, unfused, grid_targets, pos_k

    def grid_loss(self, fused, unfused, grid_targets, pos_k) -> Dict:
        """BCE of both heatmaps over the positives' points and pixels, times
        ``loss_grid_weight`` (``grid_roi_head.py:307-318``)."""
        w = pos_k[:, :, None, None, None].float()
        n = torch.clamp_min(global_sum(w.sum()), 1.0) * float(
            np.prod(fused.shape[2:]))
        bce_f = L.binary_cross_entropy_with_logits(fused.float(),
                                                   grid_targets)
        bce_u = L.binary_cross_entropy_with_logits(unfused.float(),
                                                   grid_targets)
        return dict(loss_grid=self.loss_grid_weight * (
            (bce_f * w).sum() + (bce_u * w).sum()) / n)

    def loss(self, cls_logits, deltas, labels, targets, pos, sampled,
             rois=None) -> Dict:
        """Classification only (``with_reg=False``)."""
        num_total = torch.clamp_min(global_sum(sampled.float().sum()), 1.0)
        ce = -torch.gather(F.log_softmax(cls_logits.float(), dim=-1), -1,
                           labels[..., None])[..., 0]
        return dict(loss_cls=(ce * sampled).sum() / num_total)


@DETECTORS.register_module()
class GridRCNN(TwoStageDetector):
    """Grid R-CNN (``grid_roi_head.py:329-387``)."""

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid):
        feats = self.extract_feat(img)
        losses, proposals, prop_valid = self.train_proposals(
            feats, img, gt_bboxes, gt_labels, gt_valid)
        head = self.roi_head
        rois, sampled, labels, targets, pos = head.sample_rois(
            proposals, prop_valid, gt_bboxes, gt_labels, gt_valid)
        cls_logits, deltas = head(feats, rois, sampled)
        losses.update(head.loss(cls_logits, deltas, labels, targets, pos,
                                sampled, rois=rois))
        losses.update(head.grid_loss(*head.grid_train(feats, rois, pos,
                                                      labels, targets)))
        losses['num_gts'] = gt_valid.float().sum() / global_count(
            gt_valid.shape[0], gt_valid.device)
        return losses

    def get_bboxes(self, outputs, scale_factors=None, **kwargs):
        """The class scores' NMS on the proposals themselves: zero deltas
        make the coder the identity (``with_reg=False``)."""
        proposals, prop_valid, cls_logits, _ = outputs
        return super().get_bboxes(
            (proposals, prop_valid, cls_logits, torch.zeros_like(proposals)),
            scale_factors=scale_factors, **kwargs)

    def refine_boxes(self, img, det_bboxes, det_valid, feats=None):
        """Detections (boxes in the network input's frame) refined by the
        grid head's voting, clipped to the canvas; invalid ones as they
        are. ``feats``, ``img``'s features from the same call, are reused
        where given."""
        if feats is None:
            feats = self.extract_feat(img)
        fused, _ = self.roi_head.grid_forward(feats, det_bboxes, det_valid)
        refined = self.roi_head.grid_head.refine_bboxes(det_bboxes, fused)
        h, w = img.shape[1:3]
        hi = refined.new_tensor([w, h, w, h])
        refined = torch.minimum(torch.clamp_min(refined, 0), hi)
        return torch.where(det_valid[..., None], refined, det_bboxes)
