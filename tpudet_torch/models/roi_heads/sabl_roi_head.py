"""SABL's RoI head: port of ``tpudet/models/roi_heads/sabl_roi_head.py``
(``SABLBBoxHead``, ``SABLRoIHead``, ``SABLFasterRCNN``).

``SABLBBoxHead`` on the pooled (N, 7, 7, C) features:

- classification: the features flattened in HWC order, ``cls_fc0`` and
  ``cls_fc1`` (1024, ReLU, ``xavier_uniform``), ``fc_cls`` (C + 1 logits,
  N(0, 0.01^2));
- localization: ``reg_pre_conv0`` / ``1`` (3x3, 256, ReLU, ``he_normal``);
  ``reg_conv_att_x`` / ``_y`` (3x3 to one channel, sigmoid), normalised
  over the rows (x) or columns (y), pool the map to a row (N, W, C) and a
  column (N, H, C) feature; each goes through ``{x,y}_post`` (1-D 3-tap
  conv, ReLU), ``{x,y}_up`` (1-D transposed conv, kernel and stride 2,
  ReLU: 14 positions), then ``{x,y}_off_fc`` / ``{x,y}_cls_fc`` (256,
  ReLU, flax's default ``lecun_normal``) and ``{x,y}_off`` (N(0,
  0.001^2)) / ``{x,y}_cls`` (N(0, 0.01^2)), one value a position;
- the side-aware split (``sabl_roi_head.py:118-123``): a row's first 7
  positions and its last 7 reversed, so the (N, 28) bucket logits and
  offsets run (left, right, top, bottom), the bucketing coder's order.

flax's 1-D ``ConvTranspose`` does not flip its kernel; torch's does, so
``utils/flax_import`` flips it on the way in and out (the ``DECONV1``
kind).

``SABLRoIHead`` is ``StandardRoIHead`` (sampling, RoIAlign) with this
bbox head and ``BucketingBBoxCoder(num_buckets, scale_factor=1.7)``:

- ``loss`` (``:159-184``): softmax cross-entropy over the sampled rois;
  the matched gts recovered by decoding the delta targets that sampling
  made (tpudet's round trip, kept), then the bucket BCE (neighbours
  ignored) over ``num_pos * 4 * 7`` and the offsets' smooth L1 (beta 1/9)
  over ``num_pos * 4``, both counts summed over the ranks;
- ``get_bboxes`` (``:186-227``): the softmax scores without background
  times the decode's confidence, the decoded box shared by every class,
  then ``pair_nms`` (the top 2048 (roi, class) pairs, one class-offset NMS
  an image). Like tpudet's, no clip to the image.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox import BucketingBBoxCoder
from ...parallel.mesh import global_sum
from ...registry import DETECTORS, HEADS
from .. import losses as L
from ..detectors.two_stage import TwoStageDetector
from ..layers import Conv, Conv1d, ConvTranspose1d, Dense
from .standard_roi_head import StandardRoIHead, pair_nms


class SABLBBoxHead(nn.Module):
    """The keyword arguments are tpudet's fields (``sabl_roi_head.py:
    31-39``) with its defaults."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 fc_out_channels: int = 1024, reg_feat_channels: int = 256,
                 roi_feat_size: int = 7, num_buckets: int = 14,
                 up_ratio: int = 2):
        super().__init__()
        self.up = roi_feat_size * up_ratio
        self.cls_fc0 = Dense(in_channels * roi_feat_size ** 2,
                             fc_out_channels)
        self.cls_fc1 = Dense(fc_out_channels, fc_out_channels)
        self.fc_cls = Dense(fc_out_channels, num_classes + 1,
                            kernel_init=('normal', 0.01))
        c = reg_feat_channels
        self.reg_pre_conv0 = Conv(in_channels, c, 3, 1, 1)
        self.reg_pre_conv1 = Conv(c, c, 3, 1, 1)
        for axis in ('x', 'y'):
            self.add_module(f'reg_conv_att_{axis}', Conv(
                c, 1, 3, 1, 1, kernel_init=('normal', 0.01)))
            self.add_module(f'{axis}_post', Conv1d(c, c, 3, padding=1))
            self.add_module(f'{axis}_up', ConvTranspose1d(c, c, up_ratio))
            self.add_module(f'{axis}_off_fc', Dense(
                c, c, kernel_init='lecun_normal'))
            self.add_module(f'{axis}_cls_fc', Dense(
                c, c, kernel_init='lecun_normal'))
            self.add_module(f'{axis}_off', Dense(
                c, 1, kernel_init=('normal', 0.001)))
            self.add_module(f'{axis}_cls', Dense(
                c, 1, kernel_init=('normal', 0.01)))

    def _axis(self, f, axis):
        """(N, C, L) pooled features -> (offsets, bucket logits), (N, 2L)
        each."""
        f = F.relu(getattr(self, f'{axis}_post')(f))
        f = F.relu(getattr(self, f'{axis}_up')(f)).transpose(1, 2)
        off = getattr(self, f'{axis}_off')(F.relu(
            getattr(self, f'{axis}_off_fc')(f)))[..., 0]
        cls = getattr(self, f'{axis}_cls')(F.relu(
            getattr(self, f'{axis}_cls_fc')(f)))[..., 0]
        return off, cls

    def _split(self, feat):
        """The first half ++ the reversed second half."""
        half = self.up // 2
        return torch.cat([feat[:, :self.up - half],
                          feat[:, half:].flip(-1)], dim=-1)

    def forward(self, roi_feats):
        """(N, 7, 7, C) -> (class logits (N, C + 1), bucket logits (N, 4S),
        bucket offsets (N, 4S))."""
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = F.relu(self.cls_fc1(F.relu(self.cls_fc0(x))))
        cls = self.fc_cls(x)
        r = roi_feats.permute(0, 3, 1, 2)
        r = F.relu(self.reg_pre_conv1(F.relu(self.reg_pre_conv0(r))))
        att_x = torch.sigmoid(self.reg_conv_att_x(r))  # (N, 1, H, W)
        att_y = torch.sigmoid(self.reg_conv_att_y(r))
        att_x = att_x / torch.clamp_min(att_x.sum(2, keepdim=True), 1e-6)
        att_y = att_y / torch.clamp_min(att_y.sum(3, keepdim=True), 1e-6)
        off_x, cls_x = self._axis((r * att_x).sum(2), 'x')  # (N, C, W)
        off_y, cls_y = self._axis((r * att_y).sum(3), 'y')  # (N, C, H)
        bucket_cls = torch.cat([self._split(cls_x), self._split(cls_y)], -1)
        bucket_off = torch.cat([self._split(off_x), self._split(off_y)], -1)
        return cls, bucket_cls, bucket_off


@HEADS.register_module()
class SABLRoIHead(StandardRoIHead):
    """``StandardRoIHead``'s keyword arguments and tpudet's SABL fields
    (``sabl_roi_head.py:135-139``)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 num_buckets: int = 14, scale_factor: float = 1.7,
                 loss_bucket_cls_weight: float = 1.0,
                 loss_bucket_reg_weight: float = 1.0, **kwargs):
        super().__init__(num_classes, in_channels, **kwargs)
        self.bbox_head = SABLBBoxHead(num_classes, in_channels,
                                      roi_feat_size=self.roi_size,
                                      num_buckets=num_buckets)
        self.bucket_coder = BucketingBBoxCoder(num_buckets, scale_factor)
        self.loss_bucket_cls_weight = loss_bucket_cls_weight
        self.loss_bucket_reg_weight = loss_bucket_reg_weight

    def forward(self, feats, rois, roi_valid):
        """Pool and run the SABL head: (B, P, C + 1) logits and ((B, P, 4S)
        bucket logits, (B, P, 4S) offsets)."""
        pooled = self.extract(feats, rois, roi_valid)
        b, p = pooled.shape[:2]
        cls, bc, bo = self.bbox_head(pooled.flatten(0, 1))
        return (cls.unflatten(0, (b, p)),
                (bc.unflatten(0, (b, p)), bo.unflatten(0, (b, p))))

    def loss(self, cls_logits, deltas, labels, targets, pos, sampled,
             rois=None) -> Dict[str, torch.Tensor]:
        bucket_cls, bucket_off = deltas
        num_total = torch.clamp_min(global_sum(sampled.float().sum()), 1.0)
        logp = F.log_softmax(cls_logits.float(), dim=-1)
        ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
        loss_cls = (ce * sampled).sum() / num_total
        gt_boxes = self.bbox_coder.decode(rois, targets)
        b_lab, b_clsw, b_off, b_offw = self.bucket_coder.encode(rois,
                                                                gt_boxes)
        s = self.bucket_coder.side_num
        bc = bucket_cls.float().reshape(b_lab.shape)
        bo = bucket_off.float().reshape(b_off.shape)
        w = pos[..., None, None].float()
        num_pos = torch.clamp_min(global_sum(pos.float().sum()), 1.0)
        bce = L.binary_cross_entropy_with_logits(bc, b_lab)
        loss_bucket_cls = self.loss_bucket_cls_weight * (
            bce * b_clsw * w).sum() / (num_pos * 4 * s)
        sl1 = L.smooth_l1_loss(bo, b_off, beta=1.0 / 9.0, reduction='none')
        loss_bucket_reg = self.loss_bucket_reg_weight * (
            sl1 * b_offw * w).sum() / (num_pos * 4)
        return dict(loss_cls=loss_cls, loss_bucket_cls=loss_bucket_cls,
                    loss_bucket_reg=loss_bucket_reg)

    def get_bboxes(self, rois, roi_valid, cls_logits, deltas,
                   scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.5, max_per_img: int = 100, **kwargs):
        bucket_cls, bucket_off = deltas
        scores = F.softmax(cls_logits.float(), dim=-1)[..., :-1]
        boxes, conf = self.bucket_coder.decode(
            rois.float(), (bucket_cls.float(), bucket_off.float()))
        scores = scores * conf[..., None] * roi_valid[..., None]
        if scale_factors is not None:
            boxes = boxes / torch.as_tensor(
                scale_factors, dtype=boxes.dtype,
                device=boxes.device)[:, None, :]
        b, p, c = scores.shape
        return pair_nms(boxes[:, :, None].expand(b, p, c, 4), scores,
                        score_thr, iou_thr, max_per_img)


@DETECTORS.register_module()
class SABLFasterRCNN(TwoStageDetector):
    """Named wrapper for configs/sabl/sabl_faster_rcnn_* (the configs keep
    ``type='FasterRCNN'`` with the ``SABLRoIHead``)."""
