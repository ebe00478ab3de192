"""YOLACT: port of ``tpudet/models/dense_heads/yolact_head.py``
(``YOLACTHead``, ``YOLACTProtonet``, ``YOLACTSegmHead``, ``YOLACT``).

- ``YOLACTHead``: one shared 3x3 conv with ReLU a level, then 3x3 convs to
  softmax class logits (C + 1, background last), deltas and tanh'd
  prototype coefficients (fp32), 3 ratios x 1 scale of anchors a cell;
  its loss assigns by MaxIoU (0.5 / 0.4) keeping only a gt's first best
  anchor (the config's ``gt_max_assign_all=False``), the CE of the
  positives and of the 3x hardest negatives an image (all its negatives
  where it has no positive; ranks by a stable sort) and 1.5 x the smooth
  L1 of the positives, both over the sum of max(positives, 1) an image;
- ``get_bboxes``: the softmax without the background column, the top
  ``nms_pre`` anchors by their best class (ties by index), their decoded
  boxes, then ``core/nms.batched_fast_nms`` with each detection's row, for
  its coefficients;
- ``YOLACTProtonet`` on P3: three 3x3 convs, a nearest 2x upsample, a
  3x3 conv and the ReLU'd 1x1 to 32 prototypes (stride 4, fp32);
  ``YOLACTSegmHead``: a 1x1 conv to per-class logits on P3 (fp32);
- ``YOLACT.forward_train``: the head's loss; the mask loss of up to
  ``max_masks`` positives an image (of a MaxIoU assignment that keeps
  every best anchor, as tpudet's): each prediction ``protos . coeffs``
  RoIAligned into its gt box (at stride 4) at the gt-frame masks' size
  and BCE'd against them, the mean over the pixels summed over the
  positives, 6.125 x that over max(positives, 1); the semantic loss: the
  BCE of the segm logits against each class's rasterised gt boxes over
  every pixel;
- ``predict_masks(outputs)``: the detections of the decode and fast NMS,
  each mask ``sigmoid(RoIAlign(protos . coeffs))`` at 28 x 28 in its box
  in the network input's frame, the boxes rescaled afterwards: the test
  flow's ``'proto'`` mode.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import AnchorGenerator
from ...core.assigners import NEGATIVE, max_iou_assign_batch
from ...core.bbox import DeltaXYWHBBoxCoder
from ...core.nms import NMSResult, _gather_rows, batched_fast_nms, topk_scores
from ...ops.roi_align import batched_roi_align
from ...parallel.mesh import global_count, global_sum
from ...registry import DETECTORS, HEADS
from .. import losses as L
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv


def _conv3(cin, cout, kernel_init='he_normal'):
    return Conv(cin, cout, 3, 1, 1, kernel_init=kernel_init)


@HEADS.register_module()
class YOLACTHead(nn.Module):
    """The keyword arguments are tpudet's fields (``yolact_head.py:
    37-51``) with its defaults."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, num_head_convs: int = 1,
                 num_protos: int = 32,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 octave_base_scale: int = 3,
                 ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4,
                 neg_pos_ratio: int = 3, loss_bbox_weight: float = 1.5):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.num_protos = num_protos
        self.num_anchors = len(ratios)
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.neg_pos_ratio = neg_pos_ratio
        self.loss_bbox_weight = loss_bbox_weight
        self.num_head_convs = num_head_convs
        self.anchor_generator = AnchorGenerator(
            strides=list(strides), ratios=list(ratios),
            octave_base_scale=octave_base_scale, scales_per_octave=1)
        self.bbox_coder = DeltaXYWHBBoxCoder(target_stds=target_stds)
        cin = in_channels
        for i in range(num_head_convs):
            self.add_module(f'head_conv{i}', _conv3(cin, feat_channels))
            cin = feat_channels
        a = self.num_anchors
        self.conv_cls = _conv3(cin, a * (num_classes + 1), ('normal', 0.01))
        self.conv_reg = _conv3(cin, a * 4, ('normal', 0.01))
        self.conv_coeff = _conv3(cin, a * num_protos, ('normal', 0.01))
        self._grids: Dict = {}

    def forward(self, feats):
        """NCHW levels -> per-level NHWC (class logits (B, H, W, A(C+1)),
        deltas (.., A*4), coefficients (.., A*P) tanh'd in fp32)."""
        cls_out, reg_out, coeff_out = [], [], []
        for x in feats:
            for i in range(self.num_head_convs):
                x = F.relu(getattr(self, f'head_conv{i}')(x))
            cls_out.append(self.conv_cls(x).permute(0, 2, 3, 1))
            reg_out.append(self.conv_reg(x).permute(0, 2, 3, 1))
            coeff_out.append(torch.tanh(
                self.conv_coeff(x).float()).permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(reg_out), tuple(coeff_out)

    def anchors(self, cls_scores):
        """All levels' anchors (A, 4) on the maps' device (cached)."""
        sizes = tuple(tuple(c.shape[1:3]) for c in cls_scores)
        key = (sizes, cls_scores[0].device)
        if key not in self._grids:
            self._grids[key] = torch.from_numpy(np.concatenate(
                self.anchor_generator.grid_anchors(sizes))).to(key[1])
        return self._grids[key]

    def flatten(self, preds):
        """(B, A, C + 1) fp32 logits, (B, A, 4) fp32 deltas, (B, A, P)
        coefficients over every level's anchors."""
        cls_scores, bbox_preds, coeffs = preds
        b = cls_scores[0].shape[0]
        return (torch.cat([c.reshape(b, -1, self.num_classes + 1).float()
                           for c in cls_scores], dim=1),
                torch.cat([r.reshape(b, -1, 4).float() for r in bbox_preds],
                          dim=1),
                torch.cat([c.reshape(b, -1, self.num_protos) for c in coeffs],
                          dim=1))

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """OHEM softmax CE and 1.5 x smooth L1 (``yolact_head.py:
        117-167``)."""
        anchors = self.anchors(preds[0])
        cls_flat, reg_flat, _ = self.flatten(preds)
        gt_bboxes = gt_bboxes.float()
        assigned = max_iou_assign_batch(
            anchors, gt_bboxes, gt_valid, self.pos_iou_thr,
            self.neg_iou_thr, 0., True, gt_max_assign_all=False)
        pos = assigned >= 0
        neg = assigned == NEGATIVE
        n_pos_img = pos.float().sum(dim=1, keepdim=True)
        num_pos = global_sum(torch.clamp_min(n_pos_img, 1.0).sum())
        gt_idx = assigned.clamp_min(0)
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gt_idx),
                             self.num_classes)
        logp = F.log_softmax(cls_flat, dim=-1)
        ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
        neg_loss = torch.where(neg, ce, ce.new_full((), -1.0))
        rank = torch.argsort(torch.argsort(-neg_loss, dim=1, stable=True),
                             dim=1, stable=True)
        neg_limit = torch.where(n_pos_img > 0, self.neg_pos_ratio * n_pos_img,
                                torch.full_like(n_pos_img, float('inf')))
        hard_neg = neg & (rank < neg_limit)
        loss_cls = (ce * (pos | hard_neg).float()).sum() / num_pos
        matched = torch.where(pos[..., None], _gather_rows(gt_bboxes, gt_idx),
                              anchors[None].expand(pos.shape + (4,)))
        targets = self.bbox_coder.encode(anchors[None], matched)
        loss_bbox = L.smooth_l1_loss(
            reg_flat, targets, beta=1.0, weight=pos[..., None].float(),
            avg_factor=num_pos, loss_weight=self.loss_bbox_weight)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    num_gts=gt_valid.float().sum() / global_count(
                        gt_valid.shape[0], gt_valid.device))

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.5, max_per_img: int = 100,
                   nms_pre: int = 1000, **kwargs):
        """``(NMSResult, coefficients (B, max_per_img, P))`` of the top
        ``nms_pre`` anchors' fast NMS; ``kwargs`` (``img_shape``) are not
        read: the boxes are not clipped, as tpudet's."""
        anchors = self.anchors(preds[0])
        cls_flat, reg_flat, coeff_flat = self.flatten(preds)
        scores = F.softmax(cls_flat, dim=-1)[..., :-1]
        boxes = self.bbox_coder.decode(anchors[None], reg_flat)
        k = min(nms_pre, boxes.shape[1])
        _, top = topk_scores(scores.amax(dim=-1), k)
        boxes = _gather_rows(boxes, top)
        scores = _gather_rows(scores, top)
        coeff_sel = _gather_rows(coeff_flat, top)
        if scale_factors is not None:
            boxes = boxes / torch.as_tensor(
                scale_factors, dtype=boxes.dtype,
                device=boxes.device)[:, None, :]
        res, keep = batched_fast_nms(boxes, scores, score_thr, iou_thr,
                                     max_per_img=max_per_img,
                                     return_indices=True)
        return res, _gather_rows(coeff_sel, keep)


@HEADS.register_module()
class YOLACTProtonet(nn.Module):
    """P3 (B, C, H, W) -> (B, 2H, 2W, num_protos) fp32 prototypes."""

    def __init__(self, num_protos: int = 32, in_channels: int = 256):
        super().__init__()
        cin = in_channels
        for i in range(3):
            self.add_module(f'conv{i}', _conv3(cin, 256))
            cin = 256
        self.conv3 = _conv3(256, 256)
        self.conv_out = Conv(256, num_protos, 1)

    def forward(self, p3):
        x = p3
        for i in range(3):
            x = F.relu(getattr(self, f'conv{i}')(x))
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        x = F.relu(self.conv3(x))
        return F.relu(self.conv_out(x)).float().permute(0, 2, 3, 1)


@HEADS.register_module()
class YOLACTSegmHead(nn.Module):
    """P3 -> (B, H, W, num_classes) fp32 semantic logits."""

    def __init__(self, num_classes: int, in_channels: int = 256):
        super().__init__()
        self.segm_conv = Conv(in_channels, num_classes, 1,
                              kernel_init=('normal', 0.01))

    def forward(self, p3):
        return self.segm_conv(p3).float().permute(0, 2, 3, 1)


def crop_masks(protos, coeffs, boxes, size: int, stride: int):
    """Each detection's mask logits ``protos . coeffs`` ((B, H, W, P) .
    (B, K, P)) RoIAligned into its box ``/ stride`` at ``size``: (B, K,
    size, size)."""
    b, k = coeffs.shape[:2]
    maps = torch.einsum('bhwp,bkp->bkhw', protos, coeffs)
    crops = batched_roi_align(maps.reshape((b * k,) + maps.shape[2:] + (1,)),
                              (boxes / stride).reshape(b * k, 1, 4), size)
    return crops.reshape(b, k, size, size)


@DETECTORS.register_module()
class YOLACT(SingleStageDetector):
    """``forward(img)`` -> ``(head outputs, prototypes, segm logits)``;
    ``mask_proto_stride``, ``max_masks`` and ``loss_mask_weight`` are
    tpudet's fields."""

    def __init__(self, backbone: nn.Module, bbox_head: nn.Module,
                 neck: Optional[nn.Module] = None,
                 train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None,
                 mask_proto_stride: int = 4, max_masks: int = 100,
                 loss_mask_weight: float = 6.125):
        super().__init__(backbone, bbox_head, neck, train_cfg, test_cfg)
        self.mask_proto_stride = mask_proto_stride
        self.max_masks = max_masks
        self.loss_mask_weight = loss_mask_weight
        self.protonet = YOLACTProtonet(bbox_head.num_protos,
                                       bbox_head.in_channels)
        self.segm_head = YOLACTSegmHead(bbox_head.num_classes,
                                        bbox_head.in_channels)

    def forward(self, img):
        feats = self.extract_feat(img.to(self.dtype).permute(0, 3, 1, 2))
        return (self.bbox_head(feats), self.protonet(feats[0]),
                self.segm_head(feats[0]))

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid,
                      gt_frame_masks) -> Dict[str, torch.Tensor]:
        preds, protos, segm = self(img)
        head = self.bbox_head
        losses = head.loss(preds, gt_bboxes, gt_labels, gt_valid)
        gt_bboxes = gt_bboxes.float()
        anchors = head.anchors(preds[0])
        _, _, coeff_flat = head.flatten(preds)
        assigned = max_iou_assign_batch(anchors, gt_bboxes, gt_valid,
                                        head.pos_iou_thr, head.neg_iou_thr,
                                        0., True)
        pos = assigned >= 0
        k = min(self.max_masks, assigned.shape[1])
        order = torch.argsort((~pos).to(torch.int32), dim=1,
                              stable=True)[:, :k]
        sel_pos = torch.gather(pos, 1, order)
        sel_gt = torch.gather(assigned.clamp_min(0), 1, order)
        sel_coeff = _gather_rows(coeff_flat, order)
        crops = crop_masks(protos, sel_coeff, _gather_rows(gt_bboxes, sel_gt),
                           gt_frame_masks.shape[-1], self.mask_proto_stride)
        tgt = _gather_rows(gt_frame_masks.to(crops.dtype), sel_gt)
        bce = L.binary_cross_entropy_with_logits(crops, tgt.clamp(0., 1.))
        w = sel_pos.to(crops.dtype)
        losses['loss_mask'] = self.loss_mask_weight * (
            bce.mean(dim=(2, 3)) * w).sum() / torch.clamp_min(
                global_sum(w.sum()), 1.0)

        b, sh, sw = segm.shape[:3]
        stride = img.shape[1] / sh
        ys = (torch.arange(sh, dtype=torch.float32, device=img.device) +
              0.5) * stride
        xs = (torch.arange(sw, dtype=torch.float32, device=img.device) +
              0.5) * stride
        bx = gt_bboxes[..., None, None, :]  # (B, G, 1, 1, 4)
        inside = ((xs >= bx[..., 0]) & (xs <= bx[..., 2]) &
                  (ys[:, None] >= bx[..., 1]) & (ys[:, None] <= bx[..., 3]) &
                  gt_valid[..., None, None])  # (B, G, sh, sw)
        classes = torch.arange(head.num_classes, device=img.device)
        onehot = (gt_labels.long()[..., None] == classes).to(segm.dtype)
        segm_tgt = (inside[..., None].to(segm.dtype) *
                    onehot[:, :, None, None, :]).amax(dim=1)
        losses['loss_segm'] = L.bce_loss(
            segm, segm_tgt,
            avg_factor=global_count(b, img.device) * sh * sw)
        return losses

    def _decode(self, outputs, **kwargs):
        """The head's decode and fast NMS by ``test_cfg`` (``kwargs``
        override): ``(res, coefficients, prototypes, scale factors)``; the
        boxes stay in the network input's frame."""
        preds, protos, _ = outputs
        cfg = dict(self.test_cfg or {})
        nms_cfg = cfg.pop('nms', None)
        if nms_cfg is not None:
            cfg['iou_thr'] = nms_cfg.get('iou_threshold', 0.5)
        cfg.pop('min_bbox_size', None)
        cfg.pop('mask_thr', None)
        scale_factors = cfg.pop('scale_factors', None)
        scale_factors = kwargs.pop('scale_factors', scale_factors)
        cfg.update(kwargs)
        res, coeffs = self.bbox_head.get_bboxes(preds, **cfg)
        return res, coeffs, protos, scale_factors

    @staticmethod
    def _rescale(res, scale_factors):
        if scale_factors is None:
            return res
        sf = torch.as_tensor(scale_factors, dtype=res.bboxes.dtype,
                             device=res.bboxes.device)
        return res._replace(bboxes=res.bboxes / sf[:, None, :])

    def get_bboxes(self, outputs, **kwargs) -> NMSResult:
        res, _, _, scale_factors = self._decode(outputs, **kwargs)
        return self._rescale(res, scale_factors)

    def predict_masks(self, outputs, mask_size: int = 28, **kwargs):
        """``(detections rescaled by scale_factors, (B, D, mask_size,
        mask_size) probabilities)``, each mask cropped with its box in the
        network input's frame."""
        res, coeffs, protos, scale_factors = self._decode(outputs, **kwargs)
        masks = torch.sigmoid(crop_masks(protos, coeffs, res.bboxes,
                                         mask_size, self.mask_proto_stride))
        return self._rescale(res, scale_factors), masks
