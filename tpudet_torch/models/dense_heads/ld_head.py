"""Localization distillation: port of
``tpudet/models/dense_heads/ld_head.py`` (``LDHead``,
``KnowledgeDistillationSingleStageDetector``).

``LDHead`` is ``GFLHead`` with one more term, ``loss_ld``: the KL
divergence of the student's bin distributions from the teacher's, both
softened by ``ld_T`` (``kd_kl_div_loss``, times T^2), averaged over the
bins and the four sides, weighted by the DFL's weights (the detached best
class probability at the positives) and summed: ``ld_weight * sum(kd *
w)``. Unlike the DFL and GIoU terms it is not divided by the weights' sum
(``ld_head.py:75-80``).

The detector holds a frozen teacher (``teacher_backbone``,
``teacher_neck``, ``teacher_bbox_head``, built from the config's
``teacher_config``; ``models/builder.py``). ``forward`` (inference) never
runs it. ``forward_train`` runs it without gradient, in its own parameters'
dtype (fp32, whatever the student computes in), and always in eval mode:
BatchNorm reads its running statistics and never updates them, as
tpudet's ``train=False`` call does. ``set_dtype`` leaves it in fp32.

Its parameters sit in the train state as tpudet's do: they get zero
gradients, and SGD's weight decay and momentum still move their conv
kernels every step, as tpudet's step moves them (ROADMAP.md, "Faults in
tpudet"). A tpudet tree from ``init`` (no teacher subtree: only
``forward_train`` creates it) loads with the teacher left as built.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...registry import DETECTORS, HEADS
from .. import losses as L
from ..detectors.single_stage import SingleStageDetector
from ..layers import cast_weights
from .gfl_head import GFLHead

TEACHER = ('teacher_backbone', 'teacher_neck', 'teacher_bbox_head')


@HEADS.register_module()
class LDHead(GFLHead):
    """``GFLHead``'s fields and ``ld_T``, ``ld_weight``
    (``ld_head.py:29-33``)."""

    def __init__(self, *args, ld_T: float = 10.0, ld_weight: float = 0.25,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.ld_T = ld_T
        self.ld_weight = ld_weight

    def loss_with_teacher(self, preds, teacher_preds, gt_bboxes, gt_labels,
                          gt_valid) -> Dict[str, torch.Tensor]:
        """GFL's losses and ``loss_ld`` (``ld_head.py:58-82``)."""
        losses, w = self.loss_and_weights(preds, gt_bboxes, gt_labels,
                                          gt_valid)
        b, nb = preds[1][0].shape[0], self.reg_max + 1

        def bins(maps):
            return torch.cat([m.reshape(b, -1, 4, nb).float() for m in maps],
                             dim=1)
        kd = L.kd_kl_div_loss(bins(preds[1]), bins(teacher_preds[1]).detach(),
                              T=self.ld_T, reduction='none')  # (B, A, 4)
        losses['loss_ld'] = self.ld_weight * (kd.mean(dim=-1) * w).sum()
        return losses


@DETECTORS.register_module()
class KnowledgeDistillationSingleStageDetector(SingleStageDetector):
    """Student and frozen teacher (``ld_head.py:85-103``)."""

    # teacher subtrees a tpudet tree may lack (``utils/flax_import``)
    flax_optional = TEACHER

    def __init__(self, backbone: nn.Module, bbox_head: nn.Module,
                 neck: Optional[nn.Module] = None,
                 train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None,
                 teacher_backbone: Optional[nn.Module] = None,
                 teacher_neck: Optional[nn.Module] = None,
                 teacher_bbox_head: Optional[nn.Module] = None):
        super().__init__(backbone, bbox_head, neck, train_cfg, test_cfg)
        self.teacher_backbone = teacher_backbone
        self.teacher_neck = teacher_neck
        self.teacher_bbox_head = teacher_bbox_head

    def set_dtype(self, dtype: torch.dtype):
        """The student's compute dtype (``backbone``, ``neck``,
        ``bbox_head``, as tpudet's ``compute_dtype`` reaches only those);
        the teacher keeps fp32."""
        for part in (self.backbone, self.neck, self.bbox_head):
            if part is not None:
                cast_weights(part, dtype)
        self.dtype = dtype
        return self

    def train(self, mode: bool = True):
        """Train mode for the student; the teacher stays in eval mode."""
        super().train(mode)
        for name in TEACHER:
            if getattr(self, name) is not None:
                getattr(self, name).eval()
        return self

    @torch.no_grad()
    def teacher_forward(self, img):
        """The teacher's pred maps of the normalized image batch (B, H, W,
        3), without gradient, in its parameters' dtype."""
        dtype = next(self.teacher_backbone.parameters()).dtype
        x = self.teacher_backbone(img.to(dtype).permute(0, 3, 1, 2))
        if self.teacher_neck is not None:
            x = self.teacher_neck(x)
        return self.teacher_bbox_head(x)

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid):
        """The student's losses and ``loss_ld`` against the teacher."""
        preds = self(img)
        return self.bbox_head.loss_with_teacher(
            preds, self.teacher_forward(img), gt_bboxes, gt_labels, gt_valid)
