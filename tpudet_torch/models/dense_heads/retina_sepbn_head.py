"""NAS-FPN's RetinaNet head with a BatchNorm per level: port of
``tpudet/models/dense_heads/retina_sepbn_head.py``.

The towers' bias-free 3x3 convs (``cls_conv{i}``, ``reg_conv{i}``,
N(0, 0.01^2)) are shared by the levels; each level normalises with its
own BN (``cls_bn{i}_l{lvl}``: flax's momentum 0.9, tpudet's ``BN_EPS``
1e-5) before the ReLU. ``retina_cls`` / ``retina_reg``, the loss and the
decode are ``RetinaHead``'s.
"""
from __future__ import annotations

import torch.nn.functional as F

from ...registry import HEADS
from ..layers import BatchNorm2d, Conv
from .retina_head import RetinaHead


@HEADS.register_module()
class RetinaSepBNHead(RetinaHead):
    """``RetinaHead``'s keyword arguments and ``num_ins``, the levels."""

    def __init__(self, num_classes: int, num_ins: int = 5,
                 in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 4, **kwargs):
        super().__init__(num_classes, in_channels=in_channels,
                         feat_channels=feat_channels,
                         stacked_convs=stacked_convs, **kwargs)
        self.num_ins = num_ins
        for branch in ('cls', 'reg'):
            cin = in_channels
            for i in range(stacked_convs):
                # shared by the levels; the bias is the BNs'
                self.add_module(f'{branch}_conv{i}', Conv(
                    cin, feat_channels, 3, 1, 1, bias=False,
                    kernel_init=('normal', 0.01)))
                for lvl in range(num_ins):
                    self.add_module(f'{branch}_bn{i}_l{lvl}', BatchNorm2d(
                        feat_channels, eps=1e-5, momentum=0.1))
                cin = feat_channels

    def forward(self, feats):
        assert len(feats) == self.num_ins
        cls_out, reg_out = [], []
        for lvl, feat in enumerate(feats):
            c = r = feat
            for i in range(self.stacked_convs):
                c = F.relu(getattr(self, f'cls_bn{i}_l{lvl}')(
                    getattr(self, f'cls_conv{i}')(c)))
                r = F.relu(getattr(self, f'reg_bn{i}_l{lvl}')(
                    getattr(self, f'reg_conv{i}')(r)))
            cls_out.append(self.retina_cls(c).permute(0, 2, 3, 1))
            reg_out.append(self.retina_reg(r).permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(reg_out)
