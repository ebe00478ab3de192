"""Prime Sample Attention's weights: port of the functions of
``tpudet/models/dense_heads/pisa_heads.py:33-74`` that the PISA RoI head
uses (``EPS``, ``isr_weights_masks``, ``carl_weights``).

- ISR-P (``isr_weights_masks``): each positive's importance from its
  IoU-hierarchical-local rank, first among the positives of its gt by IoU,
  then among those of its class by that rank plus IoU, as ``(bias + w (1 -
  bias))^k`` with ``w = (max_l_num - rank) / max_l_num``; ranks count the
  strictly greater others, so ties share a rank;
- CARL (``carl_weights``): each positive's regression weight from its
  class score, ``(bias + (1 - bias) p)^k``, rescaled so that the weights
  sum to the positive count. Both the count and the sum run over every
  rank's batch (``parallel/mesh.py``), the sum with its gradient: tpudet's
  weights are not stop-gradient.

``PISARetinaHead`` and ``PISASSDHead`` are not ported: no config of the
repo builds them.
"""
from __future__ import annotations

import torch

from ...parallel.mesh import global_sum, global_sum_with_grad

EPS = 1e-12


def isr_weights_masks(ious, same_gt, same_label, pos, k: float = 2.0,
                      bias: float = 0.0):
    """Dense IoU-HLR importance weights (``pisa_heads.py:36-53``).

    Args:
        ious, pos: (K,) IoUs of the decoded predictions with their
            targets, and the positive mask.
        same_gt, same_label: (K, K) pairwise masks, already restricted to
            pairs of positives.

    Returns:
        (K,) weights, 1 where not positive.
    """
    label_cnt = same_label.sum(dim=1)
    max_l_num = torch.clamp_min(
        torch.where(pos, label_cnt, torch.zeros_like(label_cnt)).max(), 1)
    rank_gt = (same_gt & (ious[None, :] > ious[:, None])).sum(dim=1)
    iou2 = ious + (max_l_num - rank_gt).to(ious.dtype)
    rank_l = (same_label & (iou2[None, :] > iou2[:, None])).sum(dim=1)
    w = (max_l_num - rank_l).float() / max_l_num.float()
    imp = (bias + w * (1 - bias)) ** k
    return torch.where(pos, imp, torch.ones_like(imp))


def carl_weights(pos_cls_score, pos, k: float = 1.0, bias: float = 0.2):
    """(K,) classification-aware regression weights whose sum over every
    rank's positives is their count (``pisa_heads.py:68-74``)."""
    w = (bias + (1 - bias) * pos_cls_score) ** k
    w = torch.where(pos, w, torch.zeros_like(w))
    num_pos = global_sum(pos.float().sum())
    return w * num_pos / torch.clamp_min(global_sum_with_grad(w.sum()), EPS)
