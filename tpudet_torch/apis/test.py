"""Batched COCO-val testing: counterpart of ``single_device_test`` in
``tpudet/apis/test.py:132-293``, on its plain path: one process, no
test-time augmentation, no masks.

The model's forward, decode and NMS run on the model's device; the split
into per-class arrays runs on the host.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..data.loader import DetDataLoader
from .inference import nms_result_to_per_class


def single_device_test(model, dataset, batch_size: int = 8,
                       img_size: int = 640, progress: bool = True,
                       infer_fn=None) -> List[list]:
    """Run detection over a test-mode dataset (its pipeline on the model's
    device); returns per-image per-class (n, 5) arrays in dataset order.

    Batches are padded to ``img_size`` squares. ``infer_fn(img,
    scale_factor, img_hw) -> NMSResult`` replaces the model's forward,
    decode and NMS, as in tpudet (which also passes its variables)."""
    # single-stage heads, two-stage RoI heads, or the proposal-only RPN
    if hasattr(model, 'bbox_head'):
        num_classes = model.bbox_head.num_classes
    elif hasattr(model, 'roi_head'):
        num_classes = model.roi_head.num_classes
    else:
        num_classes = 1
    device = next(model.parameters()).device

    def infer(img, scale_factor, img_hw):
        pred_maps = model(img)
        # per-image (h, w) columns; the YOLO head takes them and does not
        # clip to the image, as tpudet's
        return model.get_bboxes(pred_maps, scale_factors=scale_factor,
                                img_shape=(img_hw[:, 0:1], img_hw[:, 1:2]))

    loader = DetDataLoader(dataset, batch_size=batch_size, max_gts=1,
                           img_size=img_size, shuffle=False,
                           drop_last=False)
    results: List[Optional[list]] = [None] * len(dataset)
    done = 0
    model.eval()
    with torch.inference_mode():
        for batch in loader:
            img = batch['img'].to(device)
            img_hw = torch.as_tensor(
                np.array([m['img_shape'][:2] if m.get('img_shape')
                          else img.shape[1:3] for m in batch['img_metas']],
                         np.float32), device=device)
            scale_factor = torch.as_tensor(batch['scale_factor'],
                                           device=device)
            res = (infer_fn or infer)(img, scale_factor, img_hw)
            per_img = nms_result_to_per_class(res, num_classes)
            for out, meta in zip(per_img, batch['img_metas']):
                if results[meta['_idx']] is None:
                    results[meta['_idx']] = out
            done += len(batch['img_metas'])
            if progress and done % (batch_size * 20) == 0:
                print(f'tested {done}/{len(dataset)}')
    return [r for r in results if r is not None]
