"""Batched COCO-val testing: counterpart of ``tpudet/apis/test.py``
(``single_device_test`` with its flip test-time augmentation
``tta_get_bboxes``, its mask path ``_mask_mode`` (the Mask R-CNN family's
``'roi'``, PointRend's ``'roi_labels'``, YOLACT's ``'proto'``) and
``masks_to_segm_results``, and its sharding over processes
``merge_sharded_results`` and ``_gather_object_shards``).

The model's forward, decode and NMS run on the model's device; the split
into per-class arrays runs on the host. With masks, the paste and the
RLE's run boundaries run on the device too (``core/mask.py``); only the
boundaries cross to the host.
"""
from __future__ import annotations

import inspect
from typing import List, Optional

import numpy as np
import torch

from ..core.mask import encode_rle_batch, paste_masks
from ..core.nms import batched_nms
from ..data.loader import DetDataLoader
from ..parallel.mesh import all_gather_object, is_distributed
from ..parallel.mesh import process_count as group_size
from ..parallel.mesh import process_index as group_rank
from .inference import nms_result_to_per_class


def tta_get_bboxes(model, aug_imgs, aug_scale_factors, aug_flips,
                   score_thr=0.001, iou_thr=0.65, max_per_img=300,
                   nms_pre=4096):
    """Test-time augmentation (``tpudet/apis/test.py:20-54``): each
    augmented batch through the model and the head's decode without NMS
    (``bbox_head.get_bboxes(..., with_nms=False)``, so a head without that
    argument raises), its boxes mapped back to the original images
    (divided by the scale factors; a flipped batch's x mirrored about
    ``w = canvas_w / sf_x``, the canvas's width in the original frame),
    the candidate sets concatenated, then one ``batched_nms`` of the top
    ``nms_pre`` (box, class) pairs.

    Args:
        aug_imgs: list of (B, H, W, 3) tensors, one per augmentation.
        aug_scale_factors: list of (B, 4) letterbox scale factors.
        aug_flips: list of bool (horizontal flip applied?).
    """
    all_boxes, all_scores = [], []
    for img, sf, flip in zip(aug_imgs, aug_scale_factors, aug_flips):
        out = model.bbox_head.get_bboxes(model(img), with_nms=False)
        bbox, scores = out[0], out[1]
        if flip:
            w = img.shape[2] / sf[:, None, 0]  # original-space width
            x1 = w - bbox[..., 2] / sf[:, None, 0]
            x2 = w - bbox[..., 0] / sf[:, None, 0]
            bbox = torch.stack([x1, bbox[..., 1] / sf[:, None, 1], x2,
                                bbox[..., 3] / sf[:, None, 3]], dim=-1)
        else:
            bbox = bbox / sf[:, None, :]
        all_boxes.append(bbox)
        all_scores.append(scores)
    return batched_nms(torch.cat(all_boxes, dim=1),
                       torch.cat(all_scores, dim=1), score_thr, iou_thr,
                       max_per_img, nms_pre=nms_pre)


def _mask_mode(model):
    """The detector's mask-prediction API, if any (``tpudet/apis/test.py:
    58-68``): ``'proto'`` for YOLACT (``predict_masks(outputs)`` -> ``(res,
    masks)``), ``'roi_labels'`` for PointRend (``predict_masks(img, boxes,
    valid, labels)`` -> (B, D, R, R)), ``'roi'`` for the Mask R-CNN family
    (``predict_masks(img, boxes, valid)`` -> (B, D, s, s, C))."""
    if not hasattr(model, 'predict_masks'):
        return None
    params = list(inspect.signature(model.predict_masks).parameters)
    if 'outputs' in params:
        return 'proto'
    if 'det_labels' in params:
        return 'roi_labels'
    return 'roi'


def predict_masks(model, img, scale_factor):
    """Detections and each one's mask probabilities of its predicted class
    for an image batch (tpudet's ``infer_masks``, ``tpudet/apis/test.py:
    215-231``): YOLACT's decode crops its masks with the boxes in the
    network input's frame and rescales the boxes after; the RoI modes take
    the detections of the model's forward (``scale_factor`` maps them to
    the original images) and run the mask branch on them in the network
    input's frame, on the same call's features. Returns ``(NMSResult,
    probs (B, D, s, s))``."""
    mode = _mask_mode(model)
    if mode == 'proto':
        return model.predict_masks(model(img), scale_factors=scale_factor)
    feats = model.extract_feat(img)
    res = model.get_bboxes(model.detect(feats, tuple(img.shape[1:3])),
                           scale_factors=scale_factor)
    in_boxes = res.bboxes * scale_factor[:, None, :]
    if mode == 'roi_labels':
        return res, model.predict_masks(img, in_boxes, res.valid, res.labels,
                                        feats=feats)
    # (B, D, s, s, C): keep each detection's predicted class
    probs = model.predict_masks(img, in_boxes, res.valid, feats=feats)
    b, d, s = probs.shape[:3]
    cls_idx = res.labels.clamp(0, probs.shape[-1] - 1)
    return res, torch.gather(probs, -1, cls_idx[:, :, None, None, None]
                             .expand(b, d, s, s, 1))[..., 0]


def masks_to_segm_results(mask_probs, res, metas, num_classes,
                          mask_thr: float = 0.5):
    """Paste each image's detection masks into its original frame and
    return the reference's per-image, per-class lists of uncompressed RLE
    dicts (``tpudet/apis/test.py:71-93``). The paste and the run
    boundaries run on ``mask_probs``' device."""
    labels = res.labels.cpu().numpy()
    valid = res.valid.cpu().numpy()
    out = []
    for i, meta in enumerate(metas):
        h, w = meta['ori_shape'][:2]
        v = torch.as_tensor(valid[i], device=mask_probs.device)
        masks = paste_masks(mask_probs[i][v], res.bboxes[i][v], h, w,
                            mask_thr)
        per_cls = [[] for _ in range(num_classes)]
        for rle, c in zip(encode_rle_batch(masks), labels[i][valid[i]]):
            per_cls[int(c)].append(rle)
        out.append(per_cls)
    return out


def _gather_object_shards(local: list, process_count: int) -> list:
    """Every rank's sparse result list, in rank order
    (``tpudet/apis/test.py:95-118``, there over padded uint8 arrays; here
    ``all_gather_object``, which pickles through the group)."""
    shards = all_gather_object(local)
    if len(shards) != process_count:
        raise ValueError(f'{len(shards)} ranks gathered, not the '
                         f'{process_count} the shards were cut for')
    return shards


def merge_sharded_results(shards, total: int) -> list:
    """Merge per-rank sparse result lists (``[(idx, obj), ...]``) into a
    dense dataset-ordered list; duplicate pad indices keep the first
    (``tpudet/apis/test.py:121-130``)."""
    out = [None] * total
    for shard in shards:
        for idx, obj in shard:
            if out[idx] is None:
                out[idx] = obj
    return out


def single_device_test(model, dataset, batch_size: int = 8,
                       img_size: int = 640, progress: bool = True,
                       with_masks: bool = False, mask_thr: float = 0.5,
                       infer_fn=None, process_index: Optional[int] = None,
                       process_count: Optional[int] = None,
                       gather: bool = True, tta: bool = False,
                       tta_score_thr: float = 0.001,
                       tta_iou_thr: float = 0.65,
                       tta_max_per_img: int = 300):
    """Run detection over a test-mode dataset (its pipeline on the model's
    device); returns per-image per-class (n, 5) arrays in dataset order,
    and with ``with_masks`` (a detector with a mask branch) the two-tuple
    ``(bbox_results, segm_results)`` of per-class RLE lists.

    Batches are padded to at least ``img_size`` squares. ``infer_fn(img,
    scale_factor, img_hw) -> NMSResult`` replaces the model's forward,
    decode and NMS on the plain path, as in tpudet (which also passes its
    variables).

    With ``tta``, each batch runs twice, as it is and flipped along W on
    the device, and ``tta_get_bboxes`` merges the two candidate sets
    (``tta_score_thr``, ``tta_iou_thr``, ``tta_max_per_img``); it refuses
    masks and ``infer_fn``, as tpudet does.

    Sharding, as tpudet's: each of ``process_count`` processes (the open
    process group's size and this rank by default) tests a disjoint
    rank-strided shard of the set, padded to equal lengths. With
    ``gather`` and a process group open, the shards are all-gathered and
    every rank returns the full dataset-ordered results; without a group
    (shards cut by explicit ``process_index``/``process_count``) or with
    ``gather=False``, a shard returns its sparse ``[(idx, result), ...]``
    list (``(idx, (bbox, segm))`` with masks) for
    ``merge_sharded_results``."""
    # single-stage heads, two-stage RoI heads, or the proposal-only RPN
    if hasattr(model, 'bbox_head'):
        num_classes = model.bbox_head.num_classes
    elif hasattr(model, 'roi_head'):
        num_classes = model.roi_head.num_classes
    else:
        num_classes = 1
    mode = _mask_mode(model) if with_masks else None
    if with_masks and mode is None:
        raise ValueError(f'{type(model).__name__} has no mask branch')
    if tta and mode is not None:
        raise ValueError('TTA with masks is not supported')
    if infer_fn is not None and (tta or with_masks):
        raise ValueError('infer_fn override only supports the plain path')
    device = next(model.parameters()).device
    if process_count is None:
        process_count = group_size()
        if process_index is None:
            process_index = group_rank()
    if process_index is None:
        process_index = 0

    def infer(img, scale_factor, img_hw):
        pred_maps = model(img)
        # per-image (h, w) columns; the YOLO head takes them and does not
        # clip to the image, as tpudet's
        return model.get_bboxes(pred_maps, scale_factors=scale_factor,
                                img_shape=(img_hw[:, 0:1], img_hw[:, 1:2]))

    loader = DetDataLoader(dataset, batch_size=batch_size, max_gts=1,
                           img_size=img_size, shuffle=False,
                           drop_last=False, process_index=process_index,
                           process_count=process_count)
    results: List[Optional[list]] = [None] * len(dataset)
    segms: List[Optional[list]] = [None] * len(dataset)
    done = 0
    model.eval()
    with torch.inference_mode():
        for batch in loader:
            img = batch['img'].to(device)
            scale_factor = torch.as_tensor(batch['scale_factor'],
                                           device=device)
            if tta:
                res = tta_get_bboxes(
                    model, [img, img.flip(2)], [scale_factor] * 2,
                    [False, True], score_thr=tta_score_thr,
                    iou_thr=tta_iou_thr, max_per_img=tta_max_per_img)
            elif mode is None:
                img_hw = torch.as_tensor(
                    np.array([m['img_shape'][:2] if m.get('img_shape')
                              else img.shape[1:3]
                              for m in batch['img_metas']], np.float32),
                    device=device)
                res = (infer_fn or infer)(img, scale_factor, img_hw)
            else:
                res, probs = predict_masks(model, img, scale_factor)
                seg_batch = masks_to_segm_results(
                    probs, res, batch['img_metas'], num_classes, mask_thr)
                for seg, meta in zip(seg_batch, batch['img_metas']):
                    if segms[meta['_idx']] is None:
                        segms[meta['_idx']] = seg
            per_img = nms_result_to_per_class(res, num_classes)
            for out, meta in zip(per_img, batch['img_metas']):
                if results[meta['_idx']] is None:
                    results[meta['_idx']] = out
            done += len(batch['img_metas'])
            if progress and done % (batch_size * 20) == 0:
                print(f'tested {done}/{len(dataset)} (shard '
                      f'{process_index}/{process_count})')
    if process_count > 1:
        local = [(i, r if mode is None else (r, segms[i]))
                 for i, r in enumerate(results) if r is not None]
        if not gather or not is_distributed():
            return local
        merged = merge_sharded_results(
            _gather_object_shards(local, process_count), len(dataset))
        if mode is None:
            return merged
        return [m[0] for m in merged], [m[1] for m in merged]
    bbox_results = [r for r in results if r is not None]
    if mode is None:
        return bbox_results
    return bbox_results, [s for s in segms if s is not None]
