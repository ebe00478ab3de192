"""CocoDataset: COCO index + pipeline driver. Counterpart of
``tpudet/data/dataset.py:37-250`` (``build_dataset``, ``CocoDataset``):
annotation loading, empty-image filtering, aspect-ratio group flags, the
``batch_rand_others`` partner sampling, retry-on-empty ``__getitem__``, the
eval-annotation view with ignore/iscrowd/area attributes that the fast-bbox
evaluator reads, and ``results2json``.

The pipeline's image ops run on ``device`` (``cuda`` unless the caller
asks for the CPU); annotations stay on the host. The subclasses
(Cityscapes, LVIS and the rest) come with later slices.

The dataset's random draws (Mosaic partners, the retry index, and the
random transforms, which reach it through ``results['dataset']``) come
from ``self.rng``: a ``random.Random`` that a loader seeds from its seed
and epoch (``set_rng_seed``) before it draws a batch. Until then it is
Python's global generator, as in tpudet.
"""
from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..registry import DATASETS, build_from_cfg
from .coco_api import COCO
from .pipelines import Compose

COCO_CLASSES = (
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella',
    'handbag', 'tie', 'suitcase', 'frisbee', 'skis', 'snowboard',
    'sports ball', 'kite', 'baseball bat', 'baseball glove', 'skateboard',
    'surfboard', 'tennis racket', 'bottle', 'wine glass', 'cup', 'fork',
    'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake', 'chair',
    'couch', 'potted plant', 'bed', 'dining table', 'toilet', 'tv',
    'laptop', 'mouse', 'remote', 'keyboard', 'cell phone', 'microwave',
    'oven', 'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
    'scissors', 'teddy bear', 'hair drier', 'toothbrush')


def build_dataset(cfg, default_args=None):
    """A dataset from its config; ``default_args`` fill in missing keys
    (``device`` among them)."""
    return build_from_cfg(dict(cfg), DATASETS, default_args)


@DATASETS.register_module()
class CocoDataset:
    CLASSES = COCO_CLASSES

    def __init__(self,
                 ann_file: str,
                 pipeline: Sequence,
                 img_prefix: str = '',
                 classes: Optional[Sequence[str]] = None,
                 test_mode: bool = False,
                 filter_empty_gt: bool = True,
                 min_size: int = 32,
                 device: Union[str, torch.device] = 'cuda'):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        if classes is not None:
            self.CLASSES = tuple(classes)

        self.coco = COCO(ann_file)
        self.cat_ids = self.coco.get_cat_ids(cat_names=self.CLASSES)
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.img_ids = self.coco.get_img_ids()
        self.data_infos = []
        for i in self.img_ids:
            info = dict(self.coco.load_imgs([i])[0])
            info['filename'] = info['file_name']
            self.data_infos.append(info)

        if not test_mode:
            valid_inds = self._filter_imgs(min_size)
            self.data_infos = [self.data_infos[i] for i in valid_inds]
        self._set_group_flag()

        self.pipeline = Compose(pipeline, device=device)
        self.rng = random  # the module's functions: the global generator

    def set_rng_seed(self, seed: int):
        """Draw from a ``random.Random(seed)`` from now on."""
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.data_infos)

    # ------------------------------------------------------------------
    def _filter_imgs(self, min_size=32) -> List[int]:
        """Drop images without in-class non-crowd annotations, and images
        smaller than ``min_size``."""
        ids_with_ann = {
            ann['image_id']
            for ann in self.coco.anns.values()
            if ann.get('category_id') in self.cat2label
            and not ann.get('iscrowd', False)
        }
        valid = []
        for i, info in enumerate(self.data_infos):
            if self.filter_empty_gt and info['id'] not in ids_with_ann:
                continue
            if min(info['width'], info['height']) < min_size:
                continue
            valid.append(i)
        return valid

    def _set_group_flag(self):
        """Aspect-ratio group flags: 1 where width > height."""
        self.flag = np.zeros(len(self), dtype=np.uint8)
        for i, info in enumerate(self.data_infos):
            if info['width'] / info['height'] > 1:
                self.flag[i] = 1
        self._group_indices = {
            g: np.where(self.flag == g)[0]
            for g in np.unique(self.flag)
        }

    def batch_rand_others(self, idx: int, batch: int) -> List[int]:
        """Random same-aspect-group partners (for Mosaic)."""
        group = self._group_indices[self.flag[idx]]
        if len(group) <= 1:
            return [idx] * batch
        return [int(self.rng.choice(group)) for _ in range(batch)]

    # ------------------------------------------------------------------
    def get_ann_info(self, idx: int) -> Dict:
        """Training annotations: non-crowd, in-class, non-degenerate
        boxes."""
        img_info = self.data_infos[idx]
        anns = self.coco.img_to_anns[img_info['id']]
        bboxes, labels, masks = [], [], []
        for ann in anns:
            if ann.get('ignore', False) or ann.get('iscrowd', False):
                continue
            if ann['category_id'] not in self.cat2label:
                continue
            x1, y1, w, h = ann['bbox']
            inter_w = max(0, min(x1 + w, img_info['width']) - max(x1, 0))
            inter_h = max(0, min(y1 + h, img_info['height']) - max(y1, 0))
            if inter_w * inter_h == 0 or ann.get('area', w * h) <= 0 \
                    or w < 1 or h < 1:
                continue
            bboxes.append([x1, y1, x1 + w, y1 + h])
            labels.append(self.cat2label[ann['category_id']])
            masks.append(ann.get('segmentation'))
        if bboxes:
            bboxes = np.array(bboxes, np.float32)
            labels = np.array(labels, np.int64)
        else:
            bboxes = np.zeros((0, 4), np.float32)
            labels = np.array([], np.int64)
        return dict(bboxes=bboxes, labels=labels, masks=masks)

    def get_ann_info_test(self, idx: int) -> Dict:
        """Eval annotations, every gt with its ignore/iscrowd/area
        attributes: crowd and out-of-class gts are ignored."""
        img_info = self.data_infos[idx]
        anns = self.coco.img_to_anns[img_info['id']]
        img_shape = (img_info.get('height', 0), img_info.get('width', 0))
        bboxes, labels, masks = [], [], []
        attrs = dict(ignore=[], iscrowd=[], area=[])
        for ann in anns:
            iscrowd = bool(ann.get('iscrowd', False))
            ignore = bool(ann.get('ignore', False)) or iscrowd or \
                ann['category_id'] not in self.cat_ids
            x1, y1, w, h = ann['bbox']
            attrs['ignore'].append(ignore)
            attrs['iscrowd'].append(iscrowd)
            attrs['area'].append(ann.get('area', w * h))
            bboxes.append([x1, y1, x1 + w, y1 + h])
            labels.append(self.cat2label.get(ann['category_id'], 0))
            masks.append(ann.get('segmentation'))
        if bboxes:
            return dict(
                gt_bboxes=np.array(bboxes, np.float32),
                gt_labels=np.array(labels, np.int64),
                gt_masks=masks,
                img_shape=img_shape,
                gt_attrs={
                    k: np.array(v, bool if k != 'area' else np.float32)
                    for k, v in attrs.items()
                })
        return dict(
            gt_bboxes=np.zeros((0, 4), np.float32),
            gt_labels=np.array([], np.int64),
            gt_masks=[],
            img_shape=img_shape,
            gt_attrs=dict(ignore=np.array([], bool),
                          iscrowd=np.array([], bool),
                          area=np.array([], np.float32)))

    # ------------------------------------------------------------------
    def prepare_input(self, idx: int) -> Dict:
        """Fresh pre-pipeline results dict, with a back-pointer to the
        dataset."""
        return dict(
            img_info=self.data_infos[idx],
            ann_info=self.get_ann_info(idx),
            img_prefix=self.img_prefix,
            dataset=self,
            _idx=idx)

    def results2json(self, results, outfile_prefix: str) -> Dict[str, str]:
        """Dump detections in the COCO result format: one record per
        detection with ``image_id``, ``category_id`` (the annotation file's
        ids), xywh ``bbox`` and ``score``. Returns {'bbox': written path}.
        """

        def _xywh(box):
            x1, y1, x2, y2 = (float(v) for v in box[:4])
            return [x1, y1, x2 - x1, y2 - y1]

        det_json = []
        for idx, per_class in enumerate(results):
            img_id = self.img_ids[idx]
            for cls, dets in enumerate(per_class):
                for det in dets:
                    det_json.append(dict(image_id=img_id,
                                         bbox=_xywh(det),
                                         score=float(det[4]),
                                         category_id=int(self.cat_ids[cls])))
        out = {'bbox': f'{outfile_prefix}.bbox.json'}
        with open(out['bbox'], 'w') as f:
            json.dump(det_json, f)
        return out

    def __getitem__(self, idx: int) -> Dict:
        if self.test_mode:
            return self.pipeline(self.prepare_input(idx))
        for _ in range(20):
            data = self.pipeline(self.prepare_input(idx))
            if data is not None and len(data.get('gt_bboxes', ())) > 0:
                return data
            idx = self.rng.randint(0, len(self) - 1)
        return data
