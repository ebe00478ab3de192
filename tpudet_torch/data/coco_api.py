"""Minimal COCO annotation index (dependency-free): the port's own copy of
``tpudet/data/coco_api.py``, which is pure Python.

The reference wraps pycocotools (mmdet/datasets/api_wrappers/coco_api.py:10);
the port does not depend on pycocotools, and its evaluator
(``evaluation/mean_ap.py``) replaces COCOeval, so a small json index giving
the same get/load accessors is all that is needed.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


class COCO:

    def __init__(self, annotation_file: Optional[str] = None,
                 dataset: Optional[Dict] = None):
        if annotation_file is not None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset or {}
        self.anns: Dict[int, Dict] = {}
        self.imgs: Dict[int, Dict] = {}
        self.cats: Dict[int, Dict] = {}
        self.img_to_anns = defaultdict(list)
        self._index()

    def _index(self):
        for img in self.dataset.get('images', []):
            self.imgs[img['id']] = img
        for ann in self.dataset.get('annotations', []):
            self.anns[ann['id']] = ann
            self.img_to_anns[ann['image_id']].append(ann)
        for cat in self.dataset.get('categories', []):
            self.cats[cat['id']] = cat

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def get_cat_ids(self, cat_names: Optional[Sequence[str]] = None
                    ) -> List[int]:
        if cat_names is None:
            return list(self.cats.keys())
        by_name = {c['name']: cid for cid, c in self.cats.items()}
        return [by_name[n] for n in cat_names if n in by_name]

    def get_ann_ids(self, img_ids: Sequence[int]) -> List[int]:
        out = []
        for i in img_ids:
            out += [a['id'] for a in self.img_to_anns[i]]
        return out

    def load_anns(self, ids: Sequence[int]) -> List[Dict]:
        return [self.anns[i] for i in ids]

    def load_imgs(self, ids: Sequence[int]) -> List[Dict]:
        return [self.imgs[i] for i in ids]
