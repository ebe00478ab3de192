"""Annotation-list datasets and the dataset wrappers: counterpart of
``tpudet/data/custom.py`` (``CustomDataset``, the fork's
``TrafficSignDataset`` and ``GarbageDataset``, ``XMLDataset``,
``VOCDataset``, ``ConcatDataset``, ``RepeatDataset`` and
``ClassBalancedDataset``).

As in ``CocoDataset``, the pipeline's image ops run on ``device``
(``cuda`` unless the caller asks for the CPU) and annotations stay on the
host. The random draws (Mosaic partners, the retry index, the random
transforms) come from ``self.rng``, a ``random.Random`` that a loader
seeds with ``set_rng_seed`` (Python's global generator until then). A
wrapper forwards ``set_rng_seed`` to the datasets inside it, whose
generators the pipelines read. ``ClassBalancedDataset`` alone draws for
itself: its partners come from a generator of its own, uniformly over its
repeat indices, as tpudet's ``np.random.choice`` does; the draws differ.

Two of tpudet's behaviours are kept as they are:

- ``TrafficSignDataset`` reads ``ann_file`` as a folder of ``.circle``
  files (or, with none, of ``.jpg`` images); the shipped config names a
  ``.json`` file, which gives 0 images.
- ``ClassBalancedDataset.batch_rand_others`` returns indices into the
  inner dataset, and a caller that indexes the wrapper with them maps them
  through ``repeat_indices`` a second time.
"""
from __future__ import annotations

import glob
import json
import math
import os.path as osp
import pickle
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..registry import DATASETS
from .pipelines import Compose


def _group_indices(flag: np.ndarray) -> Dict:
    return {g: np.where(flag == g)[0] for g in np.unique(flag)}


@DATASETS.register_module()
class CustomDataset:
    """Annotation-list dataset (``tpudet/data/custom.py:27-125``).

    ``ann_file`` is a pickle/json list of dicts: {'filename', 'width',
    'height', 'ann': {'bboxes' (n, 4) xyxy, 'labels' (n,), optional
    'bboxes_ignore'/'labels_ignore'}}.
    """
    CLASSES: Sequence[str] = ()

    def __init__(self,
                 ann_file: str,
                 pipeline: Sequence,
                 img_prefix: str = '',
                 classes: Optional[Sequence[str]] = None,
                 data_root: Optional[str] = None,
                 test_mode: bool = False,
                 filter_empty_gt: bool = True,
                 device: Union[str, torch.device] = 'cuda',
                 **kwargs):
        if classes is not None:
            self.CLASSES = tuple(classes)
        if data_root is not None:
            if not osp.isabs(ann_file):
                ann_file = osp.join(data_root, ann_file)
            if img_prefix and not osp.isabs(img_prefix):
                img_prefix = osp.join(data_root, img_prefix)
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        self.data_infos = self.load_annotations(ann_file)
        if not test_mode and filter_empty_gt:
            self.data_infos = [
                d for d in self.data_infos
                if len(d.get('ann', {}).get('labels', ())) > 0
            ]
        self._set_group_flag()
        self.pipeline = Compose(pipeline, device=device)
        self.rng = random  # the module's functions: the global generator

    def set_rng_seed(self, seed: int):
        """Draw from a ``random.Random(seed)`` from now on."""
        self.rng = random.Random(seed)

    def load_annotations(self, ann_file: str) -> List[Dict]:
        if ann_file.endswith(('.pkl', '.pickle')):
            with open(ann_file, 'rb') as f:
                return pickle.load(f)
        with open(ann_file) as f:
            return json.load(f)

    def __len__(self):
        return len(self.data_infos)

    def _set_group_flag(self):
        """Aspect-ratio group flags: 1 where width > height."""
        self.flag = np.zeros(len(self), dtype=np.uint8)
        for i, info in enumerate(self.data_infos):
            if info.get('width', 1) / max(info.get('height', 1), 1) > 1:
                self.flag[i] = 1
        self._group_indices = _group_indices(self.flag)

    def batch_rand_others(self, idx: int, batch: int) -> List[int]:
        """Random same-aspect-group partners (for Mosaic)."""
        group = self._group_indices[self.flag[idx]]
        if len(group) <= 1:
            return [idx] * batch
        return [int(self.rng.choice(group)) for _ in range(batch)]

    def get_ann_info(self, idx: int) -> Dict:
        ann = self.data_infos[idx].get('ann', {})
        bboxes = np.asarray(ann.get('bboxes', np.zeros((0, 4))),
                            np.float32).reshape(-1, 4)
        labels = np.asarray(ann.get('labels', []), np.int64)
        return dict(bboxes=bboxes, labels=labels)

    def get_ann_info_test(self, idx: int) -> Dict:
        """Eval annotations: every gt, none ignored or crowd."""
        ann = self.get_ann_info(idx)
        n = len(ann['labels'])
        area = ((ann['bboxes'][:, 2] - ann['bboxes'][:, 0]) *
                (ann['bboxes'][:, 3] - ann['bboxes'][:, 1]))
        return dict(gt_bboxes=ann['bboxes'], gt_labels=ann['labels'],
                    gt_attrs=dict(ignore=np.zeros(n, bool),
                                  iscrowd=np.zeros(n, bool),
                                  area=area.astype(np.float32)))

    def prepare_input(self, idx: int) -> Dict:
        """Fresh pre-pipeline results dict, with a back-pointer to the
        dataset."""
        return dict(
            img_info=self.data_infos[idx],
            ann_info=self.get_ann_info(idx),
            img_prefix=self.img_prefix,
            dataset=self,
            _idx=idx)

    def __getitem__(self, idx: int) -> Dict:
        if self.test_mode:
            return self.pipeline(self.prepare_input(idx))
        for _ in range(20):
            data = self.pipeline(self.prepare_input(idx))
            if data is not None and len(data.get('gt_bboxes', ())) > 0:
                return data
            idx = self.rng.randint(0, len(self) - 1)
        return data


@DATASETS.register_module()
class TrafficSignDataset(CustomDataset):
    """Tencent traffic-sign dataset (``tpudet/data/custom.py:128-169``).

    ``ann_file`` is a folder of per-image ``.circle`` text files, one
    ``x1,y1,x2,y2[,difficulty]`` line a sign; signs whose difficulty
    exceeds ``difficulty_thresh`` are dropped. A folder without ``.circle``
    files gives each of its ``.jpg`` images an empty annotation (the test
    phase's pseudo annotations).
    """
    CLASSES = ('sign',)

    def __init__(self, *args, difficulty_thresh: int = 100, **kwargs):
        self.difficulty_thresh = difficulty_thresh
        super().__init__(*args, **kwargs)

    def load_annotations(self, ann_folder: str) -> List[Dict]:
        data_infos = []
        ann_files = sorted(glob.glob(ann_folder + '/*.circle'))
        if not ann_files:  # test phase: pseudo annotations from images
            for img in sorted(glob.glob(ann_folder + '/*.jpg')):
                data_infos.append(
                    dict(filename=osp.basename(img), width=0, height=0,
                         ann=dict(bboxes=np.zeros((0, 4), np.float32),
                                  labels=np.array([], np.int64))))
            return data_infos
        for ann_file in ann_files:
            img_id = osp.basename(ann_file)[:-7]
            bboxes, labels = [], []
            with open(ann_file) as f:
                for line in f:
                    parts = [float(v) for v in line.strip().split(',') if v]
                    if len(parts) < 4:
                        continue
                    if len(parts) > 4 and parts[4] > self.difficulty_thresh:
                        continue
                    bboxes.append(parts[:4])
                    labels.append(0)
            data_infos.append(
                dict(filename=img_id + '.jpg', width=0, height=0,
                     ann=dict(
                         bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
                         labels=np.asarray(labels, np.int64))))
        return data_infos


@DATASETS.register_module()
class GarbageDataset(CustomDataset):
    """The fork's garbage-detection dataset (``tpudet/data/custom.py:
    172-176``): a json annotation list in the ``CustomDataset`` format."""
    CLASSES = tuple(f'class{i}' for i in range(44))


@DATASETS.register_module()
class XMLDataset(CustomDataset):
    """VOC-style XML dataset (``tpudet/data/custom.py:179-277``):
    ``ann_file`` lists image ids, one a line; each image's annotation is
    ``Annotations/<id>.xml`` beside the split's ``ImageSets`` folder.
    Difficult objects, and with ``min_size`` objects narrower or lower
    than it, go to ``bboxes_ignore``."""
    CLASSES = ()

    def __init__(self, *args, min_size: Optional[int] = None, **kwargs):
        self.min_size = min_size
        super().__init__(*args, **kwargs)

    def load_annotations(self, ann_file: str) -> List[Dict]:
        import xml.etree.ElementTree as ET
        with open(ann_file) as f:
            ids = [line.strip() for line in f if line.strip()]
        cat2label = {c: i for i, c in enumerate(self.CLASSES)}
        root_dir = osp.dirname(osp.dirname(ann_file))
        data_infos = []
        for img_id in ids:
            xml_path = osp.join(root_dir, '..', 'Annotations',
                                f'{img_id}.xml')
            if not osp.exists(xml_path):
                xml_path = osp.join(osp.dirname(ann_file), '..', '..',
                                    'Annotations', f'{img_id}.xml')
            root = ET.parse(xml_path).getroot()
            size = root.find('size')
            w = int(size.find('width').text)
            h = int(size.find('height').text)
            bboxes, labels = [], []
            bboxes_ignore, labels_ignore = [], []
            for obj in root.findall('object'):
                name = obj.find('name').text
                if name not in cat2label:
                    continue
                diff = obj.find('difficult')
                difficult = int(diff.text) if diff is not None else 0
                b = obj.find('bndbox')
                box = [float(b.find(t).text)
                       for t in ('xmin', 'ymin', 'xmax', 'ymax')]
                ignore = bool(difficult)
                if self.min_size:
                    if (box[2] - box[0] < self.min_size
                            or box[3] - box[1] < self.min_size):
                        ignore = True
                if ignore:
                    bboxes_ignore.append(box)
                    labels_ignore.append(cat2label[name])
                else:
                    bboxes.append(box)
                    labels.append(cat2label[name])
            data_infos.append(
                dict(filename=f'JPEGImages/{img_id}.jpg', width=w, height=h,
                     ann=dict(
                         bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
                         labels=np.asarray(labels, np.int64),
                         bboxes_ignore=np.asarray(
                             bboxes_ignore, np.float32).reshape(-1, 4),
                         labels_ignore=np.asarray(labels_ignore,
                                                  np.int64))))
        return data_infos

    def evaluate(self, results, metric='mAP', iou_thr=0.5,
                 proposal_nums=(100, 300, 1000), year='2007',
                 scale_ranges=None):
        """VOC-protocol evaluation of per-image per-class (n, 5) arrays:
        ``'mAP'`` (11-point AP for ``year='2007'``) or ``'recall'`` at each
        of ``proposal_nums``."""
        from ..evaluation.recall import eval_recalls
        from ..evaluation.voc_map import eval_map
        annotations = [
            {**self.data_infos[i]['ann']} for i in range(len(self))
        ]
        if metric == 'mAP':
            ds_name = 'voc07' if str(year) == '2007' else self.CLASSES
            mean_ap, _ = eval_map(results, annotations,
                                  scale_ranges=scale_ranges,
                                  iou_thr=iou_thr, dataset=ds_name)
            return {'mAP': float(mean_ap)}
        if metric == 'recall':
            gts = [ann['bboxes'] for ann in annotations]
            proposals = []
            for r in results:
                if isinstance(r, list):
                    r = np.vstack([x for x in r if len(x)]) if any(
                        len(x) for x in r) else np.zeros((0, 5), np.float32)
                proposals.append(np.asarray(r))
            recalls = eval_recalls(gts, proposals, list(proposal_nums),
                                   [iou_thr] if np.isscalar(iou_thr)
                                   else list(iou_thr))
            return {f'recall@{n}': float(recalls[i].mean())
                    for i, n in enumerate(proposal_nums)}
        raise KeyError(f'metric {metric} is not supported')


@DATASETS.register_module()
class VOCDataset(XMLDataset):
    CLASSES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus',
               'car', 'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
               'motorbike', 'person', 'pottedplant', 'sheep', 'sofa',
               'train', 'tvmonitor')


def _build(dataset, device):
    """A wrapped dataset: built from its config dict on ``device``, or
    taken as it is."""
    from .dataset import build_dataset
    if isinstance(dataset, dict):
        return build_dataset(dataset, dict(device=device))
    return dataset


class _Wrapper:
    """``set_rng_seed`` reaches the datasets inside, and the wrapper's
    own generator where it draws for itself."""

    def _inner(self) -> list:
        return list(getattr(self, 'datasets', [])) + (
            [self.dataset] if hasattr(self, 'dataset') else [])

    def set_rng_seed(self, seed: int):
        if hasattr(self, 'rng'):
            self.rng = random.Random(seed)
        for d in self._inner():
            set_seed = getattr(d, 'set_rng_seed', None)
            if set_seed is not None:
                set_seed(seed)


@DATASETS.register_module()
class ConcatDataset(_Wrapper):
    """Concatenation wrapper (``tpudet/data/custom.py:288-331``)."""

    def __init__(self, datasets: List,
                 device: Union[str, torch.device] = 'cuda'):
        self.datasets = [_build(d, device) for d in datasets]
        self.CLASSES = self.datasets[0].CLASSES
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets])
        self.flag = np.concatenate([d.flag for d in self.datasets])
        self._group_indices = _group_indices(self.flag)

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def _locate(self, idx):
        ds = int(np.searchsorted(self.cumulative_sizes, idx, side='right'))
        base = 0 if ds == 0 else int(self.cumulative_sizes[ds - 1])
        return ds, idx - base

    def __getitem__(self, idx):
        ds, local = self._locate(idx)
        return self.datasets[ds][local]

    def batch_rand_others(self, idx, batch):
        ds, local = self._locate(idx)
        base = 0 if ds == 0 else int(self.cumulative_sizes[ds - 1])
        return [base + i
                for i in self.datasets[ds].batch_rand_others(local, batch)]

    def get_ann_info_test(self, idx):
        ds, local = self._locate(idx)
        return self.datasets[ds].get_ann_info_test(local)


@DATASETS.register_module()
class RepeatDataset(_Wrapper):
    """Repeat wrapper for epoch-length control
    (``tpudet/data/custom.py:334-361``)."""

    def __init__(self, dataset, times: int,
                 device: Union[str, torch.device] = 'cuda'):
        self.dataset = _build(dataset, device)
        self.times = times
        self.CLASSES = self.dataset.CLASSES
        self._ori_len = len(self.dataset)
        self.flag = np.tile(self.dataset.flag, times)
        self._group_indices = _group_indices(self.flag)

    def __len__(self):
        return self.times * self._ori_len

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]

    def batch_rand_others(self, idx, batch):
        return self.dataset.batch_rand_others(idx % self._ori_len, batch)

    def get_ann_info_test(self, idx):
        return self.dataset.get_ann_info_test(idx % self._ori_len)


@DATASETS.register_module()
class ClassBalancedDataset(_Wrapper):
    """Class-frequency oversampling wrapper (``tpudet/data/custom.py:
    364-418``): image ``i`` repeats ``ceil(r_i)`` times, ``r_i`` the largest
    ``max(1, sqrt(thr / f(c)))`` over its classes ``c``, ``f(c)`` the share
    of images holding ``c``."""

    def __init__(self, dataset, oversample_thr: float,
                 device: Union[str, torch.device] = 'cuda'):
        self.dataset = _build(dataset, device)
        self.oversample_thr = oversample_thr
        self.CLASSES = self.dataset.CLASSES
        repeat_indices = []
        for idx, rf in enumerate(self._get_repeat_factors(self.dataset,
                                                          oversample_thr)):
            repeat_indices.extend([idx] * int(math.ceil(rf)))
        self.repeat_indices = repeat_indices
        self.flag = self.dataset.flag[repeat_indices]
        self._group_indices = _group_indices(self.flag)
        self.rng = random

    def _get_repeat_factors(self, dataset, thr):
        category_freq: Dict[int, float] = defaultdict(float)
        num_images = len(dataset)
        img_cats = []
        for idx in range(num_images):
            cats = set(dataset.get_ann_info(idx)['labels'].tolist())
            img_cats.append(cats)
            for c in cats:
                category_freq[c] += 1
        for k in category_freq:
            category_freq[k] /= num_images
        cat_repeat = {
            c: max(1.0, math.sqrt(thr / f))
            for c, f in category_freq.items()
        }
        return [
            max({cat_repeat[c] for c in cats}, default=1.0)
            for cats in img_cats
        ]

    def __len__(self):
        return len(self.repeat_indices)

    def __getitem__(self, idx):
        return self.dataset[self.repeat_indices[idx]]

    def batch_rand_others(self, idx, batch):
        """``batch`` draws, uniform over the repeat indices, each returned
        as the inner dataset's index it repeats (tpudet's double
        mapping)."""
        n = len(self.repeat_indices)
        return [self.repeat_indices[self.rng.randrange(n)]
                for _ in range(batch)]

    def get_ann_info_test(self, idx):
        return self.dataset.get_ann_info_test(self.repeat_indices[idx])
