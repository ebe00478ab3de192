"""Batch loaders: pipeline outputs -> fixed-shape padded batches.
Counterparts of ``DetDataLoader`` and ``MosaicTileLoader`` in
``tpudet/data/loader.py``.

Every batch is a dict of static shapes: the images on a zero canvas of one
size, gts padded to ``max_gts`` with a validity mask. An image larger than
``img_size`` widens that batch's canvas to hold it (tpudet's loader
raises there, so an evaluation at the two-stage configs' 1333 x 800 test
scale fails in tpudet at the default 640). Shards are
rank-strided over a per-epoch-seeded order (``process_index`` /
``process_count``).

A batch's ``img`` is a float32 tensor on the device the pipeline put the
images on, and so are its ``gt_frame_masks`` (B, max_gts, S, S), where the
pipeline made masks (``LoadAnnotations(with_mask=True)``); boxes, labels,
the validity mask, ``scale_factor`` and the metas are host arrays, as in
tpudet. tpudet's ``num_workers``, which its
loader stores and never reads, is left out.

Batches are made in one prefetch thread. Its image ops go to the same CUDA
stream as the consumer's, the thread's default stream, so stream order is
program order: a batch is complete on the device before any kernel the
consumer queues after receiving it, and tensors made in one thread and
freed in the other need no cross-stream bookkeeping. The host half of the
pipeline (annotations, reading files, launching the image ops) overlaps
the consumer; host images go to the device through pinned memory, so
their copies do not wait for the kernels queued before them.

Each pass seeds the dataset's generator (``CocoDataset.set_rng_seed``)
with ``seed + epoch`` before the first batch, so a pass draws the same
Mosaic partners, retries and augmentations whenever it runs; tpudet draws
them from Python's global generator. A pass that the consumer leaves
early (``break``, an exception) stops the thread when the iterator is
closed or collected.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class DetDataLoader:

    def __init__(self,
                 dataset,
                 batch_size: int,
                 max_gts: int = 120,
                 img_size: Optional[int] = None,
                 shuffle: bool = True,
                 seed: int = 0,
                 drop_last: bool = True,
                 process_index: int = 0,
                 process_count: int = 1,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_gts = max_gts
        self.img_size = img_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Per-epoch reshuffle seed."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        # rank-strided shard, padded to equal length across processes
        shard = order[self.process_index::self.process_count]
        if not self.drop_last and len(order) % self.process_count:
            target = -(-n // self.process_count)
            if len(shard) < target:
                shard = np.concatenate([shard, shard[:target - len(shard)]])
        return shard

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(
            -n // self.batch_size)

    def _collate(self, samples) -> Dict:
        b = len(samples)
        imgs = [torch.as_tensor(s['img']) for s in samples]
        h = max(t.shape[0] for t in imgs)
        w = max(t.shape[1] for t in imgs)
        if self.img_size is not None:
            h, w = max(h, self.img_size), max(w, self.img_size)
        img = torch.zeros((b, h, w, 3), dtype=torch.float32,
                          device=imgs[0].device)
        gt_bboxes = np.zeros((b, self.max_gts, 4), np.float32)
        gt_labels = np.zeros((b, self.max_gts), np.int32)
        gt_valid = np.zeros((b, self.max_gts), bool)
        scale_factor = np.ones((b, 4), np.float32)
        masks = [s['gt_frame_masks'] for s in samples
                 if 'gt_frame_masks' in s]
        gt_frame_masks = None
        if masks:
            ms = masks[0].shape[-1]
            gt_frame_masks = torch.zeros((b, self.max_gts, ms, ms),
                                         dtype=torch.float32,
                                         device=masks[0].device)
        meta = []
        for i, (s, t) in enumerate(zip(samples, imgs)):
            img[i, :t.shape[0], :t.shape[1]] = t
            boxes = s.get('gt_bboxes')
            if boxes is not None and len(boxes):
                n = min(len(boxes), self.max_gts)
                gt_bboxes[i, :n] = boxes[:n]
                gt_labels[i, :n] = s['gt_labels'][:n]
                gt_valid[i, :n] = True
                if gt_frame_masks is not None and 'gt_frame_masks' in s:
                    gt_frame_masks[i, :n] = s['gt_frame_masks'][:n]
            scale_factor[i] = s.get('scale_factor', np.ones(4, np.float32))
            meta.append({
                'ori_shape': s.get('ori_shape'),
                'img_shape': s.get('img_shape'),
                'pad_shape': s.get('pad_shape'),
                'scale_factor': scale_factor[i],
                'filename': s.get('filename'),
                '_idx': s.get('_idx'),
            })
        out = dict(img=img, gt_bboxes=gt_bboxes, gt_labels=gt_labels,
                   gt_valid=gt_valid, scale_factor=scale_factor,
                   img_metas=meta)
        if gt_frame_masks is not None:
            out['gt_frame_masks'] = gt_frame_masks
        return out

    def _prefetch_iter(self, load_batch) -> Iterator[Dict]:
        """Threaded prefetch. A worker exception is forwarded through the
        queue and re-raised in the consumer, which would otherwise wait on
        ``q.get`` forever. Closing the iterator stops the worker: it
        finishes the batch at hand, and the queue is drained until it
        ends."""
        indices = self._indices()
        nb = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        batches = [
            indices[i * self.batch_size:(i + 1) * self.batch_size]
            for i in range(nb)
        ]
        set_seed = getattr(self.dataset, 'set_rng_seed', None)
        if set_seed is not None:
            set_seed(self.seed + self.epoch)

        def worker():
            try:
                for batch_idx in batches:
                    if stop.is_set():
                        break
                    q.put(load_batch(batch_idx))
            except BaseException as e:
                q.put(e)
                return
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()

    def __iter__(self) -> Iterator[Dict]:
        return self._prefetch_iter(lambda batch_idx: self._collate(
            [self.dataset[int(i)] for i in batch_idx]))


class MosaicTileLoader(DetDataLoader):
    """Loader for the on-device augmentation path
    (``tpudet/data/loader.py:156-209``): the dataset's pipeline only reads
    and letterboxes tiles (uint8 BGR, no mosaic, affine or normalize); each
    batch element carries 4 tiles (the sample and 3 same-group partners,
    ``batch_rand_others``) and ``data/device_aug.py`` does the rest inside
    the train step.

    A batch: ``tiles`` (B, 4, S, S, 3) uint8 on the pipeline's device;
    host arrays ``tile_hw`` (B, 4, 2) int32 (h, w of each tile's content),
    ``gt_bboxes`` (B, 4, G, 4), ``gt_labels`` (B, 4, G) int32, ``gt_valid``
    (B, 4, G) with G = ``max_gts_per_tile``, and ``aug_seed`` (B,) int32,
    drawn from ``np.random.RandomState(seed + 7919 + epoch)`` as tpudet
    draws them."""

    def __init__(self, dataset, batch_size, tile_size: int = 640,
                 max_gts_per_tile: int = 40, **kwargs):
        super().__init__(dataset, batch_size, img_size=tile_size, **kwargs)
        self.tile_size = tile_size
        self.max_gts_per_tile = max_gts_per_tile
        self._seed_rng = np.random.RandomState(self.seed + 7919)

    def set_epoch(self, epoch: int):
        super().set_epoch(epoch)
        self._seed_rng = np.random.RandomState(self.seed + 7919 + epoch)

    def _collate(self, samples) -> Dict:
        b = len(samples)
        s = self.tile_size
        g = self.max_gts_per_tile
        first = torch.as_tensor(samples[0][0]['img'])
        tiles = torch.zeros((b, 4, s, s, 3), dtype=torch.uint8,
                            device=first.device)
        tile_hw = np.zeros((b, 4, 2), np.int32)
        gt_bboxes = np.zeros((b, 4, g, 4), np.float32)
        gt_labels = np.zeros((b, 4, g), np.int32)
        gt_valid = np.zeros((b, 4, g), bool)
        for i, tile_group in enumerate(samples):
            for q_idx, t in enumerate(tile_group):
                img = torch.as_tensor(t['img'])
                h, w = img.shape[:2]
                tiles[i, q_idx, :h, :w] = img
                tile_hw[i, q_idx] = (h, w)
                boxes = t.get('gt_bboxes')
                if boxes is not None and len(boxes):
                    n = min(len(boxes), g)
                    gt_bboxes[i, q_idx, :n] = boxes[:n]
                    gt_labels[i, q_idx, :n] = t['gt_labels'][:n]
                    gt_valid[i, q_idx, :n] = True
        # per-image aug seeds: deterministic in (loader seed, epoch, draw)
        seeds = self._seed_rng.randint(0, 2**31 - 1, size=b).astype(np.int32)
        return dict(tiles=tiles, tile_hw=tile_hw, gt_bboxes=gt_bboxes,
                    gt_labels=gt_labels, gt_valid=gt_valid, aug_seed=seeds)

    def __iter__(self) -> Iterator[Dict]:
        def load_group(idx: int):
            partners = [idx] + self.dataset.batch_rand_others(idx, 3)
            return [self.dataset[int(i)] for i in partners]

        return self._prefetch_iter(lambda batch_idx: self._collate(
            [load_group(int(i)) for i in batch_idx]))
