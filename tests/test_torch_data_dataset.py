"""The port's ``COCO`` index, ``CocoDataset`` and ``DetDataLoader`` against
tpudet's, on the CPU.

A small COCO json from a numpy seed holds images in mixed sizes, an image
with no annotation, one under ``min_size``, and gts that are crowd,
``ignore``, out of class, degenerate (width under 1, zero area) and
outside the image. Images are JPEGs written with cv2 and read by both
packages from the files.

Tolerances: annotations, indices, shapes, scale factors, boxes, labels,
metas and written json exactly equal; images within 1 uint8 level (1/255
after ``Normalize``), at least 99 % of pixels equal.
"""
import json
import threading

import cv2
import numpy as np
import pytest
import torch

from tpudet.data import CocoDataset as JCocoDataset
from tpudet.data import COCO as JCOCO
from tpudet.data import DetDataLoader as JLoader
from tpudet_torch.data import COCO, CocoDataset, DetDataLoader, build_dataset

CLASSES = ('cat', 'dog', 'bird')
NORM = dict(mean=[114, 114, 114], std=[255, 255, 255], to_rgb=True)
SIZES = [(96, 128), (128, 96), (80, 80), (200, 150), (64, 128), (30, 100),
         (128, 128), (100, 60), (120, 90)]


def _test_pipeline():
    return [dict(type='LoadImageFromFile'),
            dict(type='MultiScaleFlipAug', img_scale=(128, 128), flip=False,
                 transforms=[dict(type='Resize', keep_ratio=True),
                             dict(type='RandomFlip'),
                             dict(type='Pad', size_divisor=32),
                             dict(type='Normalize', **NORM)])]


def _train_pipeline():
    return [dict(type='LoadImageFromFile'),
            dict(type='LoadAnnotations', with_bbox=True),
            dict(type='Resize', img_scale=(128, 128), keep_ratio=True),
            dict(type='Pad', size_divisor=32),
            dict(type='Normalize', **NORM)]


@pytest.fixture(scope='module')
def coco_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('coco')
    rng = np.random.RandomState(0)
    images, anns = [], []
    aid = 1
    for i, (h, w) in enumerate(SIZES):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        name = f'{i:04d}.jpg'
        assert cv2.imwrite(str(d / name), img)
        images.append(dict(id=100 + i, file_name=name, width=w, height=h))
        if i == 2:  # an image with no annotation
            continue
        for _ in range(rng.randint(2, 6)):
            bw, bh = rng.uniform(4, w / 2), rng.uniform(4, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            anns.append(dict(id=aid, image_id=100 + i,
                             category_id=int(rng.choice([1, 3, 7])),
                             bbox=[x, y, bw, bh], area=bw * bh * 0.9,
                             iscrowd=0))
            aid += 1
    specials = [
        dict(image_id=100, category_id=3, bbox=[5, 5, 40, 30], iscrowd=1,
             area=1000.0),
        dict(image_id=101, category_id=1, bbox=[10, 10, 20, 20], iscrowd=0,
             ignore=True, area=400.0),
        dict(image_id=103, category_id=99, bbox=[2, 3, 30, 40], iscrowd=0,
             area=1200.0),  # out of class
        dict(image_id=104, category_id=1, bbox=[7, 7, 0.5, 30], iscrowd=0,
             area=15.0),  # degenerate: width under 1
        dict(image_id=104, category_id=3, bbox=[9, 9, 10, 10], iscrowd=0,
             area=0.0),  # zero area
        dict(image_id=106, category_id=7, bbox=[500, 500, 10, 10],
             iscrowd=0),  # outside the image, no area key
        dict(image_id=107, category_id=7, bbox=[1, 1, 30, 20]),  # no crowd
    ]
    for a in specials:
        anns.append(dict(a, id=aid))
        aid += 1
    cats = [dict(id=1, name='cat'), dict(id=3, name='dog'),
            dict(id=7, name='bird'), dict(id=99, name='unicorn')]
    path = d / 'ann.json'
    path.write_text(json.dumps(dict(images=images, annotations=anns,
                                    categories=cats)))
    return d


def _pair(coco_dir, test_mode, pipeline, **kw):
    args = dict(ann_file=str(coco_dir / 'ann.json'), pipeline=pipeline,
                img_prefix=str(coco_dir), classes=CLASSES,
                test_mode=test_mode, **kw)
    return JCocoDataset(**args), CocoDataset(**args, device='cpu')


def assert_same_tree(got, ref, img_level=None):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            assert_same_tree(got[k], ref[k], img_level if k == 'img'
                             else None)
    elif isinstance(ref, (list, tuple)) and not isinstance(got, np.ndarray):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_same_tree(g, r)
    elif img_level is not None:
        g = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        assert g.shape == ref.shape and g.dtype == ref.dtype
        diff = np.abs(g.astype(np.float64) - ref.astype(np.float64))
        assert diff.max() <= img_level * (1 + 1e-6)
        assert (diff == 0).mean() >= 0.99
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


def test_coco_index_matches_tpudet(coco_dir):
    ref, got = JCOCO(str(coco_dir / 'ann.json')), COCO(
        str(coco_dir / 'ann.json'))
    assert got.get_img_ids() == ref.get_img_ids()
    assert got.get_cat_ids() == ref.get_cat_ids()
    assert got.get_cat_ids(cat_names=('dog', 'x', 'cat')) == \
        ref.get_cat_ids(cat_names=('dog', 'x', 'cat'))
    ids = ref.get_img_ids()[:4]
    assert got.get_ann_ids(ids) == ref.get_ann_ids(ids)
    assert got.load_anns(ref.get_ann_ids(ids)) == ref.load_anns(
        ref.get_ann_ids(ids))
    assert got.load_imgs(ids) == ref.load_imgs(ids)
    assert dict(got.img_to_anns) == dict(ref.img_to_anns)


@pytest.mark.parametrize('test_mode', [True, False])
def test_dataset_index_matches_tpudet(coco_dir, test_mode):
    ref, got = _pair(coco_dir, test_mode, [], min_size=40)
    assert len(got) == len(ref)
    assert len(ref) == (len(SIZES) if test_mode else len(SIZES) - 2)
    assert got.data_infos == ref.data_infos
    assert got.cat_ids == ref.cat_ids and got.cat2label == ref.cat2label
    assert got.img_ids == ref.img_ids
    np.testing.assert_array_equal(got.flag, ref.flag)
    assert set(got._group_indices) == set(ref._group_indices)
    for g in ref._group_indices:
        np.testing.assert_array_equal(got._group_indices[g],
                                      ref._group_indices[g])
    if not test_mode:
        assert got._filter_imgs(40) == ref._filter_imgs(40)


@pytest.mark.parametrize('test_mode', [True, False])
def test_annotations_match_tpudet(coco_dir, test_mode):
    ref, got = _pair(coco_dir, test_mode, [])
    for i in range(len(ref)):
        assert_same_tree(got.get_ann_info(i), ref.get_ann_info(i))
        assert_same_tree(got.get_ann_info_test(i), ref.get_ann_info_test(i))
    # the crowd, ignored and out-of-class gts are ignored in the test view
    attrs = [ref.get_ann_info_test(i)['gt_attrs'] for i in range(len(ref))]
    assert sum(a['iscrowd'].sum() for a in attrs) >= 1
    assert sum(a['ignore'].sum() for a in attrs) >= 3


def test_batch_rand_others_matches_tpudet(coco_dir):
    import random
    ref, got = _pair(coco_dir, False, [])
    for idx in range(len(ref)):
        random.seed(idx)
        r = ref.batch_rand_others(idx, 3)
        random.seed(idx)
        assert got.batch_rand_others(idx, 3) == r


def test_results2json_matches_tpudet(coco_dir, tmp_path):
    ref, got = _pair(coco_dir, True, [])
    rng = np.random.RandomState(1)
    results = [[np.concatenate([rng.uniform(0, 50, (n, 2)),
                                rng.uniform(50, 100, (n, 2)),
                                rng.uniform(0, 1, (n, 1))], 1).astype(
                                    np.float32)
                for n in rng.randint(0, 4, len(CLASSES))]
               for _ in range(len(ref))]
    out_r = ref.results2json(results, str(tmp_path / 'ref'))
    out_g = got.results2json(results, str(tmp_path / 'got'))
    assert set(out_g) == set(out_r) == {'bbox'}
    recs_g = json.loads(open(out_g['bbox']).read())
    recs_r = json.loads(open(out_r['bbox']).read())
    assert recs_g == recs_r and len(recs_r) > 10


@pytest.mark.parametrize('test_mode', [True, False])
def test_getitem_matches_tpudet(coco_dir, test_mode):
    pipe = _test_pipeline() if test_mode else _train_pipeline()
    ref, got = _pair(coco_dir, test_mode, pipe)
    drop = {'dataset', 'img_info', 'ann_info'}
    for i in range(len(ref)):
        r, g = ref[i], got[i]
        assert g['dataset'] is got and r['dataset'] is ref
        assert_same_tree({k: v for k, v in g.items() if k not in drop},
                         {k: v for k, v in r.items() if k not in drop},
                         img_level=1 / 255)


def test_build_dataset_passes_the_device(coco_dir):
    ds = build_dataset(dict(type='CocoDataset',
                            ann_file=str(coco_dir / 'ann.json'),
                            pipeline=_test_pipeline(), classes=CLASSES,
                            img_prefix=str(coco_dir), test_mode=True),
                       default_args=dict(device='cpu'))
    assert isinstance(ds, CocoDataset) and len(ds) == len(SIZES)
    assert ds[0]['img'].device == torch.device('cpu')


def test_dataset_defaults_to_cuda_and_raises_without_it(coco_dir,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CocoDataset(str(coco_dir / 'ann.json'), _test_pipeline(),
                    classes=CLASSES, test_mode=True)


def _batches(loader):
    return list(iter(loader))


@pytest.mark.parametrize('kw', [
    dict(batch_size=3, shuffle=False, drop_last=False, img_size=128),
    dict(batch_size=2, shuffle=True, seed=5, max_gts=3),
    dict(batch_size=2, shuffle=True, seed=1, drop_last=False,
         process_index=1, process_count=2, img_size=160),
], ids=['eval', 'shuffled_max_gts3', 'shard_1_of_2'])
def test_loader_batches_match_tpudet(coco_dir, kw):
    ref_ds, got_ds = _pair(coco_dir, False, _train_pipeline())
    ref_l, got_l = JLoader(ref_ds, **kw), DetDataLoader(got_ds, **kw)
    got_l.set_epoch(2)
    ref_l.set_epoch(2)
    np.testing.assert_array_equal(got_l._indices(), ref_l._indices())
    assert len(got_l) == len(ref_l)
    ref_b, got_b = _batches(ref_l), _batches(got_l)
    assert len(got_b) == len(ref_b) == len(ref_l)
    for g, r in zip(got_b, ref_b):
        assert isinstance(g['img'], torch.Tensor)
        assert_same_tree(g, r, img_level=1 / 255)


def test_loader_reraises_a_worker_exception(coco_dir):
    _, ds = _pair(coco_dir, True, _test_pipeline())
    ds.data_infos[1] = dict(ds.data_infos[1], filename='missing.jpg')
    loader = DetDataLoader(ds, batch_size=1, shuffle=False, drop_last=False)
    before = set(threading.enumerate())
    seen = []
    with pytest.raises(FileNotFoundError, match='missing.jpg'):
        for batch in loader:
            seen.append(batch['img_metas'][0]['_idx'])
    assert seen == [0]
    for t in set(threading.enumerate()) - before:
        t.join(timeout=10)  # the worker ends after handing on the error
        assert not t.is_alive()
