"""The port's other datasets against tpudet's, on the CPU: ``CustomDataset``,
``GarbageDataset``, ``TrafficSignDataset``, ``XMLDataset``/``VOCDataset``,
the ``CocoDataset`` subclasses (Cityscapes, WIDER Face, DeepFashion,
LVIS) and the ``Concat``/``Repeat``/``ClassBalanced`` wrappers.

Every set is the committed shapes val set (``tests/torch_fixtures/
shapes``: 32 JPEGs, 3 classes) written into ``tmp_path`` by
``tpudet_torch.tools.dataset_formats`` in the dataset's layout, with
difficult objects, ``.circle`` difficulties and gts under ``min_size``
drawn from numpy seeds. Both packages read the same files.

Tolerances: ``data_infos``, ``get_ann_info``, ``get_ann_info_test``,
lengths, group flags and indices, repeat factors and indices exactly
equal; one image's pipeline output per dataset bit-equal (image, shapes,
scale factor, boxes).
"""
import json
import os
import random

import numpy as np
import pytest
import torch

import tpudet.data.custom as jcustom
import tpudet.data.dataset as jdataset
from tpudet.data.dataset import build_dataset as j_build_dataset
from tpudet_torch.data import DetDataLoader, MosaicTileLoader, build_dataset
from tpudet_torch.data import custom, dataset
from tpudet_torch.registry import DATASETS
from tpudet_torch.tools import dataset_formats as formats

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = os.path.join(ROOT, 'tests/torch_fixtures/shapes')
CLASSES = ('rect', 'circle', 'triangle')
NORM = dict(mean=[114, 114, 114], std=[255, 255, 255], to_rgb=True)
TEST_PIPELINE = [
    dict(type='LoadImageFromFile'),
    dict(type='MultiScaleFlipAug', img_scale=(256, 256), flip=False,
         transforms=[dict(type='Resize', keep_ratio=True),
                     dict(type='RandomFlip'),
                     dict(type='Pad', size_divisor=32),
                     dict(type='Normalize', **NORM)])]
TRAIN_PIPELINE = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', with_bbox=True),
    dict(type='Resize', img_scale=(256, 256), keep_ratio=True),
    dict(type='Pad', size_divisor=32),
    dict(type='Normalize', **NORM)]


def _coco():
    with open(os.path.join(SHAPES, 'val.json')) as f:
        return json.load(f)


@pytest.fixture(scope='module')
def sets(tmp_path_factory):
    """The shapes val set in every layout: {name: path}."""
    d = tmp_path_factory.mktemp('formats')
    coco = _coco()
    img_dir = os.path.join(SHAPES, 'val', 'images')
    hard = np.random.RandomState(0).uniform(size=len(coco['annotations']))
    ids = {a['id']: i for i, a in enumerate(coco['annotations'])}
    out = dict(
        voc=formats.write_voc(coco, img_dir, str(d / 'voc'),
                              difficult=lambda a: hard[ids[a['id']]] < 0.2),
        custom=formats.write_custom(coco, str(d / 'custom')),
        circle=formats.write_circle(
            coco, img_dir, str(d / 'circle'),
            difficulty=lambda a: int(hard[ids[a['id']]] * 200)),
        lvis=formats.write_lvis(coco, str(d / 'lvis')),
        img_dir=img_dir, root=str(d))
    # pseudo annotations: a folder of images and no .circle file
    pseudo = d / 'pseudo'
    pseudo.mkdir()
    for name in sorted(os.listdir(img_dir))[:3]:
        (pseudo / name).write_bytes(open(os.path.join(img_dir, name),
                                         'rb').read())
    out['pseudo'] = str(pseudo)
    # short and 4-value lines in one .circle file
    first = sorted(p for p in os.listdir(out['circle'])
                   if p.endswith('.circle'))[0]
    with open(os.path.join(out['circle'], first), 'a') as f:
        f.write('1,2\n3.5,4.5,30.25,40.75\n\n')
    return out


def _kwargs(name, sets, test_mode):
    """Constructor arguments of each dataset on its layout."""
    pipeline = TEST_PIPELINE if test_mode else TRAIN_PIPELINE
    base = dict(pipeline=pipeline, test_mode=test_mode)
    if name in ('CustomDataset', 'GarbageDataset'):
        return dict(base, ann_file=sets['custom'], img_prefix=sets['img_dir'],
                    classes=CLASSES)
    if name in ('XMLDataset', 'VOCDataset'):
        return dict(base, ann_file=sets['voc'], img_prefix=sets['voc'].split(
            os.sep + 'ImageSets')[0], classes=CLASSES)
    if name == 'TrafficSignDataset':
        return dict(base, ann_file=sets['circle'], img_prefix=sets['circle'])
    if name == 'LVISDataset':
        return dict(base, ann_file=sets['lvis'], img_prefix=sets['img_dir'])
    raise KeyError(name)


def _pair(name, sets, test_mode=True, **kw):
    args = dict(_kwargs(name, sets, test_mode), **kw)
    jcls = getattr(jcustom, name, None) or getattr(jdataset, name)
    return jcls(**args), DATASETS.get(name)(**args, device='cpu')


def assert_same(got, ref):
    """Exactly equal trees of dicts, lists, numpy arrays and scalars (an
    image tensor against tpudet's array)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            if k != 'dataset':
                assert_same(got[k], ref[k])
    elif isinstance(ref, (list, tuple)) and not isinstance(got, np.ndarray):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_same(g, r)
    elif isinstance(ref, np.ndarray):
        if isinstance(got, torch.Tensor):
            got = got.cpu().numpy()
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


def assert_same_index(got, ref):
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got.flag, ref.flag)
    assert got.flag.dtype == ref.flag.dtype
    assert set(got._group_indices) == set(ref._group_indices)
    for g in ref._group_indices:
        np.testing.assert_array_equal(got._group_indices[g],
                                      ref._group_indices[g])
    assert got.CLASSES == ref.CLASSES
    for i in range(len(ref)):
        if hasattr(ref, 'get_ann_info'):
            assert_same(got.get_ann_info(i), ref.get_ann_info(i))
        assert_same(got.get_ann_info_test(i), ref.get_ann_info_test(i))


ANNOTATION_LIST = ['CustomDataset', 'GarbageDataset', 'XMLDataset',
                   'VOCDataset', 'TrafficSignDataset', 'LVISDataset']


@pytest.mark.parametrize('test_mode', [True, False],
                         ids=['test_mode', 'train'])
@pytest.mark.parametrize('name', ANNOTATION_LIST)
def test_dataset_index_matches_tpudet(sets, name, test_mode):
    ref, got = _pair(name, sets, test_mode)
    assert len(ref) > 20
    assert_same(got.data_infos, ref.data_infos)
    assert_same_index(got, ref)


@pytest.mark.parametrize('min_size', [None, 40])
def test_xml_difficult_and_min_size_go_to_ignore(sets, min_size):
    ref, got = _pair('XMLDataset', sets, min_size=min_size)
    assert_same(got.data_infos, ref.data_infos)
    n_ignore = sum(len(d['ann']['bboxes_ignore']) for d in got.data_infos)
    n_hard = sum(1 for d in got.data_infos for _ in d['ann']['labels'])
    assert n_ignore > 5 and n_hard > 20
    if min_size:
        small = [b for d in got.data_infos for b in d['ann']['bboxes']
                 if min(b[2] - b[0], b[3] - b[1]) < min_size]
        assert not small


@pytest.mark.parametrize('thresh', [100, 50])
def test_traffic_sign_difficulty_thresh(sets, thresh):
    ref, got = _pair('TrafficSignDataset', sets, difficulty_thresh=thresh)
    assert_same(got.data_infos, ref.data_infos)
    kept = sum(len(d['ann']['labels']) for d in got.data_infos)
    all_gts = sum(1 for a in _coco()['annotations'] if not a['iscrowd'])
    assert 0 < kept < all_gts + 1
    assert got.data_infos[0]['ann']['bboxes'][-1].tolist() == \
        [3.5, 4.5, 30.25, 40.75]


@pytest.mark.parametrize('test_mode', [True, False],
                         ids=['test_mode', 'train'])
def test_traffic_sign_pseudo_annotations(sets, test_mode):
    args = dict(ann_file=sets['pseudo'], img_prefix=sets['pseudo'],
                pipeline=[], test_mode=test_mode)
    ref = jcustom.TrafficSignDataset(**args)
    got = custom.TrafficSignDataset(**args, device='cpu')
    assert len(got) == len(ref) == (3 if test_mode else 0)
    assert_same(got.data_infos, ref.data_infos)


def test_traffic_sign_config_json_gives_no_image(sets):
    """tpudet's fault, copied: the shipped config's ``ann_file`` is a
    ``.json`` path, which the dataset globs as a folder."""
    args = dict(ann_file=sets['lvis'], img_prefix='', pipeline=[],
                test_mode=True)
    assert len(jcustom.TrafficSignDataset(**args)) == 0
    assert len(custom.TrafficSignDataset(**args, device='cpu')) == 0


@pytest.mark.parametrize('name', ['CityscapesDataset', 'WIDERFaceDataset',
                                  'DeepFashionDataset'])
def test_coco_subclasses_match_tpudet(sets, tmp_path, name):
    jcls = getattr(jdataset, name)
    cls = DATASETS.get(name)
    assert cls.CLASSES == jcls.CLASSES and issubclass(cls,
                                                      dataset.CocoDataset)
    coco = _coco()
    # the shapes categories renamed to the dataset's first class names
    names = (jcls.CLASSES + ('other0', 'other1'))[:3]
    cats = [dict(c, name=names[i]) for i, c in enumerate(
        coco['categories'])]
    path = tmp_path / 'ann.json'
    path.write_text(json.dumps(dict(coco, categories=cats)))
    for test_mode in (True, False):
        args = dict(ann_file=str(path), img_prefix=sets['img_dir'],
                    pipeline=[], test_mode=test_mode)
        ref, got = jcls(**args), cls(**args, device='cpu')
        assert_same(got.data_infos, ref.data_infos)
        assert got.cat_ids == ref.cat_ids
        assert_same_index(got, ref)


def test_lvis_takes_its_classes_from_the_file(sets, tmp_path):
    coco = _coco()
    # ids out of name order: the names follow the ids
    cats = [dict(c, name=n) for c, n in zip(coco['categories'],
                                            ('zebra', 'apple', 'mango'))]
    path = formats.write_lvis(dict(coco, categories=cats[::-1]),
                              str(tmp_path))
    args = dict(ann_file=path, img_prefix=sets['img_dir'], pipeline=[])
    ref = jdataset.LVISDataset(**args)
    got = dataset.LVISDataset(**args, device='cpu')
    assert got.CLASSES == ref.CLASSES == ('zebra', 'apple', 'mango')
    assert dataset.LVISDataset.CLASSES == ()
    named = dataset.LVISDataset(**args, classes=('apple',), device='cpu')
    assert named.CLASSES == ('apple',) and len(named) < len(got)


@pytest.mark.parametrize('name', ['CustomDataset', 'GarbageDataset',
                                  'XMLDataset', 'VOCDataset',
                                  'TrafficSignDataset', 'LVISDataset'])
@pytest.mark.parametrize('test_mode', [True, False],
                         ids=['test_pipeline', 'train_pipeline'])
def test_pipeline_output_matches_tpudet(sets, name, test_mode):
    ref, got = _pair(name, sets, test_mode)
    r, g = ref[3], got[3]
    assert isinstance(g['img'], torch.Tensor) and g['img'].device.type == \
        'cpu'
    for k in ('img_info', 'ann_info'):
        r.pop(k, None)
        g.pop(k, None)
    assert_same(g, r)


def _wrapper_cfgs(sets):
    custom_cfg = dict(type='CustomDataset', **_kwargs('CustomDataset', sets,
                                                      False))
    voc_cfg = dict(type='VOCDataset', **_kwargs('VOCDataset', sets, False))
    return {
        'concat': dict(type='ConcatDataset', datasets=[custom_cfg, voc_cfg]),
        'repeat': dict(type='RepeatDataset', dataset=custom_cfg, times=3),
        'class_balanced': dict(type='ClassBalancedDataset',
                               dataset=custom_cfg, oversample_thr=0.9),
    }


@pytest.mark.parametrize('kind', ['concat', 'repeat', 'class_balanced'])
def test_wrapper_matches_tpudet(sets, kind):
    cfg = _wrapper_cfgs(sets)[kind]
    ref = j_build_dataset(cfg)
    got = build_dataset(cfg, dict(device='cpu'))
    assert type(got).__name__ == type(ref).__name__
    assert len(got) == len(ref) > 32
    np.testing.assert_array_equal(got.flag, ref.flag)
    for g in ref._group_indices:
        np.testing.assert_array_equal(got._group_indices[g],
                                      ref._group_indices[g])
    for i in range(len(ref)):
        assert_same(got.get_ann_info_test(i), ref.get_ann_info_test(i))
    inner = getattr(got, 'datasets', None) or [got.dataset]
    assert all(d.pipeline.transforms[0].device.type == 'cpu' for d in inner)
    if kind == 'concat':
        np.testing.assert_array_equal(got.cumulative_sizes,
                                      ref.cumulative_sizes)
        # a partner of an image of the second set stays in the second set
        random.seed(1)
        want = ref.batch_rand_others(40, 5)
        got.set_rng_seed(1)
        assert got.batch_rand_others(40, 5) == want
        assert all(w >= 32 for w in want)
    if kind == 'class_balanced':
        assert got.repeat_indices == ref.repeat_indices
        assert len(got) > len(got.dataset)
    i = len(ref) - 1
    r, g = ref[i], got[i]
    for k in ('img_info', 'ann_info'):
        r.pop(k, None)
        g.pop(k, None)
    assert_same(g, r)


@pytest.mark.parametrize('kind', ['concat', 'repeat', 'class_balanced'])
def test_wrapper_forwards_set_rng_seed(sets, kind):
    got = build_dataset(_wrapper_cfgs(sets)[kind], dict(device='cpu'))
    got.set_rng_seed(7)
    inner = getattr(got, 'datasets', None) or [got.dataset]
    want = random.Random(7).random()
    assert all(d.rng.random() == want for d in inner)
    # only the class-balanced wrapper draws for itself
    assert hasattr(got, 'rng') == (kind == 'class_balanced')
    if kind == 'class_balanced':
        assert got.rng.random() == want


def test_class_balanced_partners_are_uniform_over_repeat_indices(sets):
    """The law of tpudet's ``np.random.choice`` over the repeat indices,
    drawn from the wrapper's own generator: the same stream for the same
    seed, each partner a value of ``repeat_indices``, and the counts of a
    long draw within 5 sigma of uniform."""
    got = build_dataset(_wrapper_cfgs(sets)['class_balanced'],
                        dict(device='cpu'))
    got.set_rng_seed(3)
    draws = got.batch_rand_others(0, 20000)
    got.set_rng_seed(3)
    assert got.batch_rand_others(0, 20000) == draws
    n = len(got.repeat_indices)
    counts = np.bincount(draws, minlength=len(got.dataset))
    expect = np.bincount(got.repeat_indices,
                         minlength=len(got.dataset)) * 20000 / n
    assert np.all(np.abs(counts - expect) <= 5 * np.sqrt(expect) + 1)


def test_class_balanced_maps_partners_twice_under_the_tile_loader(sets):
    """tpudet's fault, copied: ``batch_rand_others`` returns inner
    indices, and ``MosaicTileLoader`` indexes the wrapper with them, so a
    partner ``p`` loads ``inner[repeat_indices[p]]``. tpudet's draws land
    in the same index space."""
    cfg = _wrapper_cfgs(sets)['class_balanced']
    got = build_dataset(cfg, dict(device='cpu'))
    ref = j_build_dataset(cfg)
    np.random.seed(0)
    ref_draws = ref.batch_rand_others(0, 200)
    assert set(ref_draws) <= set(ref.repeat_indices)
    got.set_rng_seed(0)
    partners = got.batch_rand_others(0, 3)
    assert set(partners) <= set(got.repeat_indices)

    assert got.repeat_indices != list(range(len(got.repeat_indices)))

    loaded = []
    inner_getitem = type(got.dataset).__getitem__

    def record(ds, idx):
        loaded.append(idx)
        return inner_getitem(ds, idx)

    loader = MosaicTileLoader(got, batch_size=1, tile_size=256,
                              max_gts_per_tile=8, shuffle=False)
    mp = pytest.MonkeyPatch()
    mp.setattr(type(got.dataset), '__getitem__', record)
    try:
        it = iter(loader)
        next(it)
        it.close()
    finally:
        mp.undo()
    # the loader seeded the wrapper with its seed and epoch
    got.set_rng_seed(loader.seed + loader.epoch)
    want = got.batch_rand_others(0, 3)
    assert loaded[:4] == [got.repeat_indices[0]] + [
        got.repeat_indices[p] for p in want]


def test_build_dataset_takes_wrapper_dicts_and_device(sets):
    cfg = _wrapper_cfgs(sets)['repeat']
    got = build_dataset(cfg, dict(device='cpu'))
    assert isinstance(got.dataset, custom.CustomDataset)
    assert got.dataset.pipeline.transforms[0].device == torch.device('cpu')
    built = custom.CustomDataset(**_kwargs('CustomDataset', sets, False),
                                 device='cpu')
    assert custom.RepeatDataset(built, times=2).dataset is built


def test_custom_dataset_retry_and_partners_use_its_generator(sets):
    """The retry index and the Mosaic partners come from the dataset's
    generator, in tpudet's order of draws from Python's global one."""
    ref, got = _pair('CustomDataset', sets, test_mode=False)
    random.seed(5)
    want = [ref.batch_rand_others(i, 3) for i in range(6)]
    got.set_rng_seed(5)
    assert [got.batch_rand_others(i, 3) for i in range(6)] == want


def test_loader_collates_an_annotation_list_set(sets):
    _, got = _pair('GarbageDataset', sets, test_mode=True)
    batch = next(iter(DetDataLoader(got, batch_size=4, img_size=256,
                                    max_gts=1, shuffle=False)))
    assert batch['img'].shape == (4, 256, 256, 3)
    assert [m['_idx'] for m in batch['img_metas']] == [0, 1, 2, 3]
