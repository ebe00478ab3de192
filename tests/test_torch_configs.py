"""Every shipped YOLO, RetinaNet, two-stage and plain Mask R-CNN config
builds in the port with tpudet's param tree; the Mask R-CNN variants that
need more than this port has raise ``NotImplementedError``.

The configs under ``configs/yolov4/``, ``configs/yolov5/`` and
``configs/yolov5_ddp/`` and ``configs/shapes/yolo*.py`` (15 in all), and
the 13 RetinaNet configs (``configs/retinanet/``, the fp16, Pascal VOC and
shapes variants: ResNet-50/101, ResNeXt-101 32x4d and 64x4d), and the 11
two-stage configs (``configs/faster_rcnn/``, the fp16, Pascal VOC and
Cityscapes Faster R-CNN, ``rpn/`` and ``fast_rcnn/``), and the fork's
two recipes and the from-scratch Faster R-CNN (3), and the 8 configs of
ROADMAP.md's zoo rows a-c that are not Mask R-CNN (``configs/gn+ws/``'s
two Faster R-CNN, ``configs/cascade_rcnn/`` and ``configs/yolo/``), and
the 12 of rows d, e and g that are not Mask R-CNN (the DCN Faster R-CNN
R50 / R101 and Cascade, the two attention Faster R-CNN, SSD300 and
SSD512 with the VOC and WIDER Face SSD300, the three RegNet RetinaNet),
each read by
both packages' ``Config``: the port's model is built on the meta
device (no weights drawn), tpudet's tree comes from ``jax.eval_shape`` of
its ``init`` (no weights computed either; ``FastRCNN`` also takes padded
proposals). The port's leaf table must hold exactly tpudet's params and
BatchNorm statistics, by name, each with its shape (conv kernels HWIO,
Dense kernels (in, out), ConvTranspose kernels (H, W, in, out)). Exact.

The 8 plain Mask R-CNN configs (``configs/mask_rcnn/``, the fp16,
DeepFashion, LVIS and InstaBoost variants; their datasets and the
InstaBoost transform are not built here), the 4 GN and GN+WS Mask
R-CNN configs and the DCN and the 2 GCB Mask R-CNN configs are swept the
same way, tpudet's tree from ``init`` through ``forward_train`` (its mask
head's params exist only there). The other 4 configs that name
``MaskRCNN``/``MaskRoIHead`` or a Mask R-CNN-based head (HTC, SCNet, MS
R-CNN, PointRend) raise ``NotImplementedError`` naming ROADMAP.md's "rest
of the zoo" item, and so do the 2 Libra R-CNN configs (a list ``neck``
builds as tpudet's chain of necks; its ``BFP`` is not ported). The DCN
ResNeXt-101 config is refused by both packages (tpudet's assertion, the
port's ``NotImplementedError`` with its message).

The 6 configs of ROADMAP.md's zoo row f and the two of row j that share
its assigner (``configs/gfl/``, ``configs/atss/``, ``configs/vfnet/``)
are swept like the RetinaNet configs; LD's (``configs/ld/``) through
``forward_train``, the only path that creates tpudet's teacher subtree.
The probe over every config under ``configs/`` counts what the port
builds, refuses with ``NotImplementedError`` and does not register
(``KeyError``).

Every config whose ``data.train/val/test`` name a dataset other than
``CocoDataset`` (9, wrappers' inner datasets included) has each of those
types registered in the port, as the class of the same name ported from
tpudet's module of the same name, with tpudet's class names.
"""
import glob
import os
from functools import partial

import jax
import jax.numpy as jnp
import pytest
import torch

from tpudet.config import Config as JaxConfig
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet_torch.config import Config
from tpudet_torch.models.builder import build_detector
from tpudet_torch.utils.flax_import import flax_shape, leaf_table

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/yolov4/*.py', 'configs/yolov5/*.py',
                    'configs/yolov5_ddp/*.py', 'configs/shapes/yolo*.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))
RETINA_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/retinanet/*.py',
                    'configs/fp16/retinanet_r50_fpn_fp16_1x_coco.py',
                    'configs/pascal_voc/retinanet_r50_fpn_1x_voc0712.py',
                    'configs/shapes/retinanet_r50_shapes_320.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))
TWO_STAGE_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/faster_rcnn/*.py',
                    'configs/fp16/faster_rcnn_r50_fpn_fp16_1x_coco.py',
                    'configs/pascal_voc/faster_rcnn_r50_fpn_1x_voc0712.py',
                    'configs/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py',
                    'configs/rpn/rpn_r50_fpn_1x_coco.py',
                    'configs/fast_rcnn/fast_rcnn_r50_fpn_1x_coco.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))

# ROADMAP.md's zoo rows a-c (GN+WS, Cascade R-CNN, YOLOv3) but for their
# Mask R-CNN configs, which GN_MASK_CONFIGS holds
ZOO_ROW_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/gn+ws/faster_rcnn_*.py',
                    'configs/cascade_rcnn/*.py', 'configs/yolo/*.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))
GN_MASK_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/gn/mask_rcnn_*.py', 'configs/gn+ws/mask_rcnn_*.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))

# ROADMAP.md's zoo rows d (DCN, GCB, attention), e (SSD) and g (RegNet)
# but for their Mask R-CNN configs (DEG_MASK_CONFIGS) and the DCN
# ResNeXt, which tpudet refuses (DCN_RESNEXT_CONFIG)
DCN_RESNEXT_CONFIG = 'configs/dcn/faster_rcnn_x101_32x4d_fpn_dconv_c3-c5_1x_coco.py'
ZOO_DEG_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/dcn/faster_rcnn_*.py', 'configs/dcn/cascade_*.py',
                    'configs/empirical_attention/*.py', 'configs/ssd/*.py',
                    'configs/pascal_voc/ssd300_voc0712.py',
                    'configs/wider_face/ssd300_wider_face.py',
                    'configs/regnet/*.py')
    for p in glob.glob(os.path.join(ROOT, pattern))
    if os.path.relpath(p, ROOT) != DCN_RESNEXT_CONFIG)
DEG_MASK_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/dcn/mask_rcnn_*.py', 'configs/gcnet/*.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))

# ROADMAP.md's zoo row f (GFL; LD, KD_CONFIGS) and row j's ATSS and VFNet,
# which share its ATSS assigner
ATSS_FAMILY_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/gfl/*.py', 'configs/atss/*.py',
                    'configs/vfnet/*.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))
KD_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, 'configs/ld/*.py')))
# the probe over configs/: (build, NotImplementedError, KeyError)
PROBE_COUNTS = (84, 9, 34)

# configs that build but sit outside the families above: the fork's two
# recipes and training from scratch
OTHER_CONFIGS = sorted([
    'configs/garbage/yolov4l_garbage_mosaic.py',
    'configs/tencent/yolov4l_traffic_sign.py',
    'configs/scratch/faster_rcnn_r50_fpn_gn-all_scratch_6x_coco.py'])

MASK_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/mask_rcnn/*.py',
                    'configs/fp16/mask_rcnn_r50_fpn_fp16_1x_coco.py',
                    'configs/deepfashion/mask_rcnn_r50_fpn_15e_deepfashion.py',
                    'configs/lvis/mask_rcnn_r50_fpn_sample1e-3_mstrain_1x_'
                    'lvis_v1.py',
                    'configs/instaboost/mask_rcnn_r50_fpn_instaboost_4x_'
                    'coco.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))
REFUSED_MASK_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/htc/*.py', 'configs/scnet/*.py',
                    'configs/ms_rcnn/*.py', 'configs/point_rend/*.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))

# Libra R-CNN: FPN -> BFP chained necks, BFP and the IoU-balanced sampling
# not ported
LIBRA_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, 'configs/libra_rcnn/*.py')))


def _flat_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(_flat_shapes(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = tuple(v.shape)
    return out


def test_the_sweep_holds_fifteen_configs():
    assert len(CONFIGS) == 15


def test_the_retinanet_sweep_holds_thirteen_configs():
    assert len(RETINA_CONFIGS) == 13


def test_the_two_stage_sweep_holds_eleven_configs():
    assert len(TWO_STAGE_CONFIGS) == 11


def test_the_zoo_row_sweeps_hold_twelve_configs():
    assert len(ZOO_ROW_CONFIGS) == 8 and len(GN_MASK_CONFIGS) == 4


def test_the_zoo_rows_d_e_g_sweeps_hold_fifteen_configs():
    assert len(ZOO_DEG_CONFIGS) == 12 and len(DEG_MASK_CONFIGS) == 3
    assert not set(ZOO_DEG_CONFIGS) & set(
        CONFIGS + RETINA_CONFIGS + TWO_STAGE_CONFIGS + ZOO_ROW_CONFIGS)


def test_the_atss_family_sweeps_hold_seven_configs():
    assert len(ATSS_FAMILY_CONFIGS) == 6 and len(KD_CONFIGS) == 1
    assert not set(ATSS_FAMILY_CONFIGS + KD_CONFIGS) & set(
        CONFIGS + RETINA_CONFIGS + TWO_STAGE_CONFIGS + ZOO_ROW_CONFIGS +
        ZOO_DEG_CONFIGS)


def test_the_probe_counts_what_builds_and_what_is_refused():
    """Every config under ``configs/`` built on the meta device: 84 build,
    9 raise ``NotImplementedError`` (the "rest of the zoo" and the DCN
    ResNeXt), 34 raise ``KeyError`` (types the port does not register)."""
    counts = [0, 0, 0]
    for p in sorted(glob.glob(os.path.join(ROOT, 'configs/**/*.py'),
                              recursive=True)):
        try:
            with torch.device('meta'):
                build_detector(Config.fromfile(p)['model'])
            counts[0] += 1
        except NotImplementedError:
            counts[1] += 1
        except KeyError:
            counts[2] += 1
    assert tuple(counts) == PROBE_COUNTS


def test_the_other_sweep_holds_three_configs():
    assert all(os.path.exists(os.path.join(ROOT, c)) for c in OTHER_CONFIGS)
    assert not set(OTHER_CONFIGS) & set(CONFIGS + RETINA_CONFIGS +
                                        TWO_STAGE_CONFIGS)


@pytest.mark.parametrize('config', CONFIGS + RETINA_CONFIGS +
                         TWO_STAGE_CONFIGS + OTHER_CONFIGS + ZOO_ROW_CONFIGS +
                         ZOO_DEG_CONFIGS + ATSS_FAMILY_CONFIGS)
def test_config_builds_with_tpudets_param_tree(config):
    path = os.path.join(ROOT, config)
    model_cfg = JaxConfig.fromfile(path)['model']
    jmodel = jax_build_detector(model_cfg)
    args = (jnp.zeros((1, 64, 64, 3)),)
    if model_cfg['type'] == 'FastRCNN':
        args += (jnp.zeros((1, 8, 4)), jnp.ones((1, 8), bool))
    ref = _flat_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                      *args))
    assert_port_tree_is(path, ref)


def assert_port_tree_is(path, ref):
    """The port's model of the config at ``path``, built on the meta
    device, holds exactly the leaves ``ref`` (path -> flax shape)."""
    with torch.device('meta'):
        model = build_detector(Config.fromfile(path)['model'])
    sd = model.state_dict()
    got = {p: flax_shape(sd[key].shape, kind)
           for p, (key, kind) in leaf_table(model).items()}
    assert set(got) == set(ref)
    assert got == ref


@pytest.mark.parametrize('config', KD_CONFIGS)
def test_kd_config_builds_with_tpudets_param_tree(config):
    """The student and the teacher (``teacher_backbone``, ``teacher_neck``,
    ``teacher_bbox_head``: the R-101 GFL that ``teacher_config`` names)."""
    path = os.path.join(ROOT, config)
    jmodel = jax_build_detector(JaxConfig.fromfile(path)['model'])
    g = 4
    args = (jnp.zeros((1, 64, 64, 3)),
            jnp.tile(jnp.asarray([[0., 0., 32., 32.]]), (1, g, 1)),
            jnp.zeros((1, g), jnp.int32), jnp.ones((1, g), bool))
    ref = _flat_shapes(jax.eval_shape(
        partial(jmodel.init, method='forward_train'), jax.random.PRNGKey(0),
        *args))
    assert {p[1] for p in ref} >= {'teacher_backbone', 'teacher_neck',
                                   'teacher_bbox_head'}
    assert_port_tree_is(path, ref)


def test_the_mask_rcnn_sweep_holds_eight_configs():
    assert len(MASK_CONFIGS) == 8


@pytest.mark.parametrize('config', MASK_CONFIGS + GN_MASK_CONFIGS +
                         DEG_MASK_CONFIGS)
def test_mask_config_builds_with_tpudets_param_tree(config):
    path = os.path.join(ROOT, config)
    jmodel = jax_build_detector(JaxConfig.fromfile(path)['model'])
    g = 4
    args = (jnp.zeros((1, 64, 64, 3)),
            jnp.tile(jnp.asarray([[0., 0., 32., 32.]]), (1, g, 1)),
            jnp.zeros((1, g), jnp.int32), jnp.ones((1, g), bool),
            jnp.ones((1, g, 28, 28)))
    ref = _flat_shapes(jax.eval_shape(
        partial(jmodel.init, method='forward_train'), jax.random.PRNGKey(0),
        *args))
    assert any('mask_head' in p for p in ref)
    assert_port_tree_is(path, ref)


def test_the_refused_mask_sweep_holds_eleven_configs():
    # eleven until the GN and GN+WS Mask R-CNN configs (4) were ported,
    # seven until the DCN and GCB ones (3, DEG_MASK_CONFIGS)
    assert len(REFUSED_MASK_CONFIGS) == 4


def test_the_dcn_resnext_config_is_refused_by_both():
    """tpudet asserts against DCN on a grouped block; the port refuses the
    config when it builds the backbone, with tpudet's message."""
    path = os.path.join(ROOT, DCN_RESNEXT_CONFIG)
    jmodel = jax_build_detector(JaxConfig.fromfile(path)['model'])
    with pytest.raises(AssertionError, match='DCN \\+ grouped conv'):
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 64, 64, 3)))
    with pytest.raises(NotImplementedError,
                       match='DCN \\+ grouped conv not supported'):
        with torch.device('meta'):
            build_detector(Config.fromfile(path)['model'])


@pytest.mark.parametrize('config', REFUSED_MASK_CONFIGS)
def test_mask_config_refuses_what_is_not_ported(config):
    cfg = Config.fromfile(os.path.join(ROOT, config))['model']
    with pytest.raises(NotImplementedError,
                       match='ROADMAP.md\'s "rest of the zoo" item'):
        with torch.device('meta'):
            build_detector(cfg)


def test_the_libra_sweep_holds_two_configs():
    assert len(LIBRA_CONFIGS) == 2


@pytest.mark.parametrize('config', LIBRA_CONFIGS)
def test_libra_config_refuses_what_is_not_ported(config):
    cfg = Config.fromfile(os.path.join(ROOT, config))['model']
    with pytest.raises(NotImplementedError,
                       match='ROADMAP.md\'s "rest of the zoo" item'):
        with torch.device('meta'):
            build_detector(cfg)


def test_a_neck_list_builds_as_tpudets_chain():
    """A list ``neck`` (here the RetinaNet config's FPN alone) builds as
    tpudet's ``ChainedNeck``: the same param tree, ``neck/necks_0/...``,
    and on the same variables the same outputs."""
    import numpy as np

    from tpudet_torch.utils.flax_import import (load_flax_variables,
                                                random_flax_variables)
    path = os.path.join(ROOT, 'configs/retinanet/retinanet_r50_fpn_1x_coco.py')
    jcfg = JaxConfig.fromfile(path)['model']
    jcfg = dict(jcfg, backbone=dict(jcfg['backbone'], depth=18),
                neck=[dict(jcfg['neck'], in_channels=[64, 128, 256, 512],
                           out_channels=16)],
                bbox_head=dict(jcfg['bbox_head'], in_channels=16,
                               feat_channels=16, stacked_convs=1))
    jmodel = jax_build_detector(jcfg)
    img = np.random.RandomState(0).uniform(-1, 1, (1, 64, 64, 3)).astype(
        np.float32)
    ref = _flat_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                      jnp.asarray(img)))
    assert any(p[:3] == ('params', 'neck', 'necks_0') for p in ref)
    model = build_detector(jcfg)
    sd = model.state_dict()
    got = {p: flax_shape(sd[key].shape, kind)
           for p, (key, kind) in leaf_table(model).items()}
    assert got == ref
    variables = random_flax_variables(model, seed=1)
    load_flax_variables(model, variables)
    want = jmodel.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(img))
    for w, o in zip(jax.tree.leaves(want), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), out))):
        np.testing.assert_allclose(o, np.asarray(w), rtol=1e-4, atol=1e-4)


def _dataset_types(data_cfg):
    """The dataset types a ``data.train/val/test`` dict names, wrappers'
    inner datasets included."""
    out = set()
    if isinstance(data_cfg, (list, tuple)):
        for d in data_cfg:
            out |= _dataset_types(d)
    elif isinstance(data_cfg, dict):
        if 'type' in data_cfg:
            out.add(data_cfg['type'])
        for key in ('dataset', 'datasets'):
            out |= _dataset_types(data_cfg.get(key))
    return out


def _configs_with_other_datasets():
    out = []
    for p in sorted(glob.glob(os.path.join(ROOT, 'configs/**/*.py'),
                              recursive=True)):
        data = JaxConfig.fromfile(p).get('data') or {}
        types = set().union(*(_dataset_types(data.get(k))
                              for k in ('train', 'val', 'test')))
        if types - {'CocoDataset'}:
            out.append(os.path.relpath(p, ROOT))
    return out


DATASET_CONFIGS = [
    'configs/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py',
    'configs/deepfashion/mask_rcnn_r50_fpn_15e_deepfashion.py',
    'configs/garbage/yolov4l_garbage_mosaic.py',
    'configs/lvis/mask_rcnn_r50_fpn_sample1e-3_mstrain_1x_lvis_v1.py',
    'configs/pascal_voc/faster_rcnn_r50_fpn_1x_voc0712.py',
    'configs/pascal_voc/retinanet_r50_fpn_1x_voc0712.py',
    'configs/pascal_voc/ssd300_voc0712.py',
    'configs/tencent/yolov4l_traffic_sign.py',
    'configs/wider_face/ssd300_wider_face.py']


def test_the_dataset_sweep_holds_every_config_with_other_datasets():
    assert _configs_with_other_datasets() == DATASET_CONFIGS


@pytest.mark.parametrize('config', DATASET_CONFIGS)
def test_config_dataset_types_resolve_to_the_ported_classes(config):
    import tpudet.data  # noqa: F401  (registers the datasets)
    import tpudet_torch.data  # noqa: F401
    from tpudet.registry import DATASETS as JDATASETS
    from tpudet_torch.registry import DATASETS
    data = Config.fromfile(os.path.join(ROOT, config))['data']
    types = set().union(*(_dataset_types(data[k])
                          for k in ('train', 'val', 'test')))
    assert types - {'CocoDataset'}
    for t in types:
        cls, ref = DATASETS.get(t), JDATASETS.get(t)
        assert cls is not None, t
        assert cls.__name__ == ref.__name__ == t
        assert cls.__module__ == ref.__module__.replace('tpudet.',
                                                        'tpudet_torch.')
        assert getattr(cls, 'CLASSES', None) == getattr(ref, 'CLASSES',
                                                        None)
