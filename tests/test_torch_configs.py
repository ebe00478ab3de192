"""Every shipped YOLO, RetinaNet, two-stage, Mask R-CNN and zoo config
that the port registers builds in it with tpudet's param tree.

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
head's params exist only there). The 6 configs of ROADMAP.md's zoo row i
(Mask Scoring R-CNN, HTC, SCNet, PointRend, DetectoRS, YOLACT) too,
``forward_train`` fed tpudet's dummies by name (``gt_frame_masks``,
``gt_semantic_seg``). The DCN
ResNeXt-101 config is refused by both packages (tpudet's assertion, the
port's ``NotImplementedError`` with its message).

The 6 configs of ROADMAP.md's zoo row f and the two of row j that share
its assigner (``configs/gfl/``, ``configs/atss/``, ``configs/vfnet/``)
are swept like the RetinaNet configs; LD's (``configs/ld/``) through
``forward_train``, the only path that creates tpudet's teacher subtree.
The 5 configs of ROADMAP.md's zoo row h and row j's PAA (``configs/paa/``,
``configs/libra_rcnn/`` (a list ``neck``: tpudet's chain of necks, FPN
then BFP), ``configs/groie/``, ``configs/ghm/``) are swept like the
RetinaNet configs. The 8 one-stage configs of ROADMAP.md's zoo row j
that run on the RetinaNet machinery with no RoI head (``configs/fcos/``,
``nas_fcos/``, ``foveabox/``, ``autoassign/``, ``fsaf/``,
``free_anchor/``, ``yolof/``, ``nas_fpn/``) too, and the 5 of its row j2a
(``configs/reppoints/``, ``sabl/``, ``guided_anchoring/``: RepPoints, SABL
RetinaNet and Faster R-CNN, GA RetinaNet and Faster R-CNN; their RepPoints
moment leaf, deformable kernels, GroupNorms and SABL's 1-D conv and
transposed-conv kernels among the leaves). The 5 of its row j2b
(``configs/double_heads/``, ``dynamic_rcnn/``, ``grid_rcnn/``, ``pisa/``,
``cascade_rpn/``) through ``forward_train`` (the Grid head's params exist
only there). The probe over every config under ``configs/`` counts what
the port builds (113), refuses with ``NotImplementedError`` (1) and does
not register (``KeyError``, 13).

Every config whose ``data.train/val/test`` name a dataset other than
``CocoDataset`` (9, wrappers' inner datasets included) has each of those
types registered in the port, as the class of the same name ported from
tpudet's module of the same name, with tpudet's class names.
"""
import glob
import os
from functools import lru_cache, partial

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
# ROADMAP.md's zoo row h (Libra R-CNN and RetinaNet, GRoIE, GHM) and row
# j's PAA
ZOO_H_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/paa/*.py', 'configs/libra_rcnn/*.py',
                    'configs/groie/*.py', 'configs/ghm/*.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))
# ROADMAP.md's zoo row i: Mask Scoring R-CNN, HTC, SCNet, PointRend,
# DetectoRS (SAC backbone, RFP neck) and YOLACT
ZOO_I_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/ms_rcnn/*.py', 'configs/htc/*.py',
                    'configs/scnet/*.py', 'configs/point_rend/*.py',
                    'configs/detectors/*.py', 'configs/yolact/*.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))
# ROADMAP.md's zoo row j, its one-stage detectors on the RetinaNet
# machinery: FCOS, NAS-FCOS, FoveaBox, AutoAssign, FSAF, FreeAnchor, YOLOF,
# the NAS-FPN RetinaNet
ZOO_J_DENSE_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/fcos/*.py', 'configs/nas_fcos/*.py',
                    'configs/foveabox/*.py', 'configs/autoassign/*.py',
                    'configs/fsaf/*.py', 'configs/free_anchor/*.py',
                    'configs/yolof/*.py', 'configs/nas_fpn/*.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))
# ROADMAP.md's zoo row j2a, the anchor-refining families: RepPoints,
# SABL (RetinaNet and Faster R-CNN), Guided Anchoring (RetinaNet and
# Faster R-CNN)
ZOO_J2A_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/reppoints/*.py', 'configs/sabl/*.py',
                    'configs/guided_anchoring/*.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))
# ROADMAP.md's zoo row j2b, the R-CNN heads on Faster R-CNN's machinery:
# Double-Head, Dynamic R-CNN, Grid R-CNN, PISA and the Cascade RPN
ZOO_J2B_CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ('configs/double_heads/*.py', 'configs/dynamic_rcnn/*.py',
                    'configs/grid_rcnn/*.py', 'configs/pisa/*.py',
                    'configs/cascade_rpn/*.py')
    for p in glob.glob(os.path.join(ROOT, pattern)))
# the probe over configs/: (build, NotImplementedError, KeyError)
PROBE_COUNTS = (113, 1, 13)

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

# Libra R-CNN: FPN -> BFP chained necks, the IoU-balanced sampling and
# balanced L1 in the Faster R-CNN
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


def test_the_zoo_row_h_sweep_holds_five_configs():
    assert len(ZOO_H_CONFIGS) == 5
    assert set(LIBRA_CONFIGS) < set(ZOO_H_CONFIGS)
    assert not set(ZOO_H_CONFIGS) & set(
        CONFIGS + RETINA_CONFIGS + TWO_STAGE_CONFIGS + ZOO_ROW_CONFIGS +
        ZOO_DEG_CONFIGS + ATSS_FAMILY_CONFIGS + KD_CONFIGS)


def test_the_zoo_row_j_dense_sweep_holds_eight_configs():
    assert len(ZOO_J_DENSE_CONFIGS) == 8
    assert not set(ZOO_J_DENSE_CONFIGS) & set(
        CONFIGS + RETINA_CONFIGS + TWO_STAGE_CONFIGS + ZOO_ROW_CONFIGS +
        ZOO_DEG_CONFIGS + ATSS_FAMILY_CONFIGS + KD_CONFIGS + ZOO_H_CONFIGS +
        ZOO_I_CONFIGS)


def test_the_zoo_row_j2a_sweep_holds_five_configs():
    assert len(ZOO_J2A_CONFIGS) == 5
    assert not set(ZOO_J2A_CONFIGS) & set(
        CONFIGS + RETINA_CONFIGS + TWO_STAGE_CONFIGS + ZOO_ROW_CONFIGS +
        ZOO_DEG_CONFIGS + ATSS_FAMILY_CONFIGS + KD_CONFIGS + ZOO_H_CONFIGS +
        ZOO_I_CONFIGS + ZOO_J_DENSE_CONFIGS)


def test_the_zoo_row_j2b_sweep_holds_five_configs():
    assert len(ZOO_J2B_CONFIGS) == 5
    assert not set(ZOO_J2B_CONFIGS) & set(
        CONFIGS + RETINA_CONFIGS + TWO_STAGE_CONFIGS + ZOO_ROW_CONFIGS +
        ZOO_DEG_CONFIGS + ATSS_FAMILY_CONFIGS + KD_CONFIGS + ZOO_H_CONFIGS +
        ZOO_I_CONFIGS + ZOO_J_DENSE_CONFIGS + ZOO_J2A_CONFIGS)


def test_the_probe_counts_what_builds_and_what_is_refused():
    """Every config under ``configs/`` built on the meta device: 113
    build, 1 raises ``NotImplementedError`` (the DCN ResNeXt, refused by
    design), 13 raise ``KeyError`` (types the port does not register)."""
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
                         ZOO_DEG_CONFIGS + ATSS_FAMILY_CONFIGS + ZOO_H_CONFIGS +
                         ZOO_J_DENSE_CONFIGS)
def test_config_builds_with_tpudets_param_tree(config):
    assert_tpudets_tree(os.path.join(ROOT, config))


def assert_tpudets_tree(path):
    """The port's model of the config at ``path`` holds tpudet's param
    tree from ``init`` on a 64 px image."""
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


@pytest.mark.parametrize('config', ZOO_J2A_CONFIGS)
def test_zoo_j2a_config_builds_with_tpudets_param_tree(config):
    """Each of zoo row j2a's configs, leaf for leaf; the new kinds of leaf
    among them (RepPoints' ``moment_transfer``, the deformable kernels of
    RepPoints and of Guided Anchoring's ``FeatureAdaption``, SABL's 1-D
    ``x_post`` / ``x_up`` kernels)."""
    path = os.path.join(ROOT, config)
    assert_tpudets_tree(path)
    kind = config.split('/')[1]
    with torch.device('meta'):
        model = build_detector(Config.fromfile(path)['model'])
    leaves = {'/'.join(p[1:]): flax_shape(model.state_dict()[key].shape, k)
              for p, (key, k) in leaf_table(model).items()}
    want = {'reppoints': ('bbox_head/moment_transfer',
                          'bbox_head/cls_dcn/kernel'),
            'guided_anchoring': ('conv_adaption/kernel',),
            'sabl': ()}[kind]
    assert all(any(name.endswith(w) for name in leaves) for w in want)
    if 'sabl_faster' in config:
        assert leaves['roi_head/bbox_head/x_up/kernel'] == (2, 256, 256)
        assert leaves['roi_head/bbox_head/x_post/kernel'] == (3, 256, 256)


@pytest.mark.parametrize('config', ZOO_J2B_CONFIGS)
def test_zoo_j2b_config_builds_with_tpudets_param_tree(config):
    """Each of zoo row j2b's configs, leaf for leaf, tpudet's tree from
    ``init`` through ``forward_train`` (the Grid head's params exist only
    there); the new kinds of leaf among them (the Grid head's raw
    transposed-conv kernels and biases, its depthwise kernels and
    GroupNorms, the Double head's BatchNorms, the Cascade RPN's dilated and
    deformable kernels)."""
    path = os.path.join(ROOT, config)
    jmodel = jax_build_detector(JaxConfig.fromfile(path)['model'])
    g = 4
    args = (jnp.zeros((1, 64, 64, 3)),
            jnp.tile(jnp.asarray([[0., 0., 32., 32.]]), (1, g, 1)),
            jnp.zeros((1, g), jnp.int32), jnp.ones((1, g), bool))
    ref = _flat_shapes(jax.eval_shape(
        partial(jmodel.init, method='forward_train'), jax.random.PRNGKey(0),
        *args))
    assert_port_tree_is(path, ref)
    leaves = {'/'.join(p[1:]): shape for p, shape in ref.items()}
    want = {'double_heads': {
                'roi_head/bbox_head/res_ds_bn/mean': (1024,),
                'roi_head/bbox_head/conv_branch3/bn3/var': (1024,)},
            'dynamic_rcnn': {},
            'grid_rcnn': {
                'roi_head/grid_head/deconv1_kernel': (4, 4, 64, 576),
                'roi_head/grid_head/deconv2_bias': (9,),
                'roi_head/grid_head/so8_1_dw/kernel': (5, 5, 1, 64),
                'roi_head/grid_head/gn7/scale': (576,)},
            'pisa': {},
            'cascade_rpn': {
                'rpn_head/stage0/rpn_conv/kernel': (3, 3, 256, 256),
                'rpn_head/stage1/rpn_conv/kernel': (9, 256, 256)}}[
                    config.split('/')[1]]
    assert all(leaves[k] == v for k, v in want.items())


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
    # seven until the DCN and GCB ones (3, DEG_MASK_CONFIGS); the last
    # four are zoo row i's Mask R-CNN-based ones, built since
    assert len(REFUSED_MASK_CONFIGS) == 4
    assert set(REFUSED_MASK_CONFIGS) < set(ZOO_I_CONFIGS)


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
    """Nothing of the four is refused any more (HTC, SCNet, Mask Scoring
    R-CNN, PointRend): each builds with the mask branch the config names,
    and holds tpudet's param tree from ``forward_train``'s init."""
    with torch.device('meta'):
        model = build_detector(Config.fromfile(
            os.path.join(ROOT, config))['model'])
    heads = {n for n, _ in model.roi_head.named_children()}
    assert heads & {'mask_head', 'mask_head0'}
    assert_tpudets_forward_train_tree(os.path.join(ROOT, config))


def test_the_zoo_row_i_sweep_holds_six_configs():
    assert len(ZOO_I_CONFIGS) == 6
    assert not set(ZOO_I_CONFIGS) & set(
        CONFIGS + RETINA_CONFIGS + TWO_STAGE_CONFIGS + ZOO_ROW_CONFIGS +
        ZOO_DEG_CONFIGS + ATSS_FAMILY_CONFIGS + KD_CONFIGS + ZOO_H_CONFIGS +
        MASK_CONFIGS)


@lru_cache(maxsize=None)
def tpudets_forward_train_tree(path):
    """tpudet's param tree (path -> flax shape) of the config at ``path``
    from ``init`` through ``forward_train`` (64 px), fed tpudet's dummies
    by parameter name (``tpudet/train/train_state.py:39-75``): the mask,
    semantic and IoU heads exist only there. Cached: two tests of a
    config share one trace."""
    import inspect
    jmodel = jax_build_detector(JaxConfig.fromfile(path)['model'])
    g = 4
    dummies = dict(
        img=jnp.zeros((1, 64, 64, 3)),
        gt_bboxes=jnp.tile(jnp.asarray([[0., 0., 32., 32.]]), (1, g, 1)),
        gt_labels=jnp.zeros((1, g), jnp.int32),
        gt_valid=jnp.ones((1, g), bool), gt_frame_masks=jnp.ones((1, g, 28,
                                                                  28)),
        gt_semantic_seg=jnp.zeros((1, 8, 8), jnp.int32))
    args = [dummies[n] for n in
            inspect.signature(jmodel.forward_train).parameters]
    return _flat_shapes(jax.eval_shape(
        partial(jmodel.init, method='forward_train'), jax.random.PRNGKey(0),
        *args))


def assert_tpudets_forward_train_tree(path):
    """The port's model of the config at ``path`` holds tpudet's param tree
    from ``forward_train``'s init (``tpudets_forward_train_tree``)."""
    ref = tpudets_forward_train_tree(path)
    assert_port_tree_is(path, ref)
    return ref


@pytest.mark.parametrize('config', ZOO_I_CONFIGS)
def test_zoo_i_config_builds_with_tpudets_param_tree(config):
    """Each of zoo row i's configs, tpudet's tree through ``forward_train``
    with ``gt_frame_masks`` and, where it takes one, ``gt_semantic_seg``;
    DetectoRS's second backbone (``neck/rfp_module0``), its raw SAC leaves
    and YOLACT's protonet and semantic head among them."""
    ref = assert_tpudets_forward_train_tree(os.path.join(ROOT, config))
    kind = config.split('/')[1]
    want = {'ms_rcnn': ('roi_head', 'mask_iou_head'),
            'htc': ('roi_head', 'semantic_head'),
            'scnet': ('roi_head', 'glbctx_head'),
            'point_rend': ('roi_head', 'point_head'),
            'detectors': ('neck', 'rfp_module0'),
            'yolact': ('protonet',)}[kind]
    assert any(p[1:1 + len(want)] == want for p in ref)
    if kind == 'detectors':
        assert ('params', 'backbone', 'layer2_0', 'conv2',
                'weight_diff') in ref


def test_the_libra_sweep_holds_two_configs():
    assert len(LIBRA_CONFIGS) == 2


@pytest.mark.parametrize('config', LIBRA_CONFIGS)
def test_libra_config_refuses_what_is_not_ported(config):
    """Nothing of the two Libra configs is refused any more: each builds
    with tpudet's param tree, its neck the chain FPN -> BFP with the
    non-local refine (``neck/necks_1/refine/{g,theta,phi,conv_out}``)."""
    path = os.path.join(ROOT, config)
    with torch.device('meta'):
        model = build_detector(Config.fromfile(path)['model'])
    assert type(model.neck.necks_1).__name__ == 'BFP'
    assert {n for n, _ in model.neck.necks_1.refine.named_children()} == {
        'g', 'theta', 'phi', 'conv_out'}
    assert_tpudets_tree(path)


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
