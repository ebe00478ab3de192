"""Every shipped YOLO, RetinaNet and two-stage config builds in the port
with tpudet's param tree.

The configs under ``configs/yolov4/``, ``configs/yolov5/`` and
``configs/yolov5_ddp/`` and ``configs/shapes/yolo*.py`` (15 in all), and
the 13 RetinaNet configs (``configs/retinanet/``, the fp16, Pascal VOC and
shapes variants: ResNet-50/101, ResNeXt-101 32x4d and 64x4d), and the 11
two-stage configs (``configs/faster_rcnn/``, the fp16, Pascal VOC and
Cityscapes Faster R-CNN, ``rpn/`` and ``fast_rcnn/``), each read by
both packages' ``Config``: the port's model is built on the meta
device (no weights drawn), tpudet's tree comes from ``jax.eval_shape`` of
its ``init`` (no weights computed either; ``FastRCNN`` also takes padded
proposals). The port's leaf table must hold exactly tpudet's params and
BatchNorm statistics, by name, each with its shape (conv kernels HWIO,
Dense kernels (in, out)). Exact.
"""
import glob
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from tpudet.config import Config as JaxConfig
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet_torch.config import Config
from tpudet_torch.models.builder import build_detector
from tpudet_torch.utils.flax_import import leaf_table

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


@pytest.mark.parametrize('config', CONFIGS + RETINA_CONFIGS +
                         TWO_STAGE_CONFIGS)
def test_config_builds_with_tpudets_param_tree(config):
    path = os.path.join(ROOT, config)
    model_cfg = JaxConfig.fromfile(path)['model']
    jmodel = jax_build_detector(model_cfg)
    args = (jnp.zeros((1, 64, 64, 3)),)
    if model_cfg['type'] == 'FastRCNN':
        args += (jnp.zeros((1, 8, 4)), jnp.ones((1, 8), bool))
    ref = _flat_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                      *args))
    with torch.device('meta'):
        model = build_detector(Config.fromfile(path)['model'])
    sd = model.state_dict()
    got = {}
    for p, (key, is_kernel) in leaf_table(model).items():
        shape = tuple(sd[key].shape)
        got[p] = shape[2:] + shape[1::-1] if is_kernel else shape
    assert set(got) == set(ref)
    assert got == ref
