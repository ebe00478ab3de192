"""Every shipped YOLO and RetinaNet config builds in the port with
tpudet's param tree.

The configs under ``configs/yolov4/``, ``configs/yolov5/`` and
``configs/yolov5_ddp/`` and ``configs/shapes/yolo*.py`` (15 in all), and
the 13 RetinaNet configs (``configs/retinanet/``, the fp16, Pascal VOC and
shapes variants: ResNet-50/101, ResNeXt-101 32x4d and 64x4d), each read by
both packages' ``Config``: the port's model is built on the meta
device (no weights drawn), tpudet's tree comes from ``jax.eval_shape`` of
its ``init`` (no weights computed either). The port's leaf table must hold
exactly tpudet's params and BatchNorm statistics, by name, each with its
shape (conv kernels HWIO). Exact.
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


@pytest.mark.parametrize('config', CONFIGS + RETINA_CONFIGS)
def test_config_builds_with_tpudets_param_tree(config):
    path = os.path.join(ROOT, config)
    jmodel = jax_build_detector(JaxConfig.fromfile(path)['model'])
    ref = _flat_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                      jnp.zeros((1, 64, 64, 3))))
    with torch.device('meta'):
        model = build_detector(Config.fromfile(path)['model'])
    sd = model.state_dict()
    got = {}
    for p, (key, is_kernel) in leaf_table(model).items():
        shape = tuple(sd[key].shape)
        got[p] = shape[2:] + shape[1::-1] if is_kernel else shape
    assert set(got) == set(ref)
    assert got == ref
