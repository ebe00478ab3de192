"""The YOLOv5 modules of tpudet_torch against tpudet, on the CPU in fp32.

``SPPV5``, ``Focus``, ``BottleneckCSP`` (without shortcut, and grouped),
``DarknetCSP`` at the ``v5s5p`` scale (with Mish and with other
activations) and ``YOLOV5Neck`` at 128 px: one tpudet variables tree with
random BatchNorm statistics feeds both, carried by ``flax_import``.
Tolerance: max |delta| <= 1e-4 * max |ref| per output, as in
``test_torch_backbone_neck.py``.

A YOLOv5-s detector (the shipped config, its neck narrowed to 64 channels
at the two coarse levels, 4 classes, ``anchor_pre=256``) gives detections
one-to-one with tpudet's at the tolerances of ``test_torch_detector.py``:
label equal, box IoU >= 0.99, scores within 1e-4.

``get_activation`` matches tpudet on each of its names within 1e-6 (Mish:
the port's fp32 rational form against tpudet's literal chain).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.config import Config as JaxConfig
from tpudet.models import layers as jlayers
from tpudet.models.backbones import darknet_csp as jcsp
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.models.necks.yolo_neck_csp import YOLOV5Neck as JaxNeck
from tpudet_torch.apis import init_detector
from tpudet_torch.models import layers
from tpudet_torch.models.backbones import darknet_csp as csp
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.necks.yolo_neck_csp import YOLOV5Neck
from tpudet_torch.ops import mish as mish_mod
from tpudet_torch.utils.flax_import import (load_flax_variables,
                                            random_flax_variables)

from .test_torch_backbone_neck import _max_rel, random_variables
from .test_torch_detector import _np, _variables, assert_one_to_one
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, NUM_CLASSES = 128, 4
TOL = 1e-4


def _pair(jmodule, tmodule, x, seed):
    """Both modules on the NHWC input ``x`` from one variables tree;
    returns (tpudet's outputs, the port's outputs), NHWC numpy."""
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    variables = random_variables(shapes, seed)
    load_flax_variables(tmodule, variables)
    ref = jmodule.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodule.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    return ([np.asarray(r) for r in ref],
            [g.permute(0, 2, 3, 1).numpy() for g in got])


def _assert_close(ref, got):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _max_rel(g, r) <= TOL


def _x(seed, hw, c, b=2):
    return np.random.RandomState(seed).randn(b, hw, hw, c).astype(np.float32)


def test_sppv5_matches_tpudet():
    ref, got = _pair(jcsp.SPPV5(64, 48), csp.SPPV5(64, 48), _x(0, 16, 64), 1)
    _assert_close(ref, got)
    assert got[0].shape == (2, 16, 16, 48)


def test_focus_matches_tpudet_and_halves_the_image():
    """kernel 6, stride 2, padding 2: a 64-px image gives 32 px (padding 3
    would give 33)."""
    x = np.random.RandomState(2).uniform(-0.45, 0.55,
                                         (2, 64, 64, 3)).astype(np.float32)
    ref, got = _pair(jcsp.Focus(3, 32, 3), csp.Focus(3, 32, 3), x, 3)
    _assert_close(ref, got)
    assert got[0].shape == (2, 32, 32, 32)
    assert csp.Focus(3, 32, 3).conv.conv.padding == (2, 2)


@pytest.mark.parametrize('shortcut,groups', [(False, 1), (True, 2)],
                         ids=['no_shortcut', 'grouped'])
def test_bottleneck_csp_matches_tpudet(shortcut, groups):
    j = jcsp.BottleneckCSP(64, 64, 2, shortcut=shortcut, groups=groups)
    t = csp.BottleneckCSP(64, 64, 2, shortcut=shortcut, groups=groups)
    ref, got = _pair(j, t, _x(4, 16, 64), 5)
    _assert_close(ref, got)
    assert t.bottlenecks_0.add == shortcut


def test_bottleneck_csp_expansion_sets_the_hidden_width():
    t = csp.BottleneckCSP(64, 96, 1, expansion=0.25)
    assert t.conv1.conv.out_channels == 24
    assert t.csp_bn.bn.num_features == 48


@pytest.mark.parametrize('act,csp_act', [
    ('Mish', 'Mish'),
    (dict(type='LeakyReLU', negative_slope=0.1), 'SiLU')],
    ids=['mish', 'leaky_silu'])
def test_darknet_v5s_matches_tpudet(act, csp_act):
    x = np.random.RandomState(6).uniform(-0.45, 0.55,
                                         (2, IMG, IMG, 3)).astype(np.float32)
    j = jcsp.DarknetCSP(scale='v5s5p', out_indices=(2, 3, 4), act=act,
                        csp_act=csp_act)
    t = csp.DarknetCSP('v5s5p', out_indices=(2, 3, 4), act=act,
                       csp_act=csp_act)
    ref, got = _pair(j, t, x, 7)
    _assert_close(ref, got)
    assert [g.shape[-1] for g in got] == [128, 256, 512]
    assert [g.shape[1] for g in got] == [16, 8, 4]


def test_darknet_refuses_a_module_dtype_and_takes_the_s2d_flag():
    with pytest.raises(ValueError, match='set_dtype'):
        csp.DarknetCSP('v5s5p', dtype='bfloat16')
    plain = csp.DarknetCSP('v4s5p', space_to_depth_stem=False)
    s2d = csp.DarknetCSP('v4s5p', space_to_depth_stem=True)
    assert [k for k, _ in plain.named_parameters()] == \
        [k for k, _ in s2d.named_parameters()]


def test_yolov5_neck_matches_tpudet():
    widths, outs = (128, 256, 512), (128, 256, 512)
    rng = np.random.RandomState(8)
    feats = [rng.randn(2, IMG // s, IMG // s, c).astype(np.float32)
             for s, c in zip((8, 16, 32), widths)]
    jneck = JaxNeck(in_channels=widths, out_channels=outs, csp_repetition=1)
    shapes = jax.eval_shape(jneck.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats])
    variables = random_variables(shapes, seed=9)
    tneck = YOLOV5Neck(widths, outs, csp_repetition=1)
    load_flax_variables(tneck, variables)
    ref = jneck.apply(variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tneck.eval()(
            [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    _assert_close([np.asarray(r) for r in ref],
                  [g.permute(0, 2, 3, 1).numpy() for g in got])
    # no shortcut in any of the neck's CSP merges
    assert not any(m.add for m in tneck.modules()
                   if isinstance(m, csp.Bottleneck))


def _v5s_cfg():
    cfg = JaxConfig.fromfile(
        os.path.join(ROOT, 'configs/yolov5/yolov5s_coco_mosaic.py'))
    model = dict(cfg['model'])
    model['neck'] = dict(model['neck'], out_channels=[128, 64, 64])
    model['bbox_head'] = dict(model['bbox_head'], num_classes=NUM_CLASSES,
                              in_channels=[128, 64, 64])
    model['test_cfg'] = dict(model['test_cfg'], anchor_pre=256)
    return model


@pytest.fixture(scope='module')
def v5s_pair():
    cfg = _v5s_cfg()
    jmodel = jax_build_detector(cfg)
    variables = _variables(jmodel, seed=10)
    det = init_detector(cfg, variables=variables, device='cpu',
                        dtype=torch.float32)
    img = np.random.RandomState(11).uniform(
        -0.45, 0.55, (2, IMG, IMG, 3)).astype(np.float32)
    return jmodel, variables, det, img


def test_yolov5s_detector_matches_tpudet(v5s_pair):
    jmodel, variables, det, img = v5s_pair
    pm_ref = jmodel.apply(variables, jnp.asarray(img))
    pm = det.forward(img)
    for g, r in zip(pm, pm_ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        assert _max_rel(g.numpy(), r) <= TOL
    ref = _np(jmodel.get_bboxes(pm_ref))
    got = _np(det(img))
    assert ref['valid'].sum() > 20
    assert_one_to_one(ref, got)


def test_one_mish_per_bn_site_in_a_yolov5s_forward(monkeypatch):
    """59 BatchNorm sites in YOLOv5-s, each followed by one mish: the
    count the card's launch counter reads per forward."""
    model = build_detector(JaxConfig.fromfile(os.path.join(
        ROOT, 'configs/yolov5/yolov5s_coco_mosaic.py'))['model'])
    load_flax_variables(model, random_flax_variables(model, seed=0))
    calls = []
    real = mish_mod.mish_reference
    monkeypatch.setattr(mish_mod, 'mish_reference',
                        lambda x: calls.append(1) or real(x))
    with torch.no_grad():
        model.eval()(torch.zeros(1, 64, 64, 3))
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert len(calls) == n_bn == 59


ACTIVATIONS = ['Mish', 'relu', 'LeakyReLU',
               dict(type='LeakyReLU', negative_slope=0.2), 'SiLU', 'swish',
               'Sigmoid', 'tanh']


@pytest.mark.parametrize('act', ACTIVATIONS,
                         ids=lambda a: str(a.get('type') + '_0.2'
                                           if isinstance(a, dict) else a))
def test_get_activation_matches_tpudet(act):
    x = np.concatenate([np.linspace(-8, 8, 257),
                        np.random.RandomState(12).randn(64) * 3]).astype(
                            np.float32)
    ref = np.asarray(jlayers.get_activation(act)(jnp.asarray(x)))
    got = layers.get_activation(act)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def test_get_activation_none_and_unknown():
    assert layers.get_activation(None) is None
    with pytest.raises(KeyError, match='unknown activation'):
        layers.get_activation('gelu')
