"""NAS-FCOS (``NASFCOS_FPN``, ``NASFCOSHead``, ``NASFCOS``) in tpudet_torch
against tpudet, on the CPU.

The detector is tpudet's test config (``tests/test_models/
test_nasfcos.py``: ResNet-18, a 64-channel searched FPN, the searched head
with 8 GN groups), 5 classes and the shipped config's caps, at 128 px, a
batch of 2; random weights drawn for every leaf, so the deformable convs'
zero-init ``conv_offset`` samples off the grid and their masks are not
0.5, the level scales in [0.5, 1.5] (``test_torch_fcos_family.py``'s
helpers and tolerances: pred maps 1e-4 of each map's largest value; the
loss terms and their gradients on tpudet's maps rtol 1e-5; the keeps of
``get_bboxes`` equal, end to end one-to-one).

The float64 train step holds three levels (``num_outs=3``: P3-P5, the
searched topology's own outputs, the extra stride-2 levels left out):
XLA compiles tpudet's deformable convolution's float64 backward for
seconds a call site, 12 sites here against 20 at five levels. tpudet's
deformable sampling is fp32 even in a float64 run, as the port's is.
Tolerances as ``test_torch_atss_gfl.py``'s step: the losses and the
gradient norm rtol 1e-4, the state within 5e-3 of the step's change.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.necks import nasfcos_fpn as jnasfcos_fpn
from tpudet_torch.models.dense_heads.nasfcos_head import NASFCOS
from tpudet_torch.models.necks.nasfcos_fpn import SameConv, resize_to

from .test_models.test_nasfcos import nasfcos_cfg
from .test_torch_atss_gfl import (assert_step_matches, float64_step, gts,
                                  step_batch)
from .test_torch_fcos_family import (assert_get_bboxes_match,
                                     assert_loss_and_map_gradients,
                                     assert_maps_close, detector_pair,
                                     shipped, with_classes)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

KEYS = ('loss_cls', 'loss_bbox', 'loss_centerness')


def cfg(levels=5):
    c = shipped(with_classes(nasfcos_cfg()), 0.6)
    if levels != 5:
        c['neck'] = dict(c['neck'], num_outs=levels)
        c['bbox_head'] = dict(
            c['bbox_head'], strides=(8, 16, 32)[:levels],
            regress_ranges=((-1, 64), (64, 128), (128, 1e8))[:levels])
    return c


@pytest.fixture(scope='module')
def pair():
    return detector_pair(cfg(), 40)


def test_pred_maps_match_tpudet(pair):
    _, variables, det, _, ref, got = pair
    assert type(det.model) is NASFCOS
    assert [tuple(c.shape[1:3]) for c in got[0]] == [(16, 16), (8, 8),
                                                     (4, 4), (2, 2), (1, 1)]
    head = variables['params']['bbox_head']
    offsets = head['cls_dcn0']['conv_offset']['kernel']
    assert np.abs(offsets).max() > 0  # the sampling leaves the grid
    assert_maps_close(got, ref)


def test_loss_and_gradients_match_tpudet(pair):
    jmodel, _, det, _, ref, _ = pair
    tl = assert_loss_and_map_gradients(jmodel, det.model, ref, *gts(41),
                                       KEYS)
    assert all(float(tl[k]) > 0 for k in KEYS)


@pytest.mark.parametrize('rescale', [False, True])
def test_get_bboxes_matches_tpudet(pair, rescale):
    jmodel, _, det, _, ref, got = pair
    assert_get_bboxes_match(jmodel, det.model, ref, got, rescale, 0)


def test_a_train_step_matches_tpudet_in_float64():
    state0, jstate, jm, tstate, tm, _ = float64_step(cfg(3), step_batch(43))
    assert_step_matches(state0, jstate, jm, tstate, tm, KEYS)
    head = 'bbox_head'
    for leaf in ('scales',):
        assert not np.array_equal(tstate.params[head][leaf],
                                  state0.params[head][leaf])
    # the deformable convs' offset convs learn from their zero init
    off = tstate.params[head]['reg_dcn0']['conv_offset']['kernel']
    assert np.abs(off).max() > 0


@pytest.mark.parametrize('hw,target', [((5, 5), (10, 10)), ((5, 7), (9, 13)),
                                       ((12, 12), (4, 4)), ((11, 9), (5, 4)),
                                       ((6, 6), (6, 6))])
def test_resize_to_equals_tpudets(hw, target):
    """Nearest 2x up until the map covers the target, then cropped;
    max-pooled down by the floor ratio, then cropped."""
    x = np.random.RandomState(8).randn(2, *hw, 3).astype(np.float32)
    ref = np.asarray(jnasfcos_fpn._resize_to(jnp.asarray(x), target))
    got = resize_to(torch.from_numpy(x).permute(0, 3, 1, 2), target)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize('size', [8, 9, 42, 21])
def test_same_conv_pads_as_flax(size):
    """A stride-2 3x3 conv with flax's 'SAME' padding: odd and even
    sizes (an even one pads one pixel below and right only)."""
    import flax.linen as nn
    rng = np.random.RandomState(size)
    x = rng.randn(1, size, size, 4).astype(np.float32)
    conv = nn.Conv(6, (3, 3), (2, 2), padding='SAME')
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(conv.apply(variables, jnp.asarray(x)))
    tconv = SameConv(4, 6, 3, 2)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(np.asarray(
            variables['params']['kernel']).transpose(3, 2, 0, 1)))
        tconv.bias.copy_(torch.from_numpy(np.asarray(
            variables['params']['bias'])))
        got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)
