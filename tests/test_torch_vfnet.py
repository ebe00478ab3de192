"""``VFNetHead`` and the ``VFNet`` detector in tpudet_torch against
tpudet, on the CPU.

The detector is tpudet's test config (``tests/test_models/
test_vfnet.py``: ResNet-18, an FPN of 32 channels from c3 with extra
convs on the input, one stacked GN conv of 32 channels, 5 classes; the
shipped configs' ``test_cfg``), at
128 px, batches of 2; the float64 step at 64 px. Its weights are random
(``random_variables``), so the scores clear ``score_thr`` and the star
offsets spread over several pixels.

Tolerances, as ``test_torch_atss_gfl.py`` holds ATSS and GFL:

- pred maps within 1e-4 of each map's largest |value| (fp32, eval mode),
  and so the star offsets that both deformable convs of every level take
  (tpudet's read by ``flax.linen.intercept_methods``);
- ``loss`` on tpudet's own pred maps: each term rtol 1e-5, its gradient
  with respect to the maps rtol 1e-5 (atol 1e-5 of the largest |value|),
  with gts in one image and none in the other, and with none at all;
- ``get_bboxes`` of tpudet's pred maps: the keeps equal (boxes atol 1e-3
  px, scores 1e-5), rescaled and clipped to per-image shapes or not, the
  raw decode of ``with_nms=False``; end to end one-to-one;
- one train step (SGD, EMA) in float64 on both sides from tpudet's init:
  the losses and the gradient norm rtol 1e-4, the state within 5e-3 of
  the change the step made. The deformable sampling is fp32 in both
  packages, as tpudet's is even in a float64 run.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpudet.ops.deform_conv import DeformConv2d as JaxDeformConv2d
from tpudet_torch.models.detectors.single_stage import VFNet
from tpudet_torch.models.dense_heads import VFNetHead

from .test_models.test_vfnet import vfnet_cfg
from .test_torch_atss_gfl import (NUM_CLASSES, assert_get_bboxes_match,
                                  assert_loss_and_map_gradients,
                                  assert_maps_close, assert_step_matches,
                                  detector_pair, float64_step, gts,
                                  shipped_test_cfg, step_batch)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

KEYS = ('loss_cls', 'loss_bbox', 'loss_bbox_rf')


def apply_with_offsets(jmodel, variables, img):
    """tpudet's pred maps and the offsets each deformable conv took, in
    call order (sown by a method interceptor), from one jitted apply."""
    def sow_offsets(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxDeformConv2d):
            context.module.sow('intermediates', 'offsets', args[1])
        return next_fun(*args, **kwargs)
    with fnn.intercept_methods(sow_offsets):
        maps, inter = jax.jit(lambda v, x: jmodel.apply(
            v, x, mutable=['intermediates']))(variables, jnp.asarray(img))
    head = inter['intermediates']['bbox_head']
    offsets = [np.asarray(o) for name in ('refine_dcn', 'cls_dcn')
               for o in head[name]['offsets']]
    return maps, offsets


@pytest.fixture(scope='module')
def pair():
    out = detector_pair(shipped_test_cfg(vfnet_cfg(NUM_CLASSES)), 30,
                        apply_with_offsets)
    (maps, offsets), got = out[4], out[5]
    return out[:4] + (maps, got, offsets)


def test_pred_maps_match_tpudet(pair):
    _, variables, det, _, ref, got, _ = pair
    assert type(det.model) is VFNet
    assert type(det.model.bbox_head) is VFNetHead
    assert det.model.bbox_head.cls0_gn.eps == 1e-6  # flax's default
    assert set(variables['params']['bbox_head']) >= {
        'cls0_conv', 'cls0_gn', 'vfnet_reg_conv_conv', 'refine_dcn',
        'cls_dcn', 'scales', 'scales_refine'}
    assert [tuple(c.shape[1:3]) for c in got[0]] == [(16, 16), (8, 8),
                                                     (4, 4), (2, 2), (1, 1)]
    assert all((r > 0).all() for r in got[1] + got[2])  # exp-decoded
    assert_maps_close(got, ref)


def test_star_offsets_match_tpudet(pair):
    """The offsets each DCN call takes, level by level: (B, H, W, 18) in
    tpudet, (B, 18, H, W) in the port, y first; they reach several px."""
    _, _, det, img, _, _, ref = pair
    got = {}
    head = det.model.bbox_head
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: got.setdefault(name, []).append(
            args[1].permute(0, 2, 3, 1).numpy()))
        for name, m in (('refine_dcn', head.refine_dcn),
                        ('cls_dcn', head.cls_dcn))]
    try:
        det.forward(img)
    finally:
        for h in hooks:
            h.remove()
    got = got['refine_dcn'] + got['cls_dcn']
    assert len(got) == len(ref) == 10
    for g, r in zip(got, ref):
        assert g.shape == r.shape and r.shape[-1] == 18
        np.testing.assert_allclose(g, r, atol=1e-4 * np.abs(r).max())
    assert max(np.abs(r).max() for r in ref) > 3


@pytest.mark.parametrize('gt_case', ['one_image', 'none'])
def test_loss_and_gradients_match_tpudet(pair, gt_case):
    jmodel, _, det, _, ref, _, _ = pair
    boxes, labels, valid = gts(31)
    keys = KEYS
    if gt_case == 'none':
        valid[:] = False
        keys = KEYS[:1]
    tl = assert_loss_and_map_gradients(jmodel, det.model, ref, boxes, labels,
                                       valid, keys)
    if gt_case == 'none':
        assert float(tl['loss_bbox']) == float(tl['loss_bbox_rf']) == 0.0
    else:
        assert all(float(tl[k]) > 0 for k in KEYS)


@pytest.mark.parametrize('rescale', [False, True])
def test_get_bboxes_matches_tpudet(pair, rescale):
    jmodel, _, det, _, ref, got, _ = pair
    assert_get_bboxes_match(jmodel, det.model, ref, got, rescale)


def test_a_train_step_matches_tpudet_in_float64():
    state0, jstate, jm, tstate, tm, _ = float64_step(
        shipped_test_cfg(vfnet_cfg(NUM_CLASSES)), step_batch(32))
    assert_step_matches(state0, jstate, jm, tstate, tm, KEYS)
    head0, head = state0.params['bbox_head'], tstate.params['bbox_head']
    for leaf in ('scales', 'scales_refine'):
        assert not np.array_equal(head[leaf], head0[leaf])
    for dcn in ('refine_dcn', 'cls_dcn'):
        assert not np.array_equal(head[dcn]['kernel'], head0[dcn]['kernel'])
