"""The port's ``StandardRoIHead`` and ``Shared2FCBBoxHead`` against
tpudet's, on the CPU in fp32, from numpy seeds (3 classes, 16 channels,
4 FPN levels of a 128 px batch of 2, random kernels N(0, 1/fan_in),
biases N(0, 0.1^2)).

Tolerances:

- the bbox head alone, and pooling + head (``__call__``): atol 1e-5;
- ``sample_rois`` (the fixed ``RandomState(1)`` priority, the sampled-first
  slot table): rois, ``sampled``, labels, ``pos`` and ``is_gt`` equal,
  regression targets atol 1e-6; at tpudet's 512 samples and at 64 (both
  caps bind);
- ``loss`` (``'l1'`` and ``'smooth_l1'``) and its gradients: rtol 1e-5;
- ``get_bboxes`` (800 rois x 3 classes, so the top-2048 cap binds; clipped
  to per-image shapes and rescaled, or neither; class-specific and
  class-agnostic deltas): labels and ``valid`` equal, boxes atol 1e-3 px,
  scores atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.roi_heads.bbox_head import \
    Shared2FCBBoxHead as JaxBBoxHead
from tpudet.models.roi_heads.standard_roi_head import \
    StandardRoIHead as JaxRoIHead
from tpudet_torch.models.roi_heads import Shared2FCBBoxHead, StandardRoIHead
from tpudet_torch.utils.flax_import import load_flax_variables

from .test_torch_backbone_neck import random_variables
from .test_torch_roi_align import _rois
from .test_torch_rpn_head import gts
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

IMG, CH, NUM_CLASSES = 128, 16, 3
STRIDES = (4, 8, 16, 32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _feats(seed, b=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, IMG // s, IMG // s, CH).astype(np.float32)
            for s in STRIDES]


def _proposals(seed, b=2, n=800):
    """Random rois, a fifth of them jittered copies of the gts of
    ``gts(3)`` (so that some pass IoU 0.5), a tenth not valid."""
    rng = np.random.RandomState(seed)
    boxes, _, valid = gts(3, b=b)
    props = np.stack([_rois(rng, n) for _ in range(b)])
    for i in range(b):
        src = boxes[i][valid[i]]
        k = n // 5
        pick = src[rng.randint(0, len(src), k)]
        wh = (pick[:, 2:] - pick[:, :2])[:, [0, 1, 0, 1]]
        props[i, :k] = pick + rng.uniform(-0.2, 0.2, (k, 4)) * wh
    return props.astype(np.float32), rng.rand(b, n) > 0.1


@pytest.fixture(scope='module')
def roi_pair():
    jhead = JaxRoIHead(num_classes=NUM_CLASSES, in_channels=CH)
    feats = _feats(0)
    props, valid = _proposals(1)
    args = (tuple(jnp.asarray(f) for f in feats), jnp.asarray(props),
            jnp.asarray(valid))
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), *args)
    variables = random_variables(shapes, 2)
    head = StandardRoIHead(num_classes=NUM_CLASSES, in_channels=CH)
    load_flax_variables(head, variables)
    ref = jhead.apply(variables, *args)
    with torch.no_grad():
        got = head([_t(f).permute(0, 3, 1, 2) for f in feats], _t(props),
                   _t(valid))
    return jhead, variables, head, feats, props, valid, ref, got


def test_bbox_head_matches_tpudet():
    jhead = JaxBBoxHead(num_classes=5, in_channels=8)
    x = np.random.RandomState(3).randn(2, 10, 7, 7, 8).astype(np.float32)
    variables = random_variables(jax.eval_shape(
        jhead.init, jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    head = Shared2FCBBoxHead(num_classes=5, in_channels=8)
    load_flax_variables(head, variables)
    ref = jhead.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = head(_t(x))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == np.asarray(r).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_pooling_and_head_match_tpudet(roi_pair):
    *_, ref, got = roi_pair
    for g, r in zip(got, ref):
        assert tuple(g.shape) == np.asarray(r).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize('num_samples', [None, 64])
def test_sample_rois_equals_tpudets(roi_pair, num_samples):
    jhead, variables, head, _, props, valid, _, _ = roi_pair
    props, valid = props[:, :300], valid[:, :300]
    boxes, labels, gt_valid = gts(3)
    ref = jhead.apply(variables, jnp.asarray(props), jnp.asarray(valid),
                      jnp.asarray(boxes), jnp.asarray(labels),
                      jnp.asarray(gt_valid), num_samples=num_samples,
                      return_is_gt=True, method='sample_rois')
    got = head.sample_rois(_t(props), _t(valid), _t(boxes), _t(labels),
                           _t(gt_valid), num_samples=num_samples,
                           return_is_gt=True)
    names = ('rois', 'sampled', 'labels', 'targets', 'pos', 'is_gt')
    for name, g, r in zip(names, got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape, name
        if name == 'targets':
            np.testing.assert_allclose(g.numpy(), r, atol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    pos, sampled = got[4].numpy(), got[1].numpy()
    assert pos.sum(1).min() > 0 and (sampled & ~pos).sum(1).min() > 0
    if num_samples == 64:  # both caps bind
        assert pos.sum(1).max() == 16 and sampled.all()


@pytest.mark.parametrize('loss_bbox_type', ['l1', 'smooth_l1'])
def test_loss_and_gradients_match_tpudet(roi_pair, loss_bbox_type):
    jhead, variables, _, _, props, valid, ref, _ = roi_pair
    boxes, labels, gt_valid = gts(3)
    jhead = jhead.clone(loss_bbox_type=loss_bbox_type)
    head = StandardRoIHead(num_classes=NUM_CLASSES, in_channels=CH,
                           loss_bbox_type=loss_bbox_type)
    rois, sampled, lab, targets, pos = jhead.apply(
        variables, jnp.asarray(props), jnp.asarray(valid),
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(gt_valid),
        num_samples=800, method='sample_rois')
    # 3 x 4 outputs a roi: the class logits and the deltas of 3 classes
    rng = np.random.RandomState(5)
    cls = rng.randn(2, 800, NUM_CLASSES + 1).astype(np.float32)
    deltas = rng.randn(2, 800, 4 * NUM_CLASSES).astype(np.float32)

    def jax_total(c, d):
        out = jhead.apply(variables, c, d, lab, targets, pos, sampled,
                          method='loss')
        return out['loss_cls'] + out['loss_bbox'], out

    (_, jl), jg = jax.value_and_grad(jax_total, argnums=(0, 1),
                                     has_aux=True)(jnp.asarray(cls),
                                                   jnp.asarray(deltas))
    tc, td = _t(cls).requires_grad_(), _t(deltas).requires_grad_()
    tl = head.loss(tc, td, _t(lab).long(), _t(targets), _t(pos),
                   _t(sampled))
    (tl['loss_cls'] + tl['loss_bbox']).backward()
    for k in ('loss_cls', 'loss_bbox'):
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-5, err_msg=k)
    for t, r in zip((tc, td), jg):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def assert_detections_equal(got, ref, box_atol=1e-3, score_atol=1e-5):
    gb, gs, gl, gv = (np.asarray(t) for t in got)
    rb, rs, rl, rv = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gl, rl)
    np.testing.assert_allclose(gs, rs, atol=score_atol)
    np.testing.assert_allclose(gb, rb, atol=box_atol)


@pytest.mark.parametrize('agnostic', [False, True])
@pytest.mark.parametrize('clip', [True, False])
def test_get_bboxes_matches_tpudet(roi_pair, agnostic, clip):
    jhead, variables, head, _, props, valid, (cls, deltas), _ = roi_pair
    deltas = np.asarray(deltas)
    if agnostic:
        deltas = deltas[..., :4]
    sf = np.array([[2., 2., 2., 2.], [1.5, 1.25, 1.5, 1.25]], np.float32)
    hw = np.array([[IMG, IMG], [100, 90]], np.float32)
    kw = dict(score_thr=0.05, iou_thr=0.5, max_per_img=100)
    jkw, tkw = dict(kw), dict(kw)
    if clip:
        jkw.update(scale_factors=jnp.asarray(sf),
                   img_shape=(jnp.asarray(hw[:, :1]), jnp.asarray(hw[:, 1:])))
        tkw.update(scale_factors=_t(sf), img_shape=(_t(hw[:, :1]),
                                                    _t(hw[:, 1:])))
    ref = jhead.apply(variables, jnp.asarray(props), jnp.asarray(valid),
                      jnp.asarray(cls), jnp.asarray(deltas),
                      method='get_bboxes', **jkw)
    got = head.get_bboxes(_t(props), _t(valid), _t(cls), _t(deltas), **tkw)
    scores = torch.softmax(_t(cls), -1)[..., :-1] * _t(valid)[..., None]
    assert int((scores > 0.05).sum(dim=(1, 2)).min()) > 2048
    assert int(got.valid.sum(1).min()) == 100
    assert_detections_equal(got, ref)


@pytest.mark.parametrize('kw', [dict(roi_extractor='concat'),
                                dict(neg_sampling='ohem'),
                                dict(loss_bbox_type='giou')])
def test_unported_branches_raise(kw):
    """An option value the head has no branch for raises, naming the
    option (tpudet's ``generic``, ``iou_balanced`` and ``balanced_l1``
    are ported: ``test_torch_libra_ghm_groie.py``)."""
    with pytest.raises(ValueError, match=next(iter(kw))):
        StandardRoIHead(num_classes=3, **kw)
