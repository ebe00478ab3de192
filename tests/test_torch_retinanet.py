"""RetinaNet's modules in tpudet_torch against tpudet, on the CPU in fp32.

From numpy seeds, with these tolerances:

- ``AnchorGenerator``: base anchors, grid anchors and valid flags equal;
- ``bbox_overlaps`` (iou, iof, giou) and ``bbox_cxcywh`` equal;
- ``max_iou_assign``/``max_iou_assign_batch``: codes equal, on tpudet's
  own cases (``tests/test_models/test_retinanet.py:29-61``), on IoUs of
  exactly 0.4 and 0.5, on gts that tie between anchors and anchors that
  tie between gts, and on random gts over RetinaNet's anchor grid;
- ``DeltaXYWHBBoxCoder``: encode and decode within 1e-5 (rtol and atol),
  decode clipped to numbers and to per-image (B, 1) columns;
- ``reduce_loss``, ``smooth_l1_loss``, ``l1_loss``,
  ``sigmoid_focal_loss`` and their gradients: rtol 1e-5;
- ``ResNet`` (18, and 50 at ``base_channels=8``), ``ResNeXt`` and
  ``FPN`` (no extra convs, ``'on_input'``, ``'on_output'`` with ReLU):
  max |delta| <= 1e-4 * max |ref| per output;
- the detector at tpudet's test config (``retina_cfg()``: ResNet-18, an
  FPN of 64 channels, one stacked conv, 6 classes, 128 px): pred maps as
  above; the loss and its gradients rtol 1e-5; detections one-to-one
  (label, IoU >= 0.99, scores within 1e-4), hard and soft NMS, rescaled
  and clipped to per-image shapes; one train step (SGD, warm-up, EMA, BN
  in train mode): losses and grad norm rtol 1e-4, the state within 5e-3
  of the update, as ``test_torch_train_step.py``;
- the optimiser's group labels of every ResNet/FPN/head leaf equal;
- the two repairs of the YOLO slices: ``SingleStageDetector.get_bboxes``
  forwards ``sigma``, ``min_score`` and ``method`` and maps ``nms_pre <=
  0`` to 0; ``random_flax_variables`` draws each conv by its own
  initializer (FPN ``xavier_uniform`` with zero bias, the head N(0,
  0.01^2) with ``retina_cls``'s prior bias);
- the entry points on a RetinaNet config (the shapes config narrowed to
  ResNet-18 at 128 px, JPEGs that cv2 wrote): ``train_detector`` for 2
  steps with a checkpoint and the EMA evaluation, then the test CLI on its
  weights, its report equal to the API's within 1e-6.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.core import anchors as janchors
from tpudet.core import assigners as jassign
from tpudet.core import bbox as jbbox
from tpudet.models import losses as jlosses
from tpudet.models.backbones.resnet import ResNet as JaxResNet
from tpudet.models.backbones.resnet import ResNeXt as JaxResNeXt
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.models.necks.fpn import FPN as JaxFPN
from tpudet.train.optim import YoloSGDConfig as JaxSGDConfig
from tpudet.train.optim import param_group_label
from tpudet.train.train_state import create_train_state as jax_create_state
from tpudet.train.train_state import make_train_step as jax_make_train_step
from tpudet_torch.apis import init_detector
from tpudet_torch.core import anchors as tanchors
from tpudet_torch.core import assigners as tassign
from tpudet_torch.core import bbox as tbbox
from tpudet_torch.models import losses as tlosses
from tpudet_torch.models.backbones.resnet import ResNet, ResNeXt
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.detectors.single_stage import (RetinaNet,
                                                        SingleStageDetector)
from tpudet_torch.models.necks.fpn import FPN
from tpudet_torch.train.optim import YoloSGDConfig, param_labels
from tpudet_torch.train.train_state import make_train_step
from tpudet_torch.utils.flax_import import (leaf_table, load_flax_variables,
                                            random_flax_variables,
                                            train_state_from_flax,
                                            train_state_to_flax)

from .test_models.test_retinanet import retina_cfg
from .test_torch_backbone_neck import _max_rel, random_variables
from .test_torch_detector import _iou, _np
from .test_torch_test_flow import CLASSES, NO_RESIZE, _write_set
from .test_torch_train_step import assert_tree_close
from . import torch_fixtures

IMG, NUM_CLASSES = 128, 6
TOL = 1e-4


def _t(*arrays):
    out = [torch.from_numpy(np.asarray(a)) for a in arrays]
    return out[0] if len(out) == 1 else out


# anchors, IoU, assigner, coder

ANCHOR_CASES = [
    dict(strides=[8, 16, 32, 64, 128], ratios=[0.5, 1.0, 2.0],
         octave_base_scale=4, scales_per_octave=3),
    dict(strides=[(8, 6), 16], ratios=[0.5, 2.0], scales=[1.0, 1.5],
         scale_major=False, center_offset=0.5),
    dict(strides=[8, 16], ratios=[1.0], scales=[2.0], base_sizes=[10, 20],
         centers=[(3, 4), (7, 7)]),
]


@pytest.mark.parametrize('case', range(len(ANCHOR_CASES)))
def test_anchor_generator_equals_tpudets(case):
    kw = ANCHOR_CASES[case]
    ref = janchors.AnchorGenerator(**kw)
    got = tanchors.AnchorGenerator(**kw)
    for a, b in zip(got.base_anchors, ref.base_anchors):
        np.testing.assert_array_equal(a, b)
    sizes = [(17, 13), (9, 7), (5, 4), (3, 2), (1, 1)][:len(kw['strides'])]
    for a, b in zip(got.grid_anchors(sizes), ref.grid_anchors(sizes)):
        np.testing.assert_array_equal(a, b)
    for pad in ((100, 90), (136, 104), (7, 200)):
        for a, b in zip(got.valid_flags(sizes, pad),
                        ref.valid_flags(sizes, pad)):
            np.testing.assert_array_equal(a, b)
    assert got.num_base_anchors == ref.num_base_anchors


def _random_boxes(rng, shape, size=128.):
    xy = rng.rand(*shape, 2).astype(np.float32) * size
    wh = rng.rand(*shape, 2).astype(np.float32) * size * 0.5 + 1
    return np.concatenate([xy, xy + wh], -1)


@pytest.mark.parametrize('mode', ['iou', 'iof', 'giou'])
def test_bbox_overlaps_equal_tpudets(mode):
    rng = np.random.RandomState(0)
    a, b = _random_boxes(rng, (2, 50)), _random_boxes(rng, (2, 30))
    a[0, :5] = b[0, :5]  # identical pairs
    np.testing.assert_array_equal(
        tbbox.bbox_overlaps(*_t(a, b), mode=mode).numpy(),
        np.asarray(jbbox.bbox_overlaps(jnp.asarray(a), jnp.asarray(b),
                                       mode=mode)))
    np.testing.assert_array_equal(
        tbbox.bbox_overlaps_aligned(*_t(a[:, :30], b), mode=mode).numpy(),
        np.asarray(jbbox.bbox_overlaps_aligned(
            jnp.asarray(a[:, :30]), jnp.asarray(b), mode=mode)))
    np.testing.assert_array_equal(tbbox.bbox_cxcywh(_t(a)).numpy(),
                                  np.asarray(jbbox.bbox_cxcywh(a)))


def _codes(anchors, gts, valid, *args):
    ref = np.asarray(jassign.max_iou_assign(
        jnp.asarray(anchors), jnp.asarray(gts), jnp.asarray(valid), *args))
    got = tassign.max_iou_assign(*_t(anchors, gts, valid), *args).numpy()
    np.testing.assert_array_equal(got, ref)
    return got


def test_assigner_tpudets_own_cases():
    """tests/test_models/test_retinanet.py:29-61, codes held equal."""
    anchors = np.array([[0, 0, 10, 10], [20, 20, 30, 30], [0, 0, 9, 11],
                        [100, 100, 110, 110]], np.float32)
    gts = np.array([[0, 0, 10, 10], [21, 21, 31, 31]], np.float32)
    out = _codes(anchors, gts, np.array([True, True]), 0.5, 0.4, 0.0, True)
    assert out[0] == 0 and out[1] == 1 and out[3] == tassign.NEGATIVE
    out2 = _codes(anchors, np.array([[0, 0, 10, 20]], np.float32),
                  np.array([True]), 0.5, 0.4, 0.0, True)
    assert out2[0] == 0
    out3 = _codes(anchors, gts, np.array([False, False]), 0.5, 0.4, 0.0,
                  True)
    assert (out3 == tassign.NEGATIVE).all()
    out4 = _codes(anchors[:1], np.array([[0, 0, 10, 22.2]], np.float32),
                  np.array([True]), 0.5, 0.4, 0.0, False)
    assert out4[0] == tassign.IGNORE


def test_assigner_thresholds_and_ties():
    """IoUs of exactly 0.5 and 0.4; a gt centred between two anchors of
    one shape (equal IoUs: both claim it with ``gt_max_assign_all``, only
    the first without); one anchor that two gts tie on (the argmax takes
    the first gt, the low-quality claim the last)."""
    anchors = np.array([[0, 0, 10, 10], [10, 0, 20, 10], [40, 0, 50, 10],
                        [60, 0, 70, 10], [80, 0, 90, 10]], np.float32)
    gts = np.array([[0, 20, 10, 40],      # no overlap: padding-like
                    [5, 0, 15, 10],       # ties anchors 0 and 1
                    [40, 0, 50, 20],      # IoU 0.5 with anchor 2
                    [60, 0, 70, 25],      # IoU 0.4 with anchor 3
                    [80, 0, 90, 5],       # IoU 0.5 with anchor 4 ...
                    [80, 5, 90, 10]],     # ... and this one too: a tie
                   np.float32)
    valid = np.array([False, True, True, True, True, True])
    for args in ((0.5, 0.4, 0.0, True, True), (0.5, 0.4, 0.0, True, False),
                 (0.5, 0.4, 0.0, False), (0.6, 0.4, 0.45, True),
                 (0.5, 0.3, 0.0, True)):
        _codes(anchors, gts, valid, *args)
    out = _codes(anchors, gts, valid, 0.5, 0.4, 0.0, True, True)
    assert out.tolist()[:2] == [1, 1] and out[2] == 2 and out[3] == 3
    assert out[4] == 5  # the highest gt index of the tie claims it
    out = _codes(anchors, gts, valid, 0.5, 0.4, 0.0, True, False)
    assert out.tolist()[:2] == [1, tassign.NEGATIVE]  # IoU 1/3
    out = _codes(anchors, gts, valid, 0.5, 0.4, 0.0, False)
    assert out[2] == 2 and out[3] == tassign.IGNORE  # 0.5 and 0.4 exactly
    assert out[4] == 4  # argmax: the first gt of the tie


def test_assigner_batch_over_retinanets_grid():
    """Random gts, 1-20 per image, over the anchors of RetinaNet at 320
    (19,206 anchors, many exact IoU ties between anchors of one shape)."""
    gen = tanchors.AnchorGenerator(strides=[8, 16, 32, 64, 128],
                                   ratios=[0.5, 1.0, 2.0],
                                   octave_base_scale=4, scales_per_octave=3)
    anchors = np.concatenate(gen.grid_anchors(
        [(40, 40), (20, 20), (10, 10), (5, 5), (3, 3)]))
    rng = np.random.RandomState(1)
    gts = _random_boxes(rng, (3, 20), size=320.)
    gts[0, 3] = anchors[1000]  # an exact anchor
    valid = np.zeros((3, 20), bool)
    valid[0, :20], valid[1, :1] = True, True  # image 2: no gt at all
    ref = np.asarray(jassign.max_iou_assign_batch(
        jnp.asarray(anchors), jnp.asarray(gts), jnp.asarray(valid), 0.5,
        0.4, 0.0, True))
    got = tassign.max_iou_assign_batch(*_t(anchors, gts, valid), 0.5, 0.4,
                                       0.0, True).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[0] >= 0).sum() > 20 and (got[2] == tassign.NEGATIVE).all()
    assert (got == tassign.IGNORE).any()


def test_delta_coder_matches_tpudet():
    rng = np.random.RandomState(2)
    anchors = _random_boxes(rng, (2, 300))
    gts = _random_boxes(rng, (2, 300))
    gts[0, :4] = 0  # padded rows: the 1e-6 clamp, no log(0)
    kw = dict(target_means=(0.1, -0.1, 0.05, 0.), target_stds=(0.1, 0.1,
                                                                 0.2, 0.2))
    jc, tc = jbbox.DeltaXYWHBBoxCoder(**kw), tbbox.DeltaXYWHBBoxCoder(**kw)
    ref = np.asarray(jc.encode(jnp.asarray(anchors), jnp.asarray(gts)))
    got = tc.encode(*_t(anchors, gts)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    deltas = rng.randn(2, 300, 4).astype(np.float32) * 3  # past the clip
    cols = np.array([[100.], [70.]], np.float32), np.array([[90.], [128.]],
                                                           np.float32)
    for max_shape in (None, (100, 90), cols):
        jshape = None if max_shape is None else tuple(
            jnp.asarray(m) for m in max_shape)
        tshape = None if max_shape is None else tuple(
            m if isinstance(m, int) else torch.from_numpy(m)
            for m in max_shape)
        ref = np.asarray(jc.decode(jnp.asarray(anchors), jnp.asarray(deltas),
                                   max_shape=jshape))
        got = tc.decode(*_t(anchors, deltas), max_shape=tshape).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    free = tbbox.DeltaXYWHBBoxCoder(clip_border=False)
    ref = np.asarray(jbbox.DeltaXYWHBBoxCoder(clip_border=False).decode(
        jnp.asarray(anchors), jnp.asarray(deltas), max_shape=(100, 90),
        wh_ratio_clip=0.1))
    got = free.decode(*_t(anchors, deltas), max_shape=(100, 90),
                      wh_ratio_clip=0.1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert got.max() > 100  # not clipped
    with pytest.raises(NotImplementedError, match='YOLOF'):
        tbbox.DeltaXYWHBBoxCoder(add_ctr_clamp=True)


# losses

def _loss_pair(name, kwargs, pred, target, weight=None, avg=None):
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)
    extra = {}
    if weight is not None:
        extra['weight'] = weight
    jw = {k: jnp.asarray(v) for k, v in extra.items()}
    if avg is not None:
        jw['avg_factor'] = jnp.asarray(avg)

    def jloss(p):
        out = jfn(p, jnp.asarray(target), **jw, **kwargs)
        return jnp.sum(out), out

    (_, ref), ref_grad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    tw = {k: torch.from_numpy(v) for k, v in extra.items()}
    if avg is not None:
        tw['avg_factor'] = torch.tensor(avg)
    got = tfn(tp, torch.from_numpy(target), **tw, **kwargs)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-7)
    r = np.asarray(ref_grad)
    np.testing.assert_allclose(tp.grad.numpy(), r, rtol=1e-5,
                               atol=1e-5 * np.abs(r).max())


LOSS_CASES = {
    'l1_mean': ('l1_loss', {}),
    'l1_none': ('l1_loss', dict(reduction='none')),
    'l1_sum': ('l1_loss', dict(reduction='sum', loss_weight=2.0)),
    'smooth_l1': ('smooth_l1_loss', {}),
    'smooth_l1_beta': ('smooth_l1_loss', dict(beta=0.11)),
    'focal': ('sigmoid_focal_loss', {}),
    'focal_gamma': ('sigmoid_focal_loss', dict(gamma=1.5, alpha=0.5,
                                               loss_weight=0.5)),
}


@pytest.mark.parametrize('case', list(LOSS_CASES))
@pytest.mark.parametrize('weighted', [False, True])
def test_losses_and_gradients_match_tpudet(case, weighted):
    name, kwargs = LOSS_CASES[case]
    rng = np.random.RandomState(3)
    pred = (rng.randn(2, 50, 4) * 3).astype(np.float32)
    if name == 'sigmoid_focal_loss':
        target = (rng.rand(2, 50, 4) < 0.2).astype(np.float32)
    else:
        target = (rng.randn(2, 50, 4) * 2).astype(np.float32)
    weight = avg = None
    if weighted:
        weight = (rng.rand(2, 50, 1) < 0.7).astype(np.float32)
        avg = 17.0
    _loss_pair(name, kwargs, pred, target, weight, avg)


def test_reduce_loss_matches_tpudet():
    rng = np.random.RandomState(4)
    loss = rng.rand(3, 5).astype(np.float32)
    weight = (rng.rand(3, 5) < 0.5).astype(np.float32)
    for kw in (dict(), dict(reduction='sum'), dict(reduction='none'),
               dict(weight=weight), dict(weight=weight, avg_factor=4.0),
               dict(reduction='sum', weight=weight)):
        ref = np.asarray(jlosses.reduce_loss(jnp.asarray(loss), **kw))
        got = tlosses.reduce_loss(torch.from_numpy(loss), **{
            k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5)


# backbone and neck

def _pair(jmodule, tmodule, x, seed):
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    variables = random_variables(shapes, seed)
    load_flax_variables(tmodule, variables)
    ref = jmodule.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodule.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return ref, got


def _assert_nhwc_close(ref, got):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == np.asarray(r).shape
        assert _max_rel(g, np.asarray(r)) <= TOL


def _img(seed, b=2, hw=IMG, c=3):
    return np.random.RandomState(seed).uniform(
        -2, 2, (b, hw, hw, c)).astype(np.float32)


@pytest.mark.parametrize('kw', [
    dict(depth=18), dict(depth=50, base_channels=8),
    dict(depth=50, base_channels=8, out_indices=(1, 3))],
    ids=['r18', 'r50_base8', 'r50_base8_out13'])
def test_resnet_matches_tpudet(kw):
    ref, got = _pair(JaxResNet(**kw), ResNet(**kw), _img(5), 6)
    _assert_nhwc_close(ref, got)
    assert len(got) == len(kw.get('out_indices', (0, 1, 2, 3)))


def test_resnext_matches_tpudet():
    kw = dict(depth=50, base_channels=8, groups=2, base_width=16)
    ref, got = _pair(JaxResNeXt(**kw), ResNeXt(**kw), _img(7, hw=64), 8)
    _assert_nhwc_close(ref, got)


def test_resnet_refuses_what_is_not_ported():
    # GN and weight standardization are ported: test_torch_gn_ws.py
    for kw in (dict(stage_with_dcn=(False, True, True, True)),
               dict(plugins=[dict(cfg=dict(type='ContextBlock'))])):
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            ResNet(depth=18, **kw)


@pytest.mark.parametrize('extra', [
    dict(add_extra_convs=False), dict(add_extra_convs='on_input'),
    dict(add_extra_convs='on_output', relu_before_extra_convs=True)],
    ids=['maxpool', 'on_input', 'on_output_relu'])
def test_fpn_matches_tpudet(extra):
    chans = [8, 16, 32, 64]
    rng = np.random.RandomState(9)
    feats = [rng.randn(2, 32 // 2**i, 32 // 2**i, c).astype(np.float32)
             for i, c in enumerate(chans)]
    kw = dict(in_channels=chans, out_channels=24, start_level=1, num_outs=5,
              **extra)
    jfpn, tfpn = JaxFPN(**kw), FPN(**kw)
    shapes = jax.eval_shape(jfpn.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats])
    variables = random_variables(shapes, 10)
    load_flax_variables(tfpn, variables)
    ref = jfpn.apply(variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tfpn([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    _assert_nhwc_close(ref, got)
    assert [g.shape[-1] for g in got] == [16, 8, 4, 2, 1]


# the detector at tpudet's test config

def _det_variables(jmodel, seed):
    """Random BN statistics and kernels N(0, 1/fan_in): the class logits
    spread around 0, so thousands of (box, class) pairs clear score_thr
    0.05 and every NMS stage works. The deltas are drawn 10x narrower, so
    that boxes keep sizes near their anchors' (a box under 1 px high
    makes IoU a poor judge of a 1e-4 px rounding)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMG, IMG, 3)))
    variables = random_variables(shapes, seed)
    reg = variables['params']['bbox_head']['retina_reg']
    reg['kernel'] = reg['kernel'] * 0.1
    reg['bias'] = reg['bias'] * 0.1
    return variables


def _gts(seed, b=2, g=5):
    rng = np.random.RandomState(seed)
    gt = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate((g, 2)[:b]):
        xy = rng.rand(n, 2) * IMG * 0.6
        wh = rng.rand(n, 2) * IMG * 0.35 + 8
        gt[i, :n] = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1)
        valid[i, :n] = True
    labels = rng.randint(0, NUM_CLASSES, (b, g)).astype(np.int32)
    return gt, labels, valid


def assert_one_to_one(ref, got, iou_min=0.99, corner_px=1e-3,
                      score_atol=1e-4):
    """Per image: the valid detections pair up one-to-one, same label,
    scores within score_atol, IoU >= iou_min or, for boxes that clipping
    left without area (IoU undefined), corners within corner_px."""
    for i in range(ref['valid'].shape[0]):
        rv, gv = ref['valid'][i], got['valid'][i]
        assert rv.sum() == gv.sum()
        rb, gb = ref['bboxes'][i][rv], got['bboxes'][i][gv]
        with np.errstate(invalid='ignore'):
            close = _iou(rb, gb) >= iou_min
        close |= np.abs(rb[:, None] - gb[None]).max(-1) <= corner_px
        ok = close & (ref['labels'][i][rv][:, None] ==
                      got['labels'][i][gv][None, :]) & (np.abs(
                          ref['scores'][i][rv][:, None] -
                          got['scores'][i][gv][None, :]) <= score_atol)
        used = np.zeros(len(gb), bool)
        for r in range(len(rb)):
            cand = np.nonzero(ok[r] & ~used)[0]
            assert len(cand), f'image {i}: detection {r} has no match'
            used[cand[0]] = True


@pytest.fixture(scope='module')
def detector_pair():
    cfg = retina_cfg(num_classes=NUM_CLASSES)
    jmodel = jax_build_detector(cfg)
    variables = _det_variables(jmodel, 11)
    det = init_detector(cfg, variables=variables, device='cpu',
                        dtype=torch.float32)
    img = _img(12, hw=IMG) * 0.5
    ref = jmodel.apply(variables, jnp.asarray(img))
    return cfg, jmodel, variables, det, img, ref


def test_detector_pred_maps_match_tpudet(detector_pair):
    _, _, _, det, img, ref = detector_pair
    got = det.forward(img)
    assert type(det.model) is RetinaNet
    for g_lvls, r_lvls in zip(got, ref):
        assert len(g_lvls) == 5
        for g, r in zip(g_lvls, r_lvls):
            assert tuple(g.shape) == np.asarray(r).shape
            assert _max_rel(g.numpy(), np.asarray(r)) <= TOL


def test_detector_loss_and_gradients_match_tpudet(detector_pair):
    _, jmodel, _, det, _, ref = detector_pair
    gt, labels, valid = _gts(13)
    keys = ('loss_cls', 'loss_bbox')

    def jax_total(preds):
        out = jmodel.loss(preds, jnp.asarray(gt), jnp.asarray(labels),
                          jnp.asarray(valid))
        return sum(out[k] for k in keys), out

    (_, jl), jg = jax.value_and_grad(jax_total, has_aux=True)(
        jax.tree.map(jnp.asarray, ref))
    tpreds = tuple(tuple(torch.tensor(np.asarray(r)).requires_grad_()
                         for r in lvls) for lvls in ref)
    tl = det.model.loss(tpreds, *_t(gt, labels, valid))
    sum(tl[k] for k in keys).backward()
    for k in keys + ('num_gts',):
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(tl['loss_bbox'].detach()) > 0
    for t_lvls, r_lvls in zip(tpreds, jg):
        for t, r in zip(t_lvls, r_lvls):
            r = np.asarray(r)
            np.testing.assert_allclose(t.grad.numpy(), r,
                                       atol=1e-5 * np.abs(r).max(),
                                       rtol=1e-5)


NMS_CFGS = {
    'nms': dict(nms=dict(type='nms', iou_threshold=0.5)),
    'soft_nms': dict(nms=dict(type='soft_nms', iou_threshold=0.3,
                              min_score=0.05, method='linear')),
    'soft_nms_gaussian_uncapped': dict(
        nms_pre=-1, nms=dict(type='soft_nms', iou_threshold=0.3,
                             sigma=0.3, min_score=0.1, method='gaussian')),
}


@pytest.mark.parametrize('case', list(NMS_CFGS))
def test_detector_detections_match_tpudet(detector_pair, case):
    cfg, _, variables, _, img, ref = detector_pair
    cfg = dict(cfg, test_cfg=dict(cfg['test_cfg'], **NMS_CFGS[case]))
    jmodel = jax_build_detector(cfg)
    det = init_detector(cfg, variables=variables, device='cpu',
                        dtype=torch.float32)
    sf = np.array([[2., 2., 2., 2.], [1.5, 1.25, 1.5, 1.25]], np.float32)
    hw = np.array([[IMG, IMG], [100, 90]], np.float32)
    kw = dict(scale_factors=jnp.asarray(sf),
              img_shape=(jnp.asarray(hw[:, :1]), jnp.asarray(hw[:, 1:])))
    rj = _np(jmodel.get_bboxes(ref, **kw))
    preds = det.forward(img)
    rt = _np(det.model.get_bboxes(
        preds, scale_factors=torch.from_numpy(sf),
        img_shape=(torch.from_numpy(hw[:, :1]), torch.from_numpy(hw[:, 1:]))))
    assert rj['valid'].sum(1).min() >= 10
    assert_one_to_one(rj, rt)
    # through Detector.__call__ (no img_shape, as tpudet's Detector)
    rj = _np(jmodel.get_bboxes(ref, scale_factors=jnp.asarray(sf)))
    assert_one_to_one(rj, _np(det(img, sf)))


def test_with_nms_false_returns_the_raw_decode(detector_pair):
    _, jmodel, _, det, img, ref = detector_pair
    jb, js = jmodel.bbox_head.get_bboxes(ref, with_nms=False)
    tb, ts = det.model.bbox_head.get_bboxes(det.forward(img), with_nms=False)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    assert ts.shape[-1] == NUM_CLASSES + 1 and not ts[..., -1].any()


OPT = dict(lr=0.01, momentum=0.9, weight_decay=1e-4, nesterov=False,
           total_steps=50, warmup_iters=3, steps_per_epoch=0,
           grad_clip_norm=10.0, lr_weight_warmup_ratio=0.001,
           lr_bias_warmup_ratio=0.001, momentum_warmup_ratio=1.0)
EMA = dict(ema_momentum_base=0.9999, ema_warm_up=4, ema_interval=1)


@pytest.fixture(scope='module')
def step_runs():
    cfg = retina_cfg(num_classes=NUM_CLASSES)
    jmodel = jax_build_detector(cfg)
    jopt = JaxSGDConfig(**OPT)
    state0 = jax.device_get(jax_create_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), jopt))
    gt, labels, valid = _gts(14)
    batch = dict(img=_img(15) * 0.5, gt_bboxes=gt, gt_labels=labels,
                 gt_valid=valid)
    jstate, jm = jax.jit(jax_make_train_step(jmodel, jopt, **EMA))(state0,
                                                                  batch)
    model = build_detector(cfg)
    opt = YoloSGDConfig(**OPT)
    state = train_state_from_flax(state0, model, opt)
    with torch_fixtures.default_threads():  # momentum_buf's margin
        state, tm = make_train_step(model, opt, **EMA)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return (state0, jax.device_get(jstate), {k: float(v) for k, v in
                                              jm.items()},
            train_state_to_flax(state, model), {k: float(v) for k, v in
                                                tm.items()})


def test_train_step_losses_match_tpudet(step_runs):
    _, _, jm, _, tm = step_runs
    for k in ('loss', 'loss_cls', 'loss_bbox', 'num_gts', 'grad_norm', 'lr',
              'momentum'):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    assert math.isfinite(jm['loss']) and jm['grad_norm'] > 0


@pytest.mark.parametrize('what', ['params', 'batch_stats', 'ema_params',
                                  'ema_batch_stats', 'momentum_buf'])
def test_train_step_state_matches_tpudet(step_runs, what):
    state0, jstate, _, tstate, _ = step_runs
    if what == 'momentum_buf':
        got, ref, init = (tstate.opt_state.momentum_buf,
                          jstate.opt_state.momentum_buf,
                          state0.opt_state.momentum_buf)
    else:
        got, ref, init = (getattr(tstate, what), getattr(jstate, what),
                          getattr(state0, what))
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    assert_tree_close(got, ref, init, what)


def test_param_labels_equal_tpudets():
    cfg = retina_cfg(num_classes=NUM_CLASSES)
    jmodel = jax_build_detector(cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))['params']
    ref = {}
    jax.tree_util.tree_map_with_path(
        lambda p, v: ref.__setitem__(tuple(k.key for k in p),
                                     param_group_label(p, v)), shapes)
    model = build_detector(cfg)
    labels = param_labels(model)
    got = {path[1:]: labels[key] for path, (key, _) in
           leaf_table(model).items() if path[0] == 'params'}
    assert got == ref
    assert {v for v in got.values()} == {'weight', 'weight_nodecay', 'bias'}


# the repairs of the YOLO slices

class _RecordingHead(torch.nn.Module):
    def get_bboxes(self, preds, **kwargs):
        return kwargs


def test_get_bboxes_forwards_soft_nms_keys_and_maps_nms_pre():
    test_cfg = dict(nms_pre=-1, min_bbox_size=0, score_thr=0.05,
                    max_per_img=100,
                    nms=dict(type='soft_nms', iou_threshold=0.3, sigma=0.7,
                             min_score=0.05, method='gaussian'))
    det = SingleStageDetector(torch.nn.Identity(), _RecordingHead(),
                              test_cfg=test_cfg)
    assert det.get_bboxes(None, max_per_img=7) == dict(
        nms_pre=0, score_thr=0.05, max_per_img=7, iou_thr=0.3,
        nms_type='soft_nms', sigma=0.7, min_score=0.05, method='gaussian')

    class Stripping(RetinaNet):  # as tpudet's CornerNet strips nms_pre
        strip_test_keys = ('score_thr',)

    got = Stripping(torch.nn.Identity(), _RecordingHead(),
                    test_cfg=dict(test_cfg, nms=dict(type='nms')))
    assert got.get_bboxes(None) == dict(nms_pre=0, max_per_img=100,
                                        iou_thr=0.5)


def test_random_flax_variables_draws_by_each_convs_initializer():
    model = build_detector(retina_cfg(num_classes=NUM_CLASSES))
    tree = random_flax_variables(model, seed=0)['params']
    for name, conv in tree['neck'].items():  # FPN: xavier_uniform, bias 0
        k = conv['kernel']
        kh, kw, cin, cout = k.shape
        limit = math.sqrt(6 / (kh * kw * (cin + cout)))
        assert np.abs(k).max() <= limit and np.abs(k).max() > 0.9 * limit
        assert not conv['bias'].any(), name
    head = tree['bbox_head']
    prior = -math.log((1 - 0.01) / 0.01)
    np.testing.assert_allclose(head['retina_cls']['bias'], prior, rtol=1e-6)
    for name in ('cls_conv0', 'reg_conv0', 'retina_reg', 'retina_cls'):
        assert 0.009 < head[name]['kernel'].std() < 0.011, name
        if name != 'retina_cls':
            assert not head[name]['bias'].any()
    k = tree['backbone']['stem_conv']['kernel']  # he_normal, truncated
    std = math.sqrt(2 / (7 * 7 * 3)) / .87962566103423978
    assert np.abs(k).max() <= 2 * std + 1e-6
    # the detector starts at tpudet's prior: class probabilities ~0.01
    load_flax_variables(model, random_flax_variables(model, seed=0))
    img = np.random.RandomState(16).rand(2, IMG, IMG, 3).astype(np.float32)
    with torch.no_grad():
        cls, _ = model.eval()(torch.from_numpy(img))
    p = float(torch.sigmoid(cls[0]).mean())
    assert 0.005 < p < 0.02


# the entry points take a RetinaNet config

SHAPES = 'configs/shapes/retinanet_r50_shapes_320.py'


def _tiny_shapes_config(d, root):
    """The shapes config narrowed (ResNet-18, 32 channels, one stacked
    conv) at 128 px, its sets on JPEGs in ``d``: the keep-ratio Resize,
    RandomFlip and Pad(32) pipelines, soft-NMS, SGD with the config's
    warm-up."""
    norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                to_rgb=True)
    train = [dict(type='LoadImageFromFile'),
             dict(type='LoadAnnotations', with_bbox=True),
             dict(type='Resize', img_scale=(128, 128), keep_ratio=True),
             dict(type='RandomFlip', flip_ratio=0.5),
             dict(type='Normalize', **norm), dict(type='Pad', size_divisor=32)]
    test = [dict(type='LoadImageFromFile'),
            dict(type='MultiScaleFlipAug', img_scale=(128, 128), flip=False,
                 transforms=[dict(type='Resize', keep_ratio=True),
                             dict(type='RandomFlip'),
                             dict(type='Pad', size_divisor=32),
                             dict(type='Normalize', **norm)])]
    sets = {k: dict(ann_file=str(d / 'ann.json'), img_prefix=str(d),
                    classes=CLASSES, pipeline=p)
            for k, p in (('train', train), ('val', test), ('test', test))}
    path = d / 'retina_tiny.py'
    path.write_text(f'''_base_ = {os.path.join(root, SHAPES)!r}
model = dict(backbone=dict(depth=18),
             neck=dict(in_channels=[64, 128, 256, 512], out_channels=32),
             bbox_head=dict(num_classes=3, in_channels=32, feat_channels=32,
                            stacked_convs=1))
data = dict(samples_per_gpu=2, train_img_size=128, max_gts=8,
            train={sets['train']!r},
            val=dict(test_mode=True, **{sets['val']!r}),
            test=dict(test_mode=True, **{sets['test']!r}))
nominal_batch_size = 2
runner = dict(max_epochs=1)
evaluation = dict(interval=1, metric='fast-bbox')
checkpoint_config = dict(interval=1)
log_config = dict(interval=1)
''')
    return str(path)


def test_train_detector_and_the_test_cli_take_a_retinanet_config(tmp_path):
    """``train_detector`` (the host pipeline through ``DetDataLoader``, 2
    steps, a checkpoint, the EMA evaluation) and the test CLI on its
    weights, equal to ``single_device_test`` + ``coco_fast_bbox_eval``."""
    from tpudet_torch.apis import single_device_test, train_detector
    from tpudet_torch.config import Config
    from tpudet_torch.data import build_dataset
    from tpudet_torch.evaluation import coco_fast_bbox_eval
    from tpudet_torch.tools import test as cli
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _write_set(tmp_path, NO_RESIZE[:4], 17)
    cfg_path = _tiny_shapes_config(tmp_path, root)
    cfg = Config.fromfile(cfg_path)
    assert cfg['model']['test_cfg']['nms']['type'] == 'soft_nms'
    work = str(tmp_path / 'work')
    metrics = train_detector(cfg, work, max_steps=2, device='cpu')
    assert {'loss', 'loss_cls', 'loss_bbox', 'grad_norm'} <= set(metrics)
    assert math.isfinite(metrics['loss'])
    assert sorted(os.listdir(os.path.join(work, 'ckpts'))) == ['2']
    weights = os.path.join(work, 'latest_ema.msgpack')
    report = cli.main([cfg_path, weights, '--img-size', '128', '--device',
                       'cpu'])
    det = init_detector(cfg, weights, device='cpu', dtype=torch.float32)
    ds = build_dataset({**cfg['data']['test'], 'test_mode': True},
                       dict(device='cpu'))
    ref = coco_fast_bbox_eval(
        single_device_test(det.model, ds, batch_size=8, img_size=128,
                           progress=False),
        [ds.get_ann_info_test(i) for i in range(len(ds))],
        classes=ds.CLASSES)
    assert list(report) == list(ref)
    np.testing.assert_allclose([report[k] for k in ref],
                               [ref[k] for k in ref], atol=1e-6)
