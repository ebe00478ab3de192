"""The ATSS assigner, the ATSS family's losses, ``ATSSHead`` and
``GFLHead`` in tpudet_torch against tpudet, on the CPU.

The detectors are tpudet's test configs (``tests/test_models/
test_atss.py`` and ``test_gfl.py``: ResNet-18, an FPN of 64 channels from
c3 with extra convs on the input, one stacked conv, 5 classes, GFL's
``reg_max`` 8), at 128 px, batches of 2; the float64 steps at 64 px.

Tolerances:

- ``atss_assign_batch``: the codes equal tpudet's ``atss_assign_batch``
  index for index: random gts on ATSS's and VFNet's grids, gts centred
  on cell corners (their centre distances tie, and the 9th candidate is
  picked among ties), a duplicated gt (an anchor's IoUs tie between gts),
  levels with fewer anchors than ``topk``, and an image without a gt;
- the four losses and their gradients: rtol 1e-5 (atol 1e-7 for the
  values, 1e-5 of the largest |gradient|); DFL at targets on bin edges
  and at ``reg_max`` (its indices clipped), KD with ``reduction='none'``;
- pred maps within 1e-4 of each map's largest |value| (fp32, eval mode);
- ``loss`` on tpudet's own pred maps: each term rtol 1e-5, its gradient
  with respect to the maps rtol 1e-5 (atol 1e-5 of the largest |value|),
  with gts in one image and none in the other;
- ``get_bboxes`` of tpudet's pred maps: the keeps equal (boxes atol 1e-3
  px, scores 1e-5), rescaled and clipped to per-image shapes or not, and
  the raw decode of ``with_nms=False`` (boxes 1e-3, scores 1e-5); end to
  end, each package on its own forward, one-to-one (label, IoU >= 0.99,
  scores within 1e-4: the forwards' maps differ by a few 1e-6 of their
  largest value, which on VFNet's random weights, with distances of
  thousands of px, moves corners by 0.02 px);
- one train step (SGD, EMA, BatchNorm in train mode) in float64 on both
  sides from tpudet's init, 2 images of 64 px: the losses and the
  gradient norm rtol 1e-4, the state within 5e-3 of the change the step
  made (``test_torch_train_step.py``'s ``assert_tree_close``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.core import anchors as janchors
from tpudet.core import assigners as jassign
from tpudet.models import losses as jlosses
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.train.optim import YoloSGDConfig as JaxSGDConfig
from tpudet.train.train_state import create_train_state as jax_create_state
from tpudet.train.train_state import make_train_step as jax_make_train_step
from tpudet_torch.apis import init_detector
from tpudet_torch.apis.train import forward_train_loss
from tpudet_torch.core import assigners as tassign
from tpudet_torch.models import losses as tlosses
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.detectors.single_stage import ATSS, GFL
from tpudet_torch.train.optim import YoloSGDConfig
from tpudet_torch.train.train_state import create_train_state, make_train_step
from tpudet_torch.utils.flax_import import (load_flax_variables,
                                            train_state_to_flax)

from .test_models.test_atss import atss_cfg
from .test_models.test_gfl import gfl_cfg
from .test_torch_backbone_neck import _max_rel, random_variables
from .test_torch_detector import _np
from .test_torch_retinanet import assert_one_to_one
from .test_torch_roi_head import assert_detections_equal
from .test_torch_train_step import assert_tree_close
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

IMG, NUM_CLASSES = 128, 5
TOL = 1e-4
STRIDES = [8, 16, 32, 64, 128]


# the assigner

def _grid(size, center_offset=None):
    """ATSS's anchors (one square of 8 strides a cell) over a ``size``
    square, or VFNet's (``center_offset`` 0: squares around the points at
    ``(x, y) * stride``), and the per-level counts."""
    sizes = [(-(-size // s),) * 2 for s in STRIDES]
    if center_offset is None:
        gen = janchors.AnchorGenerator(strides=STRIDES, ratios=[1.0],
                                       octave_base_scale=8,
                                       scales_per_octave=1)
        levels = gen.grid_anchors(sizes)
    else:
        levels = []
        for (h, w), s in zip(sizes, STRIDES):
            xs = np.tile(np.arange(w, dtype=np.float32), h) * s
            ys = np.repeat(np.arange(h, dtype=np.float32), w) * s
            levels.append(np.stack([xs - 4 * s, ys - 4 * s, xs + 4 * s,
                                    ys + 4 * s], -1))
    return np.concatenate(levels), [len(a) for a in levels]


def _assigner_case(case):
    """(anchors, counts, gts (B, G, 4), valid (B, G), topk)."""
    rng = np.random.RandomState({'random': 0, 'vfnet_grid': 1, 'ties': 2,
                                 'small_levels': 3}[case])
    size, b, g, topk = 128, 3, 8, 9
    if case == 'small_levels':
        size, topk = 40, 13  # levels of 25, 9, 4, 1 and 1 anchors
    anchors, counts = _grid(size, 0 if case == 'vfnet_grid' else None)
    wh = rng.uniform(6, 0.8 * size, (b, g, 2))
    if case == 'ties':
        # centres on cell corners (multiples of 8): equidistant from the 4
        # anchor centres around them on level 0, and from rings of them
        # further out; gt 1 repeats gt 0
        ctr = rng.randint(1, size // 8, (b, g, 2)) * 8.0
        ctr[:, 1], wh[:, 1] = ctr[:, 0], wh[:, 0]
    else:
        ctr = rng.uniform(wh / 2, size - wh / 2)
    gts = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    valid = rng.rand(b, g) < 0.8
    valid[:, :2] = True
    valid[2] = False  # an image without a gt
    return anchors, counts, gts, valid, topk


@pytest.mark.parametrize('case', ['random', 'vfnet_grid', 'ties',
                                  'small_levels'])
def test_atss_assigner_equals_tpudets(case):
    anchors, counts, gts, valid, topk = _assigner_case(case)
    ref = np.asarray(jassign.atss_assign_batch(
        jnp.asarray(anchors), counts, jnp.asarray(gts), jnp.asarray(valid),
        topk))
    got = tassign.atss_assign_batch(
        torch.from_numpy(anchors), counts, torch.from_numpy(gts),
        torch.from_numpy(valid), topk)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[:2] >= 0).sum() > 10 and (ref[2] == -1).all()
    one = tassign.atss_assign(torch.from_numpy(anchors), counts,
                              torch.from_numpy(gts[0]),
                              torch.from_numpy(valid[0]), topk)
    np.testing.assert_array_equal(one.numpy(), ref[0])
    if case == 'ties':
        # the duplicated gt never wins: its twin comes first
        assert not (ref == 1).any() and (ref == 0).any()


# the losses

def _loss_args(name, rng):
    n, c, bins = 60, 5, 9
    if name == 'varifocal_loss':
        pred = (rng.randn(2, n, c) * 3).astype(np.float32)
        target = np.where(rng.rand(2, n, c) < 0.2,
                          rng.uniform(0.05, 1, (2, n, c)), 0.).astype(
                              np.float32)
        args = [pred, target]
    elif name == 'quality_focal_loss':
        pred = (rng.randn(2, n, c) * 3).astype(np.float32)
        args = [pred, rng.randint(0, c + 1, (2, n)).astype(np.int32),
                rng.uniform(0, 1, (2, n)).astype(np.float32)]
    elif name == 'distribution_focal_loss':
        target = rng.uniform(0, bins - 1, (2, n, 4)).astype(np.float32)
        target[0, :8] = np.arange(8, dtype=np.float32)[:, None]  # bin edges
        target[1, :3] = bins - 1  # reg_max: the right bin is clipped
        args = [(rng.randn(2, n, 4, bins) * 2).astype(np.float32), target]
    else:  # kd_kl_div_loss
        args = [(rng.randn(2, n, 4, bins) * 3).astype(np.float32),
                (rng.randn(2, n, 4, bins) * 3).astype(np.float32)]
    return args


LOSS_CASES = {
    'varifocal': ('varifocal_loss', {}),
    'varifocal_unweighted_iou': ('varifocal_loss',
                                 dict(iou_weighted=False, alpha=0.5,
                                      gamma=1.5, loss_weight=2.0)),
    'quality_focal': ('quality_focal_loss', {}),
    'quality_focal_beta': ('quality_focal_loss', dict(beta=1.5)),
    'distribution_focal': ('distribution_focal_loss', {}),
    'distribution_focal_none': ('distribution_focal_loss',
                                dict(reduction='none', loss_weight=0.25)),
    'kd_kl_div': ('kd_kl_div_loss', {}),
    'kd_kl_div_none': ('kd_kl_div_loss', dict(reduction='none', T=2.0)),
}


@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('case', list(LOSS_CASES))
def test_loss_and_gradient_match_tpudet(case, weighted):
    """Each loss on its own: values (the reduced value, or every element
    with ``reduction='none'``) and gradients, weighted by a (2, N, 1) mask
    over an ``avg_factor`` of 17 or not."""
    name, kwargs = LOSS_CASES[case]
    rng = np.random.RandomState(5)
    args = _loss_args(name, rng)
    jkw, tkw = dict(kwargs), dict(kwargs)
    if weighted:
        weight = (rng.rand(2, args[0].shape[1], 1) < 0.7).astype(np.float32)
        jkw.update(weight=jnp.asarray(weight), avg_factor=17.0)
        tkw.update(weight=torch.from_numpy(weight), avg_factor=17.0)
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)

    def jloss(p):
        out = jfn(p, *(jnp.asarray(a) for a in args[1:]), **jkw)
        return jnp.sum(out), out

    (_, ref), ref_grad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(args[0]))
    tp = torch.from_numpy(args[0]).requires_grad_()
    got = tfn(tp, *(torch.from_numpy(a) for a in args[1:]), **tkw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-7)
    r = np.asarray(ref_grad)
    assert np.abs(r).max() > 0
    np.testing.assert_allclose(tp.grad.numpy(), r, rtol=1e-5,
                               atol=1e-5 * np.abs(r).max())


def test_kd_loss_detaches_its_target_as_tpudets():
    """``detach_target=False`` lets the gradient reach the soft labels."""
    rng = np.random.RandomState(6)
    pred, soft = (rng.randn(2, 7, 9).astype(np.float32) for _ in range(2))
    for detach in (True, False):
        ref = np.asarray(jax.grad(lambda s: jlosses.kd_kl_div_loss(
            jnp.asarray(pred), s, detach_target=detach))(jnp.asarray(soft)))
        tp = torch.from_numpy(pred).requires_grad_()
        ts = torch.from_numpy(soft).requires_grad_()
        tlosses.kd_kl_div_loss(tp, ts, detach_target=detach).backward()
        if detach:
            assert ts.grad is None and not ref.any()
        else:
            assert np.abs(ref).max() > 0
            np.testing.assert_allclose(ts.grad.numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max())


# the detectors

# the shipped configs' test_cfg (tpudet's test configs cap at 20
# detections, where a near-tie at the cap flips between the two packages'
# own forwards)
TEST_CFG = dict(nms_pre=1000, score_thr=0.05,
                nms=dict(type='nms', iou_threshold=0.6), max_per_img=100)


def shipped_test_cfg(cfg):
    return dict(cfg, test_cfg=TEST_CFG)


CFGS = {'atss': lambda: shipped_test_cfg(atss_cfg(NUM_CLASSES)),
        'gfl': lambda: shipped_test_cfg(gfl_cfg(NUM_CLASSES))}
LOSS_KEYS = {'atss': ('loss_cls', 'loss_bbox', 'loss_centerness'),
             'gfl': ('loss_cls', 'loss_bbox', 'loss_dfl')}


def head_variables(jmodel, img, seed):
    """Random weights (``random_variables``) with the heads' ``scales``
    leaves drawn in [0.5, 1.5], as a trained model's sit near 1."""
    variables = random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros(img.shape)), seed)
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.RandomState(seed + 1)
    for k, v in variables['params']['bbox_head'].items():
        if k.startswith('scales'):
            variables['params']['bbox_head'][k] = rng.uniform(
                0.5, 1.5, v.shape).astype(np.float32)
    return variables


def images(seed, b=2, size=IMG):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, size, size, 3)).astype(np.float32)


def gts(seed, b=2, g=6, size=IMG, num_classes=NUM_CLASSES):
    """gts in image 0 only, sides 10-90 % of the image."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    wh = rng.uniform(0.1, 0.9, (g, 2)) * size
    xy = rng.uniform(0, 1, (g, 2)) * (size - wh)
    boxes[0] = np.concatenate([xy, xy + wh], -1)
    valid[0] = True
    labels = rng.randint(0, num_classes, (b, g)).astype(np.int32)
    return boxes, labels, valid


def detector_pair(cfg, seed, apply=None):
    """(tpudet's module, the variables, the port's ``Detector``, images,
    tpudet's pred maps (``apply(jmodel, variables, img)`` or its jitted
    ``apply``), the port's)."""
    jmodel = jax_build_detector(cfg)
    img = images(seed)
    variables = head_variables(jmodel, img, seed)
    det = init_detector(cfg, variables=variables, device='cpu',
                        dtype=torch.float32)
    ref = (apply(jmodel, variables, img) if apply else
           jax.jit(jmodel.apply)(variables, jnp.asarray(img)))
    return jmodel, variables, det, img, ref, det.forward(img)


@pytest.fixture(scope='module', params=list(CFGS))
def pair(request):
    return (request.param,) + detector_pair(CFGS[request.param](), 20)


def assert_maps_close(got, ref, tol=TOL):
    for g_lvls, r_lvls in zip(got, ref):
        assert len(g_lvls) == 5
        for g, r in zip(g_lvls, r_lvls):
            r = np.asarray(r)
            assert tuple(g.shape) == r.shape
            assert _max_rel(g.detach().numpy(), r) <= tol


def test_pred_maps_match_tpudet(pair):
    kind, _, _, det, _, ref, got = pair
    assert type(det.model) is {'atss': ATSS, 'gfl': GFL}[kind]
    assert [tuple(c.shape[1:3]) for c in got[0]] == [(16, 16), (8, 8),
                                                     (4, 4), (2, 2), (1, 1)]
    assert got[1][0].shape[-1] == {'atss': 4, 'gfl': 4 * 9}[kind]
    assert all(r.dtype == torch.float32 for r in got[1])
    assert_maps_close(got, ref)


def assert_loss_and_map_gradients(jmodel, model, ref, boxes, labels, valid,
                                  keys):
    """``loss`` of both packages on tpudet's pred maps ``ref``: each term
    rtol 1e-5 and the gradients of the sum of ``keys`` with respect to the
    maps rtol 1e-5, atol 1e-5 of each map's largest |value|. Returns the
    port's loss dict."""
    def jax_total(preds):
        out = jmodel.loss(preds, jnp.asarray(boxes), jnp.asarray(labels),
                          jnp.asarray(valid))
        return sum(out[k] for k in keys), out

    (_, jl), jg = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        jax.tree.map(jnp.asarray, ref))
    tpreds = tuple(tuple(torch.tensor(np.asarray(r)).requires_grad_()
                         for r in lvls) for lvls in ref)
    tl = model.loss(tpreds, *(torch.from_numpy(a)
                              for a in (boxes, labels, valid)))
    assert set(tl) == set(jl)
    sum(tl[k] for k in keys).backward()
    for k in tl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-5, err_msg=k)
    for t_lvls, r_lvls in zip(tpreds, jg):
        for t, r in zip(t_lvls, r_lvls):
            r = np.asarray(r)
            # a map the summed terms do not reach: jax's zeros, torch's None
            g = np.zeros_like(r) if t.grad is None else t.grad.numpy()
            np.testing.assert_allclose(g, r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max())
    return {k: v.detach() for k, v in tl.items()}


def test_loss_and_gradients_match_tpudet(pair):
    kind, jmodel, _, det, _, ref, _ = pair
    tl = assert_loss_and_map_gradients(jmodel, det.model, ref, *gts(21),
                                       LOSS_KEYS[kind])
    assert all(float(tl[k]) > 0 for k in LOSS_KEYS[kind])


def test_loss_without_gts_matches_tpudet(pair):
    kind, jmodel, _, det, _, ref, _ = pair
    boxes, labels, valid = gts(22)
    valid[:] = False
    tl = assert_loss_and_map_gradients(jmodel, det.model, ref, boxes, labels,
                                       valid, LOSS_KEYS[kind][:1])
    assert float(tl['loss_bbox']) == 0.0


def rescale_kwargs(b=2):
    sf = np.array([[2., 2., 2., 2.], [1.5, 1.25, 1.5, 1.25]], np.float32)
    hw = np.array([[IMG, IMG], [100, 90]], np.float32)
    return (dict(scale_factors=jnp.asarray(sf),
                 img_shape=(jnp.asarray(hw[:, :1]), jnp.asarray(hw[:, 1:]))),
            dict(scale_factors=torch.from_numpy(sf),
                 img_shape=(torch.from_numpy(hw[:, :1]),
                            torch.from_numpy(hw[:, 1:]))))


def assert_get_bboxes_match(jmodel, model, ref, got, rescale):
    """``get_bboxes`` of tpudet's maps in both packages: the keeps equal;
    end to end one-to-one; the raw decode equal."""
    jkw, tkw = rescale_kwargs() if rescale else ({}, {})
    rj = jax.jit(lambda maps, kw: jmodel.get_bboxes(maps, **kw))(ref, jkw)
    tref = tuple(tuple(torch.tensor(np.asarray(a)) for a in lvls)
                 for lvls in ref)
    rt = model.get_bboxes(tref, **tkw)
    assert int(rt.valid.sum(1).min()) >= 10
    assert_detections_equal(rt, rj)
    assert_one_to_one(_np(rj), _np(model.get_bboxes(got, **tkw)))
    raw_j = jmodel.bbox_head.get_bboxes(ref, with_nms=False, **jkw)
    raw_t = model.bbox_head.get_bboxes(tref, with_nms=False, **tkw)
    for g, r in zip(raw_t, raw_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-3)
    assert raw_t[1].shape[-1] == NUM_CLASSES  # no background column


@pytest.mark.parametrize('rescale', [False, True])
def test_get_bboxes_matches_tpudet(pair, rescale):
    _, jmodel, _, det, _, ref, got = pair
    assert_get_bboxes_match(jmodel, det.model, ref, got, rescale)


OPT = dict(lr=0.01, momentum=0.9, weight_decay=5e-4, nesterov=False,
           total_steps=50, warmup_iters=3, steps_per_epoch=0,
           grad_clip_norm=10.0, lr_weight_warmup_ratio=1.0,
           lr_bias_warmup_ratio=1.0, momentum_warmup_ratio=1.0)
STEP_IMG = 64
EMA = dict(ema_momentum_base=0.9999, ema_warm_up=4, ema_interval=1)


def step_batch(seed, b=2, num_classes=NUM_CLASSES):
    """Float64 images of STEP_IMG px, gts in both images (4 and 2)."""
    boxes, labels, valid = gts(seed, b=b, g=4, size=STEP_IMG,
                               num_classes=num_classes)
    boxes[1], valid[1, 2:] = boxes[0][::-1], False
    valid[1, :2] = True
    return dict(img=images(seed, b, STEP_IMG).astype(np.float64),
                gt_bboxes=boxes, gt_labels=labels, gt_valid=valid)


def jax_forward_train_loss(jmodel):
    """tpudet's ``forward_train`` loss of ``train_detector``
    (``tpudet/apis/train.py:168-194``) for its ``make_train_step``."""
    def loss_fn(params, batch_stats, batch):
        losses, mutated = jmodel.apply(
            {'params': params, 'batch_stats': batch_stats}, batch['img'],
            batch['gt_bboxes'], batch['gt_labels'], batch['gt_valid'],
            method='forward_train', mutable=['batch_stats'])
        total = sum(v for k, v in losses.items() if 'loss' in k)
        return total, (losses, mutated['batch_stats'])
    return loss_fn


def float64_step(cfg, batch, forward_train=False):
    """One step of tpudet's ``make_train_step`` (x64) and the port's on
    the float64 model, from tpudet's init (through ``forward_train``, and
    the step's loss through it, with ``forward_train``). Returns
    (tpudet's state before, after, metrics, the port's state as tpudet's
    leaves, metrics, the port's model)."""
    jmodel = jax_build_detector(cfg)
    jopt = JaxSGDConfig(**OPT)
    state0 = jax.device_get(jax.jit(
        lambda key, x: jax_create_state(jmodel, key, x, jopt))(
            jax.random.PRNGKey(0), jnp.zeros((1, STEP_IMG, STEP_IMG, 3))))
    state0 = jax.tree.map(lambda a: np.asarray(a, np.float64)
                          if a.dtype == np.float32 else a, state0)
    with jax.enable_x64(True):
        jstate, jm = jax.jit(jax_make_train_step(
            jmodel, jopt, loss_fn=forward_train and jax_forward_train_loss(
                jmodel), **EMA))(state0, jax.tree.map(jnp.asarray, batch))
        jstate, jm = jax.device_get((jstate, jm))
    model = build_detector(cfg)
    load_flax_variables(model, {'params': state0.params,
                                'batch_stats': state0.batch_stats})
    model.double()
    model.dtype = torch.float64
    opt = YoloSGDConfig(**OPT)
    state, tm = make_train_step(
        model, opt, loss_fn=forward_train and forward_train_loss(model),
        **EMA)(create_train_state(model, opt),
               {k: torch.from_numpy(v) for k, v in batch.items()})
    return (state0, jstate, {k: float(v) for k, v in jm.items()},
            train_state_to_flax(state, model),
            {k: float(v) for k, v in tm.items()}, model)


def assert_step_matches(state0, jstate, jm, tstate, tm, keys):
    for k in ('loss', 'num_gts', 'grad_norm', 'lr', 'momentum') + keys:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    assert math.isfinite(jm['loss']) and jm['grad_norm'] > 0
    for what in ('params', 'batch_stats', 'ema_params'):
        assert jax.tree.structure(getattr(tstate, what)) == \
            jax.tree.structure(getattr(jstate, what))
        assert_tree_close(getattr(tstate, what), getattr(jstate, what),
                          getattr(state0, what), what)
    assert_tree_close(tstate.opt_state.momentum_buf,
                      jstate.opt_state.momentum_buf,
                      state0.opt_state.momentum_buf, 'momentum_buf')


@pytest.mark.parametrize('kind', list(CFGS))
def test_a_train_step_matches_tpudet_in_float64(kind):
    state0, jstate, jm, tstate, tm, _ = float64_step(CFGS[kind](),
                                                     step_batch(23))
    assert_step_matches(state0, jstate, jm, tstate, tm, LOSS_KEYS[kind])
    # the level scales learn
    assert not np.array_equal(tstate.params['bbox_head']['scales'],
                              state0.params['bbox_head']['scales'])
