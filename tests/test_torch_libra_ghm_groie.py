"""ROADMAP.md's zoo row h in tpudet_torch against tpudet, on the CPU:
Libra R-CNN's balanced L1, BFP and IoU-balanced negatives, GHM's two
losses, GRoIE's generic RoI extractor, and a float64 train step of each
of the four detectors (Libra Faster R-CNN, Libra RetinaNet, GRoIE Faster
R-CNN, GHM RetinaNet) narrowed to ResNet-18.

Tolerances:

- the losses and their gradients (fp32): rtol 1e-6 (atol 1e-7 for the
  values, 1e-6 of the largest |gradient|); GHM-C at gradient norms that
  lie exactly on tpudet's fp32 bin edges (``jnp.linspace`` rounds them
  apart from ``torch.linspace``: a wrong edge moves an element to another
  bin and its weight) of [0.5, 1], at 0 and at 1 (the last bin's
  ``+1e-6``), with 10 and 30 bins and label weights that drop some
  elements;
- ``unit_edges`` equals ``jnp.linspace(0, 1, bins + 1)`` bit for bit;
- BFP (no refine, ``conv`` and ``non_local`` at refine levels 1 and 2,
  ``conv_out`` redrawn N(0, 0.1^2): at tpudet's zero init the block is
  the identity and its softmax untested, which the test checks):
  outputs within 1e-5 of each
  level's largest |value|, the input gradients within 1e-5 of their
  largest; sizes that are not integer ratios raise in both;
- the IoU-balanced sampler: ``sample_rois`` equal index for index (rois,
  ``sampled``, labels, ``pos``, ``is_gt``; targets atol 1e-6) at 512, 64
  and 16 samples (the per-bin share, the shortfall fill and the trim);
- the RoI head's balanced-L1 loss and its gradients: rtol 1e-5;
- ``generic_roi_align`` (sum and concat) and the generic extractor under
  ``StandardRoIHead`` (pooling and the bbox head): within 1e-5 of the
  largest |value| (the sum of four levels' fp32 pools);
- one train step in float64 on both sides from tpudet's init (the
  two-stage ones with ``linear_heads``, Libra's ``conv_out`` redrawn):
  losses and the gradient norm rtol 1e-4, the state within 5e-3 of the
  change the step made.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models import losses as jlosses
from tpudet.models.necks.hrfpn import BFP as JaxBFP
from tpudet.ops import roi_align as jroi
from tpudet_torch.models import losses as tlosses
from tpudet_torch.models.necks import BFP
from tpudet_torch.models.roi_heads import StandardRoIHead
from tpudet_torch.ops import roi_align as troi
from tpudet_torch.utils.flax_import import load_flax_variables

from .test_torch_atss_gfl import (assert_step_matches, float64_step,
                                  shipped_test_cfg, step_batch)
from .test_torch_cascade_rcnn import _batch as step_batch_64
from .test_torch_cascade_rcnn import linear_heads
from .test_torch_faster_rcnn import NUM_CLASSES, frcnn_cfg
from .test_torch_faster_rcnn_train import two_stage_step_runs
from .test_torch_roi_head import CH, _feats, _t, roi_pair  # noqa: F401
from .test_torch_rpn_head import gts
from .test_torch_train_step import assert_tree_close
from . import torch_fixtures  # noqa: F401  (one intra-op thread)


def _grads(jfn, tfn, *arrays):
    """Value and gradients (w.r.t. every array) of a scalar loss, in both
    packages."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = tfn(*ts)
    tv.backward()
    return float(jv), [np.asarray(g) for g in jg], float(tv.detach()), \
        [t.grad.numpy() for t in ts]


def _assert_loss_pair(jfn, tfn, *arrays, rtol=1e-6):
    jv, jg, tv, tg = _grads(jfn, tfn, *arrays)
    np.testing.assert_allclose(tv, jv, rtol=rtol, atol=1e-7)
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t, j, rtol=rtol,
                                   atol=rtol * np.abs(j).max())
    return jv


# the losses

@pytest.mark.parametrize('weighted', [False, True])
def test_balanced_l1_loss_and_gradient_match_tpudet(weighted):
    rng = np.random.RandomState(0)
    pred = rng.randn(64, 4).astype(np.float32)
    target = (pred + rng.randn(64, 4) * 1.2).astype(np.float32)
    target[0] = pred[0] + 1.0  # |d| exactly beta
    w = (rng.rand(64, 1) < 0.5).astype(np.float32) if weighted else None
    kw = dict(weight=None if w is None else w,
              avg_factor=7.0 if weighted else None)
    jkw = dict(kw, weight=None if w is None else jnp.asarray(w))
    value = _assert_loss_pair(
        lambda p, t: jlosses.balanced_l1_loss(p, t, **jkw),
        lambda p, t: tlosses.balanced_l1_loss(
            p, t, **dict(kw, weight=None if w is None else torch.tensor(w))),
        pred, target)
    assert value > 0


def _on_edges(bins):
    """Gradient norms ``|sigmoid(20) - t| = |1 - t|`` exactly on tpudet's
    fp32 edges of [0.5, 1] (``sigmoid(20)`` rounds to 1; 1 - e is exact
    there, so is 1 - t), and 0 (``sigmoid(-200)`` is 0); then random
    ones. No logit is 0, where the two packages take other subgradients
    of ``|x|``."""
    edges = np.asarray(jnp.linspace(0, 1, bins + 1))
    on = edges[edges >= 0.5]
    pred = np.concatenate([np.full(len(on), 20.0), [-200.0]]).astype(
        np.float32)
    target = np.concatenate([np.float32(1) - on, [0.0]]).astype(np.float32)
    g = (torch.sigmoid(torch.tensor(pred)) - torch.tensor(target)).abs()
    np.testing.assert_array_equal(g.numpy(), np.append(on, 0.0))
    rng = np.random.RandomState(bins)
    pred = np.concatenate([pred, rng.randn(300) * 3]).astype(np.float32)
    target = np.concatenate([target, rng.rand(300) < 0.1]).astype(np.float32)
    return pred.reshape(-1, 1), target.reshape(-1, 1)


@pytest.mark.parametrize('bins', [10, 30])
def test_ghm_c_loss_and_gradient_match_tpudet_on_bin_edges(bins):
    pred, target = _on_edges(bins)
    lw = np.ones_like(pred)
    lw[::7] = 0.0
    for w in (None, lw):
        value = _assert_loss_pair(
            lambda p, t: jlosses.ghm_c_loss(
                p, t, bins=bins, label_weight=None if w is None else
                jnp.asarray(w)),
            lambda p, t: tlosses.ghm_c_loss(
                p, t, bins=bins, label_weight=None if w is None else
                torch.tensor(w)),
            pred, target)
        assert value > 0


@pytest.mark.parametrize('bins', [3, 10, 30, 100])
def test_unit_edges_equal_jnp_linspace(bins):
    edges = tlosses.unit_edges(bins, torch.float32)
    np.testing.assert_array_equal(edges.numpy(),
                                  np.asarray(jnp.linspace(0, 1, bins + 1)))
    if bins == 30:  # where torch.linspace would put other edges
        assert not torch.equal(edges, torch.linspace(0, 1, bins + 1))


def test_ghm_r_loss_and_gradient_match_tpudet():
    rng = np.random.RandomState(3)
    pred = (rng.randn(200, 4) * 0.1).astype(np.float32)
    target = (pred + rng.randn(200, 4) * np.array([0.001, 0.01, 0.1, 1.0])
              ).astype(np.float32)
    lw = np.broadcast_to((rng.rand(200, 1) < 0.3), (200, 4)).astype(
        np.float32)
    value = _assert_loss_pair(
        lambda p, t: jlosses.ghm_r_loss(p, t, label_weight=jnp.asarray(lw),
                                        mu=0.02, bins=10, loss_weight=10.0),
        lambda p, t: tlosses.ghm_r_loss(p, t, label_weight=torch.tensor(lw),
                                        mu=0.02, bins=10, loss_weight=10.0),
        pred, target)
    assert value > 0


# BFP

LEVELS = (32, 16, 8, 4, 2)
BFP_CH = 16


def _levels(seed, sizes=LEVELS):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, s, s, BFP_CH).astype(np.float32) for s in sizes]


def _bfp_pair(refine_type, refine_level, seed=0):
    kw = dict(in_channels=BFP_CH, num_levels=5, refine_level=refine_level,
              refine_type=refine_type)
    jmod = JaxBFP(**kw)
    x = _levels(seed)
    variables = jax.tree.map(np.array, jmod.init(
        jax.random.PRNGKey(0), tuple(jnp.asarray(a) for a in x)))
    if refine_type == 'non_local':
        out = variables['params']['refine']['conv_out']
        assert not out['kernel'].any()  # tpudet's init: the identity
        rng = np.random.RandomState(seed + 1)
        out['kernel'] = (rng.randn(*out['kernel'].shape) * 0.1).astype(
            np.float32)
        out['bias'] = (rng.randn(*out['bias'].shape) * 0.1).astype(np.float32)
    tmod = BFP(**kw)
    load_flax_variables(tmod, variables)
    return jmod, variables, tmod, x


@pytest.mark.parametrize('refine_type,refine_level', [
    (None, 2), ('conv', 2), ('non_local', 2), ('non_local', 1)])
def test_bfp_matches_tpudet(refine_type, refine_level):
    jmod, variables, tmod, x = _bfp_pair(refine_type, refine_level)
    rng = np.random.RandomState(9)
    cot = [rng.randn(*a.shape).astype(np.float32) for a in x]

    def jtotal(*xs):
        return sum(jnp.sum(o * c) for o, c in zip(jmod.apply(variables, xs),
                                                  cot))
    ref = jmod.apply(variables, tuple(jnp.asarray(a) for a in x))
    jg = jax.grad(jtotal, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in x))
    tx = [torch.tensor(a).permute(0, 3, 1, 2).requires_grad_() for a in x]
    got = tmod(tx)
    sum((o.permute(0, 2, 3, 1) * torch.tensor(c)).sum()
        for o, c in zip(got, cot)).backward()
    for o, r, t, g in zip(got, ref, tx, jg):
        r, g = np.asarray(r), np.asarray(g)
        o = o.detach().permute(0, 2, 3, 1).numpy()
        assert np.abs(o - r).max() <= 1e-5 * np.abs(r).max()
        tg = t.grad.permute(0, 2, 3, 1).numpy()
        assert np.abs(tg - g).max() <= 1e-5 * np.abs(g).max()
    if refine_type == 'non_local':  # the redrawn block is no identity
        plain = JaxBFP(in_channels=BFP_CH, num_levels=5,
                       refine_level=refine_level).apply(
            {}, tuple(jnp.asarray(a) for a in x))
        assert np.abs(np.asarray(plain[0]) - np.asarray(ref[0])).max() > \
            1e-3 * np.abs(np.asarray(ref[0])).max()


def test_bfp_refuses_sizes_that_are_not_integer_ratios():
    x = _levels(1, (32, 16, 8, 4, 3))
    jmod = JaxBFP(in_channels=BFP_CH, num_levels=5, refine_level=2)
    with pytest.raises(AssertionError):
        jmod.apply({}, tuple(jnp.asarray(a) for a in x))
    with pytest.raises(ValueError, match='integer ratio'):
        BFP(in_channels=BFP_CH, num_levels=5, refine_level=2)(
            [torch.tensor(a).permute(0, 3, 1, 2) for a in x])


# the IoU-balanced sampler and the balanced L1 of the RoI head

@pytest.mark.parametrize('num_samples', [None, 64, 16])
def test_iou_balanced_sampling_equals_tpudets(roi_pair, num_samples):
    jhead, variables, _, _, props, valid, _, _ = roi_pair
    jhead = jhead.clone(neg_sampling='iou_balanced')
    head = StandardRoIHead(num_classes=NUM_CLASSES, in_channels=CH,
                           neg_sampling='iou_balanced')
    props, valid = props[:, :300], valid[:, :300]
    boxes, labels, gt_valid = gts(3)
    args = (props, valid, boxes, labels, gt_valid)
    ref = jhead.apply(variables, *(jnp.asarray(a) for a in args),
                      num_samples=num_samples, return_is_gt=True,
                      method='sample_rois')
    got = head.sample_rois(*(_t(a) for a in args), num_samples=num_samples,
                           return_is_gt=True)
    names = ('rois', 'sampled', 'labels', 'targets', 'pos', 'is_gt')
    for name, g, r in zip(names, got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape, name
        if name == 'targets':
            np.testing.assert_allclose(g.numpy(), r, atol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    if num_samples is not None:  # a cap binds: not the random sampler's
        plain = StandardRoIHead(num_classes=NUM_CLASSES, in_channels=CH
                                ).sample_rois(*(_t(a) for a in args),
                                              num_samples=num_samples)
        assert not torch.equal(plain[0], got[0])


def test_balanced_l1_roi_loss_and_gradients_match_tpudet(roi_pair):
    jhead, variables, _, _, props, valid, _, _ = roi_pair
    boxes, labels, gt_valid = gts(3)
    jhead = jhead.clone(loss_bbox_type='balanced_l1')
    head = StandardRoIHead(num_classes=NUM_CLASSES, in_channels=CH,
                           loss_bbox_type='balanced_l1')
    rois, sampled, lab, targets, pos = jhead.apply(
        variables, jnp.asarray(props), jnp.asarray(valid),
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(gt_valid),
        num_samples=800, method='sample_rois')
    rng = np.random.RandomState(5)
    cls = rng.randn(2, 800, NUM_CLASSES + 1).astype(np.float32)
    deltas = rng.randn(2, 800, 4 * NUM_CLASSES).astype(np.float32)

    def jtotal(c, d):
        out = jhead.apply(variables, c, d, lab, targets, pos, sampled,
                          method='loss')
        return out['loss_cls'] + out['loss_bbox']

    def ttotal(c, d):
        out = head.loss(c, d, _t(lab).long(), _t(targets), _t(pos),
                        _t(sampled))
        return out['loss_cls'] + out['loss_bbox']
    _assert_loss_pair(jtotal, ttotal, cls, deltas, rtol=1e-5)


# GRoIE's generic extractor

@pytest.mark.parametrize('aggregation', ['sum', 'concat'])
def test_generic_roi_align_matches_tpudet(aggregation):
    feats = _feats(11, b=1)
    rng = np.random.RandomState(12)
    xy = rng.uniform(-8, 120, (60, 2))
    wh = rng.uniform(1, 100, (60, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.rand(60) > 0.2
    ref = jroi.generic_roi_align([jnp.asarray(f[0]) for f in feats],
                                 jnp.asarray(rois), jnp.asarray(valid),
                                 aggregation=aggregation)
    got = troi.generic_roi_align([_t(f[0]) for f in feats], _t(rois),
                                 _t(valid), aggregation=aggregation)
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())
    assert not got[~_t(valid)].any()


def test_generic_extractor_and_head_match_tpudet(roi_pair):
    jhead, variables, _, feats, props, valid, _, _ = roi_pair
    jhead = jhead.clone(roi_extractor='generic')
    head = StandardRoIHead(num_classes=NUM_CLASSES, in_channels=CH,
                           roi_extractor='generic')
    load_flax_variables(head, variables)
    args = (tuple(jnp.asarray(f) for f in feats), jnp.asarray(props),
            jnp.asarray(valid))
    tfeats = [_t(f).permute(0, 3, 1, 2) for f in feats]
    pooled = jhead.apply(variables, *args, method='extract')
    with torch.no_grad():
        got = head.extract(tfeats, _t(props), _t(valid))
        out = head(tfeats, _t(props), _t(valid))
    for g, r in [(got, pooled)] + list(zip(out, jhead.apply(variables,
                                                            *args))):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=1e-5 * np.abs(r).max())


def test_an_option_without_a_branch_raises():
    with pytest.raises(ValueError, match='roi_extractor'):
        StandardRoIHead(num_classes=3, roi_extractor='concat')


# a float64 step of each detector

def _libra_neck(neck, refine_level):
    return [neck, dict(type='BFP', in_channels=neck['out_channels'],
                       num_levels=5, refine_level=refine_level,
                       refine_type='non_local')]


def two_stage_cfg(kind):
    cfg = frcnn_cfg(num_samples=16)
    if kind == 'libra_frcnn':
        cfg['neck'] = _libra_neck(cfg['neck'], 2)
        cfg['roi_head'] = dict(cfg['roi_head'], neg_sampling='iou_balanced',
                               loss_bbox_type='balanced_l1')
    else:
        cfg['roi_head'] = dict(cfg['roi_head'], roi_extractor='generic')
    return cfg


def _redraw_conv_out(params):
    """``linear_heads``, and the BFP's ``conv_out`` (zero at tpudet's
    init) drawn N(0, 0.01^2)."""
    params = linear_heads(params)
    if 'necks_1' in params['neck']:
        out = params['neck']['necks_1']['refine']['conv_out']
        out['kernel'] = np.random.RandomState(2).randn(
            *out['kernel'].shape) * 0.01
    return params


@pytest.mark.parametrize('kind', ['libra_frcnn', 'groie'])
def test_a_two_stage_train_step_matches_tpudet_in_float64(kind):
    init, state0, jstate, jm, tstate, tm = two_stage_step_runs(
        two_stage_cfg(kind), 1, adjust=_redraw_conv_out,
        batch_fn=lambda step: step_batch_64(20 + step))
    assert_tree_close(init.params, state0.params, state0.params, 'init')
    keys = {'loss', 'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox',
            'num_gts', 'grad_norm', 'lr', 'momentum'}
    for k in keys:
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=1e-4, err_msg=k)
    assert jm[0]['loss_bbox'] > 0
    for what in ('params', 'batch_stats', 'ema_params'):
        assert_tree_close(getattr(tstate, what), getattr(jstate, what),
                          getattr(state0, what), what)


def retina_cfg(kind):
    cfg = dict(
        type='RetinaNet',
        backbone=dict(type='ResNet', depth=18, out_indices=[0, 1, 2, 3]),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, start_level=1, add_extra_convs='on_input',
                  num_outs=5),
        bbox_head=dict(type='RetinaHead', num_classes=5, in_channels=32,
                       feat_channels=32, stacked_convs=1))
    if kind == 'libra_retina':
        cfg['neck'] = _libra_neck(cfg['neck'], 1)
    else:
        cfg['bbox_head']['use_ghm'] = True
    return shipped_test_cfg(cfg)


@pytest.mark.parametrize('kind', ['libra_retina', 'ghm'])
def test_a_retinanet_train_step_matches_tpudet_in_float64(kind):
    state0, jstate, jm, tstate, tm, _ = float64_step(retina_cfg(kind),
                                                     step_batch(23))
    assert_step_matches(state0, jstate, jm, tstate, tm,
                        ('loss_cls', 'loss_bbox'))
    assert jm['loss_bbox'] > 0
