"""FCOS, FoveaBox and AutoAssign in tpudet_torch against tpudet, on the
CPU, with the helpers the zoo row j tests share (``test_torch_nasfcos.py``,
``test_torch_fsaf_free_anchor.py``, ``test_torch_yolof_nas_fpn.py``).

The detectors are tpudet's test configs (``tests/test_models/
test_{fcos,fovea,autoassign}.py``: ResNet-18, a 64- or 32-channel FPN,
one stacked conv) with the shipped test configs' caps (``max_per_img``
100), at 128 px, batches of 2; the float64 steps at 64 px. Random weights
(``random_variables`` of the leaves' shapes, which the port's model gives
without tracing tpudet's ``init``: every leaf drawn), the level scales
redrawn in [0.5, 1.5], AutoAssign's ``center_mean`` in [-0.5, 0.5] and
``center_sigma`` in [0.5, 2] strides.

Tolerances:

- ``level_points`` equal; ``iou_loss`` (``-log`` and ``linear``, weighted
  or not) and its gradient rtol 1e-5;
- pred maps within 1e-4 of each map's largest |value| (fp32, eval mode);
- ``loss`` on tpudet's own pred maps: each term rtol 1e-5, its gradient
  with respect to the maps (AutoAssign's prior parameters too) rtol 1e-5,
  atol 1e-5 of the largest |value|, with gts in one image and none in the
  other; without any gt;
- ``get_bboxes`` of tpudet's pred maps: the keeps equal (boxes atol 1e-3
  px, scores 1e-5), rescaled and clipped to per-image shapes or not; the
  raw decode of ``with_nms=False`` (boxes 1e-3, scores 1e-5); end to end,
  each package on its own forward, one-to-one (label, IoU >= 0.99, scores
  within 1e-4);
- one train step (SGD, EMA, BatchNorm in train mode) in float64 on both
  sides from tpudet's init, 2 images of 64 px: the losses and the
  gradient norm rtol 1e-4, the state within 5e-3 of the change the step
  made. The discrete choices on computed values (the least-area gt, the
  fovea region's winner) are taken on the same float64-computed maps
  rounded to fp32 in both packages (each head's loss runs in fp32, as
  tpudet's does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models import losses as jlosses
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.models.dense_heads.fcos_head import level_points as jlevel_points
from tpudet_torch.apis import init_detector
from tpudet_torch.models import losses as tlosses
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.dense_heads.autoassign_head import AutoAssign
from tpudet_torch.models.dense_heads.fcos_head import level_points
from tpudet_torch.models.detectors.single_stage import FCOS, FOVEA
from tpudet_torch.utils.flax_import import flax_shape, leaf_table

from .test_models.test_autoassign import aa_cfg
from .test_models.test_fcos import fcos_cfg
from .test_models.test_fovea import fovea_cfg
from .test_torch_atss_gfl import (assert_loss_and_map_gradients,
                                  assert_step_matches, float64_step, gts,
                                  images, rescale_kwargs, step_batch)
from .test_torch_backbone_neck import _max_rel, random_variables
from .test_torch_detector import _np
from .test_torch_retinanet import assert_one_to_one
from .test_torch_roi_head import assert_detections_equal
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

NUM_CLASSES = 5
TOL = 1e-4


def shipped(cfg, iou=0.5):
    """``cfg`` with the shipped configs' test caps (tpudet's test configs
    cap at 10-20 detections, where a near-tie at the cap flips between
    the two packages' own forwards)."""
    return dict(cfg, test_cfg=dict(nms_pre=1000, score_thr=0.05,
                                   nms=dict(iou_threshold=iou),
                                   max_per_img=100))


def with_classes(cfg, n=NUM_CLASSES):
    return dict(cfg, bbox_head=dict(cfg['bbox_head'], num_classes=n))


# name -> (the config, the detector class, loss keys, with_nms=False
# columns: C, C + 1, or None where get_bboxes has no raw path)
MODELS = {
    'fcos': (lambda: shipped(fcos_cfg(NUM_CLASSES)), FCOS,
             ('loss_cls', 'loss_bbox', 'loss_centerness'), 0),
    'fovea': (lambda: shipped(fovea_cfg(NUM_CLASSES)), FOVEA,
              ('loss_cls', 'loss_bbox'), 0),
    'autoassign': (lambda: shipped(aa_cfg(NUM_CLASSES), 0.6), AutoAssign,
                   ('loss_pos', 'loss_neg', 'loss_center'), None),
}


def redraw_head_leaves(variables, seed):
    """The heads' raw leaves at values a trained model could hold:
    ``scales*`` in [0.5, 1.5], ``center_mean`` in [-0.5, 0.5],
    ``center_sigma`` in [0.5, 2]."""
    rng = np.random.RandomState(seed + 1)
    head = variables['params']['bbox_head']
    for k, v in head.items():
        if k.startswith('scales'):
            head[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == 'center_mean':
            head[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
        elif k == 'center_sigma':
            head[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return variables


def leaf_shapes(cfg):
    """tpudet's variables tree of ``cfg``'s model as shape structs, from
    the port's model on the meta device (its leaf table is tpudet's tree,
    ``test_torch_configs.py``), without tracing tpudet's ``init``."""
    with torch.device('meta'):
        model = build_detector(cfg)
    sd = model.state_dict()
    tree = {}
    for path, (key, kind) in leaf_table(model).items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jax.ShapeDtypeStruct(flax_shape(sd[key].shape, kind),
                                              jnp.float32)
    return tree


def detector_pair(cfg, seed):
    """(tpudet's module, the variables, the port's ``Detector``, images,
    tpudet's pred maps (jitted ``apply``), the port's)."""
    jmodel = jax_build_detector(cfg)
    img = images(seed)
    variables = redraw_head_leaves(jax.tree.map(np.asarray, random_variables(
        leaf_shapes(cfg), seed)), seed)
    det = init_detector(cfg, variables=variables, device='cpu',
                        dtype=torch.float32)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    return jmodel, variables, det, img, ref, det.forward(img)


def assert_maps_close(got, ref, tol=TOL):
    """Nested tuples of maps, each within ``tol`` of its largest |value|."""
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_maps_close(g, r, tol)
        return
    r = np.asarray(ref)
    assert tuple(got.shape) == r.shape
    assert _max_rel(got.detach().numpy(), r) <= tol


def assert_get_bboxes_match(jmodel, model, ref, got, rescale, columns):
    """``get_bboxes`` of tpudet's maps in both packages: the keeps equal;
    end to end one-to-one; the raw decode of ``with_nms=False`` equal with
    ``columns`` extra score columns (None: no raw path)."""
    jkw, tkw = rescale_kwargs() if rescale else ({}, {})
    rj = jax.jit(lambda maps, kw: jmodel.get_bboxes(maps, **kw))(ref, jkw)
    tref = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), ref)
    rt = model.get_bboxes(tref, **tkw)
    assert int(rt.valid.sum(1).min()) >= 10
    assert_detections_equal(rt, rj)
    assert_one_to_one(_np(rj), _np(model.get_bboxes(got, **tkw)))
    if columns is None:
        return
    raw_j = jmodel.bbox_head.get_bboxes(ref, with_nms=False, **jkw)
    raw_t = model.bbox_head.get_bboxes(tref, with_nms=False, **tkw)
    for g, r in zip(raw_t, raw_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-3)
    assert raw_t[1].shape[-1] == model.bbox_head.num_classes + columns


@pytest.fixture(scope='module', params=list(MODELS))
def pair(request):
    return (request.param,) + detector_pair(MODELS[request.param][0](), 30)


def test_pred_maps_match_tpudet(pair):
    kind, _, _, det, _, ref, got = pair
    assert type(det.model) is MODELS[kind][1]
    assert [tuple(c.shape[1:3]) for c in got[0]] == [(16, 16), (8, 8),
                                                     (4, 4), (2, 2), (1, 1)]
    assert all(r.dtype == torch.float32 for r in got[1])
    if kind != 'fovea':  # exp / relu distances
        assert all(float(r.min()) >= 0 for r in got[1])
    assert_maps_close(got, ref)


def test_loss_and_gradients_match_tpudet(pair):
    kind, jmodel, _, det, _, ref, _ = pair
    keys = MODELS[kind][2]
    tl = assert_loss_and_map_gradients(jmodel, det.model, ref, *gts(31),
                                       keys)
    assert all(float(tl[k]) > 0 for k in keys)


def test_loss_without_gts_matches_tpudet(pair):
    kind, jmodel, _, det, _, ref, _ = pair
    boxes, labels, valid = gts(32)
    valid[:] = False
    assert_loss_and_map_gradients(jmodel, det.model, ref, boxes, labels,
                                  valid, MODELS[kind][2][:1])


@pytest.mark.parametrize('rescale', [False, True])
def test_get_bboxes_matches_tpudet(pair, rescale):
    kind, jmodel, _, det, _, ref, got = pair
    assert_get_bboxes_match(jmodel, det.model, ref, got, rescale,
                            MODELS[kind][3])


@pytest.mark.parametrize('kind', list(MODELS))
def test_a_train_step_matches_tpudet_in_float64(kind):
    state0, jstate, jm, tstate, tm, _ = float64_step(MODELS[kind][0](),
                                                     step_batch(33))
    assert_step_matches(state0, jstate, jm, tstate, tm, MODELS[kind][2])
    head = 'bbox_head'
    # the level scales (and AutoAssign's prior) learn
    for leaf in ('scales', 'center_mean', 'center_sigma'):
        if leaf in state0.params[head]:
            assert not np.array_equal(tstate.params[head][leaf],
                                      state0.params[head][leaf])


# the pieces

def test_level_points_equal_tpudets():
    for size, stride in (((2, 3), 8), ((5, 4), 16), ((1, 1), 128)):
        np.testing.assert_array_equal(level_points(size, stride),
                                      jlevel_points(size, stride))


@pytest.mark.parametrize('linear', [False, True])
@pytest.mark.parametrize('weighted', [False, True])
def test_iou_loss_and_gradient_match_tpudet(linear, weighted):
    """Random box pairs, a few disjoint (IoU clipped at eps) and a few
    equal (IoU 1)."""
    rng = np.random.RandomState(7 + linear + 2 * weighted)
    xy = rng.uniform(0, 50, (2, 40, 2))
    pred = np.concatenate([xy, xy + rng.uniform(1, 30, (2, 40, 2))], -1)
    xy = xy + rng.uniform(-10, 10, (2, 40, 2))
    target = np.concatenate([xy, xy + rng.uniform(1, 30, (2, 40, 2))], -1)
    target[:, :3] = pred[:, :3] + 100  # disjoint
    target[:, 3:5] = pred[:, 3:5]  # equal
    pred, target = pred.astype(np.float32), target.astype(np.float32)
    kw = dict(linear=linear)
    if weighted:
        weight = rng.uniform(0, 1, (2, 40)).astype(np.float32)
        jkw = dict(kw, weight=jnp.asarray(weight), avg_factor=13.0)
        tkw = dict(kw, weight=torch.from_numpy(weight), avg_factor=13.0)
    else:
        jkw = tkw = kw
    ref, ref_grad = jax.value_and_grad(lambda p: jlosses.iou_loss(
        p, jnp.asarray(target), **jkw))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = tlosses.iou_loss(tp, torch.from_numpy(target), **tkw)
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    r = np.asarray(ref_grad)
    np.testing.assert_allclose(tp.grad.numpy(), r, rtol=1e-5,
                               atol=1e-5 * np.abs(r).max())

